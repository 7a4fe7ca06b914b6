"""The frozen yardstick beside the program's own counts (``perf/hw.py``'s
``kernel_bound``, ``kernels/trace.py``'s operation and byte counts) at the
served shapes, with each intended difference named:

1. one peak: every type's operations go over 989 TFLOP/s, where
   ``kernel_bound`` takes 67 TFLOP/s for float32 on the CUDA cores and, for
   a split-TF32 route, three tf32 products of each at 495 TFLOP/s;
2. work counted once: a decode call reads the valid slots' keys and values
   (and their positions), not the cache's every slot.
Where neither applies, the counts are the program's, to the operation and
the byte.
"""
import math

import pytest

from counts import kernels as kc
from counts import model as mc
from reference.arch import Arch
from repro_torch.configs import get_config
from repro_torch.kernels.trace import attention_pairs, moe_counts
from repro_torch.perf.hw import H100, kernel_bound

SHAPES = [  # (B, S, H, K, hd): internlm2's and mixtral's served prefills, a short one
    (1, 512, 16, 8, 128), (4, 512, 32, 8, 128), (2, 333, 16, 8, 64)]


@pytest.mark.parametrize("B,S,H,K,hd", SHAPES)
def test_flash_counts_are_the_programs(B, S, H, K, hd):
    flops, nbytes = kc.flash_fwd(B, S, H, K, hd, 4)
    assert flops == 4.0 * B * H * attention_pairs(S, S, True, 0) * hd
    qo, kv = 4 * B * S * H * hd, 4 * B * S * K * hd
    assert nbytes == 2 * qo + 2 * kv
    # 1. one peak: the bf16 bound's operations term is the yardstick's
    t_bf16, _ = kernel_bound(flops, 0.0, f32=False, hw=H100)
    assert kc.least_s(flops, 0.0) == pytest.approx(t_bf16, rel=1e-12)
    # ... where the split-TF32 route is bound by three tf32 products of each
    t_split, by = kernel_bound(flops, 0.0, f32=True, split_tf32=True, hw=H100)
    assert t_split / kc.least_s(flops, 0.0) == pytest.approx(3 * 989 / 495, rel=1e-9)
    # ... and the CUDA cores' float32 by 67 TFLOP/s
    t_f32, _ = kernel_bound(flops, 0.0, f32=True, hw=H100)
    assert t_f32 / kc.least_s(flops, 0.0) == pytest.approx(989 / 67, rel=1e-9)
    # the bytes term is the same in both
    assert kernel_bound(0.0, nbytes, f32=True, hw=H100)[0] == kc.least_s(0.0, nbytes)


def test_window_keeps_fewer_pairs():
    assert kc.causal_pairs(512, 512, 128) == attention_pairs(512, 512, True, 128)
    assert kc.causal_pairs(512, 512) == 512 * 513 // 2


@pytest.mark.parametrize("valid", [513, 576, 640])
def test_decode_reads_the_valid_slots(valid):
    B, H, K, hd, slots = 4, 32, 8, 128, 776
    flops, nbytes = kc.decode_attention(B, H, K, hd, valid, 4)
    assert flops == 4.0 * B * H * hd * valid
    # 2. work counted once: the cache's slots past the valid ones are not read
    whole = 4.0 * B * (2 * slots * K * hd + 2 * H * hd) + 4.0 * B * (slots + 1)
    assert nbytes < whole
    assert nbytes == 4.0 * B * (2 * valid * K * hd + 2 * H * hd) + 4.0 * B * (valid + 1)
    # bound by bytes either way, at the one bandwidth
    t, by = kernel_bound(flops, nbytes, f32=False, hw=H100)
    assert by == "bytes" and kc.least_s(flops, nbytes) == pytest.approx(t, rel=1e-12)


@pytest.mark.parametrize("chosen", [[[0, 1], [0, 1], [0, 1], [0, 1]],
                                    [[0, 1], [2, 3], [4, 5], [6, 7]],
                                    [[3, 5], [5, 2], [7, 3], [2, 1]]])
def test_moe_counts_are_the_programs(chosen):
    D, F = 4096, 14336
    distinct = len({e for row in chosen for e in row})
    ours = kc.moe_decode(len(chosen), 2, D, F, distinct, 4, 4)
    assert ours == pytest.approx(moe_counts(chosen, 0, 8, D, F, 4, 4), rel=1e-12)


@pytest.mark.parametrize("arch,config", [("internlm2-1.8b", "internlm2-1.8b"),
                                         ("mixtral-8x7b", "mixtral-8x7b-d8")])
def test_model_flops_per_token(arch, config):
    from conftest import find_cell
    cell = next(c for c in ("internlm2-1.8b.adhoc", "mixtral-8x7b-d8.offpeak")
                if c.startswith(config))
    a = Arch.from_file(find_cell(cell).config)
    cfg = get_config(arch).replace(num_layers=a.layers)
    # the program's active-parameter count: embedding and head each once,
    # norms and the router besides; a token's products skip the lookup
    weights = cfg.active_params() - cfg.vocab_size * cfg.d_model - a.layers * 2 * cfg.d_model \
        - cfg.d_model
    macs = a.layers * mc.layer_weight_macs(a) + a.d_model * a.vocab
    assert macs == weights
    assert mc.decode_flops(a, 1, 0) == pytest.approx(2 * macs + 4 * a.layers * a.heads
                                                     * a.head_dim)
    assert math.isclose(mc.prefill_flops(a, 2, 8) / 2,
                        sum(mc.token_flops(a, p, p == 7) for p in range(8)))
