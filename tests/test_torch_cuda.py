"""The CUDA kernels of repro_torch against their plain versions on the
card. Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and
skips elsewhere. This file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: attention atol/rtol 1e-4 in float32, 2e-2 in bfloat16 (the
plain versions round the normalised probabilities to bfloat16 before the
product with V; the kernels round the unnormalised ones on the tensor
cores at hd 64 and 128, and keep them in float32 elsewhere). The forward's
log-sum-exp 1e-4 in float32 and 1e-3 in bfloat16 (tensor-core sums). The SSD scan 2e-4 in float32 and
5e-2 in bfloat16, the reference's own tolerances for its Pallas kernel.
The backward kernel and the autograd Functions' gradients: within the same
tolerance times the gradient's scale (max |grad|) of the FA2 plain version
and of plain autograd through the oracles; two backward runs bit for bit; one
reduced qwen2-0.5b train step through the kernels within 1e-5 of the plain
versions in float32. The float32 flash routes (split-TF32 tensor cores:
the forward at every head dim, the backward at hd 8 to 128) at the same
1e-4, its log-sum-exp too, bit for bit on a second run, and against their
step-by-step split plain versions at the same tolerances. The bf16
LM head against the plain float32 head at the qwen2-0.5b chunk shape: the
logits within 1e-5 of their scale (the same exact products, float32 sums
in another order), dx and dW element by element within 2^-7 |want| (one bf16
rounding step) plus 2^-15 of the absolute products behind the element (the
cotangent's split into two bf16 halves holds it to 2^-16), at least 95 % of
dx's and of dW's elements equal to the plain head's bf16 values (which g's
hi half alone does not reach; at this width the float32 sums' order alone
moves ~2 % of dx across a rounding boundary), and no float32 GEMM among
its kernels. The MoE layer (plain PyTorch) in float32 against the same
function in float64 on the card: y within 1e-4 of max |y64| and aux within
1e-5, two runs bit for bit. Flash at Sq != Sk, the cross-attention decode
and the SSD scan at jamba's width at the attention and SSD tolerances
above, bit for bit on a second run; the slice's archs at reduced size
(int8 KV, jamba, seamless, internvl2) through the kernels within 1e-4 of
the plain versions in float32. The flash backward at Sq != Sk (causal and
not, keys past the last query with dK = dV = 0 exactly) at the gradients'
tolerance, bit for bit on a second run; the reduced loss and grads of the
archs with encoder or patch inputs (and jamba, mixtral) through the kernels
within 1e-5 of the plain versions, and under every remat policy the same
bits as without. The decode kernel launched from two threads at once, at
two group sizes over 48 KiB of shared memory, thousands of times each:
every launch succeeds with the single-thread bits. The decode kernel's
log-sum-exp and float32 output (a merge's partial result) at the decode
tolerances above and the log-sum-exp at the forward's, -inf on an empty
cache; partial results over uneven slot ranges merged by their
log-sum-exp within 1e-5 of the whole call, and the mean of V where no
range has a valid slot; a row with no valid slot in a cache of many
multi-tile splits gets that mean from the splits' sums of V. The bf16
forward at hd 8, 16, 32 (flash_mma_kernel) against its step-by-step plain
version (ref.flash_attention_mma_ref): the output within 2^-7 (MMA_TOL: both
round P and the output to bf16 from float32 sums in other orders, so a value
on a rounding boundary may round the other way, one bf16 unit in the last
place), the log-sum-exp within 1e-4. A captured decode step
(launch/graphs.py) at reduced size: 8 replays bit for bit 8 eager
LM.decode_step calls (logits and every cache leaf), the decode kernel's
launches counted at each replay and not at the capture, the MoE archs'
among them (the gathered decode's kernel launches too); one thread captures
while another decodes eagerly on the default stream, and both give the
bits of an eager run made alone. A captured reduced train step
(launch/graphs.py::train_step: qwen2, mamba2, mixtral; qwen2 at 1,536
tokens, the CE's checkpointed chunks, under every remat policy): 4 replays
after one eager step bit for bit 5 eager donated steps (metrics and the
final state), the kernels' launches (the backward's from autograd's
thread) counted at each replay, as many as an eager step's, and none at
the capture. The gathered MoE decode kernel against its
step-by-step plain version and the plain loop within 1e-5 of the output's
scale in float32 and 2^-6 in bf16 (sums in other orders; in bf16 a sum on
a rounding boundary moves an output by a bf16 unit or two), twice bit for
bit.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels import flash_attention_bwd as flash_bwd_module
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_lse
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.moe_decode import moe_decode
from repro_torch.kernels.ref import (decode_attention_ref, flash_attention_bwd_ref,
                                     flash_attention_bwd_split_ref, flash_attention_lse_ref,
                                     flash_attention_mma_ref, flash_attention_ref,
                                     flash_attention_split_ref, moe_gathered_ref, ssd_scan_ref,
                                     ssd_sequential_ref)
from repro_torch.kernels.ops import flash_attention_diff, ssd_scan_diff
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.transformer import head_logits, plain_head_logits

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
MMA_TOL, MMA_LSE_TOL = 2.0 ** -7, 1e-4
SSD_DTYPES = [(torch.float32, 2e-4), (torch.bfloat16, 5e-2)]
# of dx's and dW's elements equal to the plain head's: dx sums 151,936
# products a row in float32, in another order in each route's GEMM, so ~2 %
# of its elements straddle a bf16 rounding boundary (0.980 exact on an H100;
# g's hi half alone, 0.575)
HEAD_EXACT_SHARE = 0.95

# B, S, H, K, hd, causal, window, softcap
FLASH = [
    (1, 333, 16, 8, 64, True, 0, 0.0),  # paper-default prefill
    (1, 37, 4, 2, 16, True, 0, 0.0),
    (2, 100, 7, 1, 8, True, 0, 30.0),  # GQA 7:1 at hd 8, softcap
    (1, 333, 4, 2, 16, True, 8, 0.0),  # window, ragged
    (1, 129, 4, 1, 128, False, 0, 0.0),  # MQA, non-causal
    (1, 333, 8, 4, 256, True, 4096, 50.0),  # gemma2-2b: hd 256, softcap, global window
    (1, 333, 8, 4, 256, True, 128, 50.0),  # gemma2-2b: a window that bites
    (1, 333, 16, 8, 128, True, 0, 0.0),  # internlm2-1.8b
    (1, 2048, 16, 8, 64, True, 0, 0.0),  # a 2048-token prompt
    (2, 100, 7, 1, 64, True, 0, 0.0),  # GQA 7:1 at hd 64
    (1, 256, 4, 1, 128, True, 0, 0.0),  # MQA
    (1, 384, 4, 2, 128, True, 128, 0.0),  # window
    (2, 128, 8, 8, 64, True, 0, 50.0),  # MHA, softcap
    (1, 256, 14, 2, 64, False, 0, 0.0),  # non-causal
    (1, 129, 4, 2, 32, False, 48, 0.0),  # non-causal, window, ragged
    (2, 37, 4, 2, 32, True, 256, 30.0),  # window >= S, softcap
    # the edges of the bf16 route at hd 64 and 128 (flash_wg_kernel: 128
    # folded rows a block, 128 keys a tile)
    (1, 100, 14, 2, 64, True, 0, 0.0),  # G Sq = 700: not a multiple of a block's rows
    (2, 17, 7, 1, 128, True, 0, 0.0),  # G Sq = 119: under one block's rows
    (1, 37, 8, 2, 64, True, 0, 0.0),  # Sk under one key tile
    (1, 4097, 8, 1, 64, True, 0, 0.0),  # a ragged last key tile
    (1, 500, 4, 2, 64, True, 100, 0.0),  # a window that cuts inside a key tile
    (2, 200, 8, 4, 128, True, 0, 30.0),  # softcap at hd 128
    (1, 8192, 14, 2, 64, True, 0, 0.0),  # 8192 tokens, causal GQA 7:1
    # the bf16 route at hd 8-32 (flash_mma_kernel: 64 folded rows a block, 64
    # keys a tile) at hd 16 and 32 too: GQA 7:1 with softcap, the reduced
    # configs' shape
    (2, 100, 7, 1, 16, True, 0, 30.0),
    (2, 100, 7, 1, 32, True, 0, 30.0),
    (4, 32, 7, 1, 16, True, 0, 0.0),
    (4, 32, 7, 1, 32, True, 0, 0.0),
]


def _mma_close(dtype, hd, q, k, v, kw, out, lse=None):
    """bf16 at hd 8, 16, 32: the output (and log-sum-exp) against the mma.sync
    kernel's step-by-step plain version."""
    if dtype != torch.bfloat16 or hd > 32:
        return
    want, want_lse = flash_attention_mma_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=MMA_TOL, rtol=MMA_TOL)
    if lse is not None:
        torch.testing.assert_close(lse, want_lse, atol=MMA_LSE_TOL, rtol=MMA_LSE_TOL)
# flash backward: the cases of test_flash_attention_diff_grads_match_plain_autograd
FLASH_BWD = [
    (1, 333, 14, 2, 64, True, 0, 0.0),  # qwen2-0.5b: GQA 7:1 at hd 64
    (2, 37, 7, 1, 8, True, 0, 0.0),  # qwen2-0.5b reduced: hd 8
    (1, 256, 4, 2, 32, True, 64, 30.0),  # window + softcap
    (1, 200, 8, 2, 128, True, 0, 0.0),  # hd 128
    (1, 333, 8, 4, 256, True, 128, 50.0),  # gemma2-2b: hd 256, window, softcap
    (2, 129, 4, 1, 64, False, 48, 0.0),  # non-causal, window, ragged
    # key tiles whose row walk the tensor-core dK/dV pass cuts into many
    # segments (kernels/flash_attention_bwd.py::dkdv_schedule)
    (2, 1024, 14, 2, 64, True, 0, 0.0),  # long causal GQA 7:1: 14 segments on the first tile
    (1, 777, 8, 1, 128, True, 200, 0.0),  # ragged, windowed MQA at hd 128
    (2, 512, 8, 2, 64, False, 0, 0.0),  # non-causal: every tile cut
]
# B, H, K, hd, Smax, window, softcap, fill (the new token's position; -1 = empty cache)
DECODE = [
    (4, 16, 8, 64, 640, 0, 0.0, 332),  # paper-default decode
    (2, 7, 1, 8, 200, 0, 0.0, 150),
    (2, 8, 4, 32, 333, 0, 50.0, 250),
    (1, 8, 1, 128, 512, 0, 0.0, 511),  # nearly full
    (2, 4, 2, 16, 37, 0, 0.0, -1),  # empty: the mean of V
    (1, 8, 1, 32, 100, 16, 0.0, 99),  # window
    (4, 16, 8, 64, 4224, 0, 0.0, 4000),  # a long cache: 66 splits
    (2, 8, 4, 64, 640, 0, 0.0, 40),  # every valid slot in the first split
]

# B, S, H, P, N, chunk
SSD = [
    (1, 384, 80, 64, 128, 128),  # mamba2-2.7b prefill of 333 tokens, padded
    (1, 74, 4, 64, 128, 37),  # a 37-token prompt: one chunk that is not a power of two
    (2, 16, 8, 16, 16, 8),  # mamba2-2.7b reduced
    (1, 128, 8, 16, 16, 32),  # jamba-like small state
]
# B, S, H, P, N, chunk, single group (B_/C_ read over the heads at head stride 0)
SSD_MORE = [
    (1, 2048, 80, 64, 128, 128, True),  # mamba2-2.7b at 2048 tokens: 16 chunks
    (1, 185, 4, 64, 128, 37, False),  # five chunks of 37
    (2, 256, 3, 100, 20, 64, True),  # P and N that are not multiples of 16
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", FLASH)
def test_flash_kernel_matches_plain(dev, case, dtype, tol):
    B, S, H, K, hd, causal, win, cap = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=win, softcap=cap)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=win, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    _mma_close(dtype, hd, q, k, v, dict(causal=causal, window=win, softcap=cap), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", DECODE)
def test_decode_kernel_matches_plain(dev, case, dtype, tol):
    B, H, K, hd, Smax, win, cap, fill = case
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    ar = torch.arange(Smax, dtype=torch.int32, device=dev)[None].expand(B, Smax)
    lengths = torch.full((B,), fill, dtype=torch.int32, device=dev)
    pos = torch.where(ar <= lengths[:, None], ar, torch.full_like(ar, -1)).contiguous()
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos, lengths, window=win, softcap=cap)
    assert decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, pos, lengths, window=win, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [DECODE[0], DECODE[4], DECODE[6], DECODE[7]])
def test_decode_kernel_is_deterministic(dev, case, dtype):
    """The splits merge in a fixed order: two runs give the same bits."""
    B, H, K, hd, Smax, win, cap, fill = case
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    ar = torch.arange(Smax, dtype=torch.int32, device=dev)[None].expand(B, Smax)
    lengths = torch.full((B,), fill, dtype=torch.int32, device=dev)
    pos = torch.where(ar <= lengths[:, None], ar, torch.full_like(ar, -1)).contiguous()
    first = decode_attention(q, k, v, pos, lengths, window=win, softcap=cap)
    assert torch.equal(first, decode_attention(q, k, v, pos, lengths, window=win, softcap=cap))


def _decode_inputs(dev, case, dtype, seed):
    B, H, K, hd, Smax, win, cap, fill = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    ar = torch.arange(Smax, dtype=torch.int32, device=dev)[None].expand(B, Smax)
    lengths = torch.full((B,), fill, dtype=torch.int32, device=dev)
    pos = torch.where(ar <= lengths[:, None], ar, torch.full_like(ar, -1)).contiguous()
    return q, k, v, pos, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", DECODE)
def test_decode_kernel_lse_matches_plain(dev, case, dtype, tol):
    """With ``return_lse``: the float32 output and each head's log-sum-exp
    against the plain version (-inf on the empty cache, whose output is
    the mean of V); the call without it returns the float32 output rounded
    to q's type, bit for bit where a slot is valid (the empty cache's mean
    is summed split by split under lse, slot by slot without it)."""
    win, cap = case[5], case[6]
    q, k, v, pos, lengths = _decode_inputs(dev, case, dtype, 12)
    before = decode_attention.launches
    o, lse = decode_attention(q, k, v, pos, lengths, window=win, softcap=cap, return_lse=True)
    assert decode_attention.launches == before + 1
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    want_o, want_lse = decode_attention_ref(q, k, v, pos, lengths, window=win, softcap=cap,
                                            return_lse=True)
    torch.testing.assert_close(o, want_o, atol=tol, rtol=tol)
    if case[7] < 0:
        assert torch.isneginf(lse).all()
    else:
        torch.testing.assert_close(lse, want_lse, atol=LSE_TOL[dtype], rtol=LSE_TOL[dtype])
    plain = decode_attention(q, k, v, pos, lengths, window=win, softcap=cap)
    assert plain.dtype == dtype
    if case[7] < 0:
        torch.testing.assert_close(plain.float(), o, atol=1e-6,
                                   rtol=1e-6 if dtype == torch.float32 else 2.0 ** -7)
    else:
        assert torch.equal(plain, o.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [DECODE[0], DECODE[2], DECODE[6]])
def test_decode_kernel_lse_merges_across_slot_ranges(dev, case, dtype):
    """The cache cut into uneven slot ranges (one of them past every valid
    slot: lse -inf, weight 0), each range's kernel call with its
    log-sum-exp, merged by ``spmd.lse_merge``: the whole call's float32
    output within 1e-5; a cache empty in every range gives the mean of V
    over every slot."""
    from repro_torch.parallel.spmd import lse_merge

    win, cap, fill = case[5], case[6], case[7]
    q, k, v, pos, lengths = _decode_inputs(dev, case, dtype, 13)
    Smax = k.shape[1]

    def merged(pos):
        cuts = [0, 5, Smax // 3, Smax // 3 + 1, fill + 1, Smax]
        parts = [decode_attention(q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                                  pos[:, a:b].contiguous(), lengths, window=win, softcap=cap,
                                  return_lse=True) for a, b in zip(cuts[:-1], cuts[1:])]
        assert torch.isneginf(parts[-1][1]).all()
        slots = torch.tensor([b - a for a, b in zip(cuts[:-1], cuts[1:])],
                             dtype=torch.float32, device=dev)[:, None, None]
        return lse_merge(torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts]),
                         slots, lambda t, op: t.amax(0, keepdim=True) if op == "max"
                         else t.sum(0, keepdim=True))[0]

    whole, _ = decode_attention(q, k, v, pos, lengths, window=win, softcap=cap, return_lse=True)
    torch.testing.assert_close(merged(pos), whole, atol=1e-5, rtol=1e-5)
    empty = torch.full_like(pos, -1)
    G = q.shape[1] // k.shape[2]
    mean = v.float().mean(1).repeat_interleave(G, dim=1)
    torch.testing.assert_close(merged(empty), mean, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 128, 256])
def test_decode_kernel_lse_empty_row_over_many_splits(dev, hd, dtype):
    """A row with no valid slot in a cache of many splits of several tiles
    each (a rank whose slots are all empty): with ``return_lse``, lse -inf
    and the mean of V over every slot, from each split's sum of V; the
    other row, valid to its last slot, as without lse."""
    Smax = 70_001
    q, k, v, pos, lengths = _decode_inputs(dev, (2, 8, 2, hd, Smax, 0, 0.0, Smax - 1), dtype, 14)
    pos[1] = -1
    o, lse = decode_attention(q, k, v, pos, lengths, return_lse=True)
    assert torch.isneginf(lse[1]).all() and torch.isfinite(lse[0]).all()
    mean = v[1].float().mean(0).repeat_interleave(q.shape[1] // k.shape[2], dim=0)
    torch.testing.assert_close(o[1], mean, atol=1e-5, rtol=1e-5)
    assert torch.equal(decode_attention(q, k, v, pos, lengths)[0], o[0].to(dtype))


@pytest.mark.cuda
def test_decode_kernel_on_a_ring_cache_mid_wrap(dev):
    B, H, K, hd, Smax, first = 2, 4, 2, 64, 100, 250
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    abs_pos = torch.arange(first, first + Smax, dtype=torch.int32, device=dev)
    pos = torch.empty((B, Smax), dtype=torch.int32, device=dev)
    pos[:, abs_pos.long() % Smax] = abs_pos
    lengths = torch.full((B,), first + Smax - 1, dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, pos, lengths, window=64)
    want = decode_attention_ref(q, k, v, pos, lengths, window=64)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("window", [4096, 128])
def test_decode_kernel_at_gemma2_width_on_a_ring_cache(dev, window, dtype, tol):
    """gemma2-2b's attention: 8 query heads over 4, hd 256, softcap 50, a
    640-slot ring cache holding positions 300..939 mid-wrap."""
    B, H, K, hd, Smax, first = 2, 8, 4, 256, 640, 300
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    abs_pos = torch.arange(first, first + Smax, dtype=torch.int32, device=dev)
    pos = torch.empty((B, Smax), dtype=torch.int32, device=dev)
    pos[:, abs_pos.long() % Smax] = abs_pos
    lengths = torch.full((B,), first + Smax - 1, dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, pos, lengths, window=window, softcap=50.0)
    want = decode_attention_ref(q, k, v, pos, lengths, window=window, softcap=50.0)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_decode_kernel_from_threads_at_two_group_sizes(dev):
    """The live engine decodes on several worker threads at once: two
    threads at granite-8b's and internlm2-1.8b's served shapes (4 and 2
    query heads a kv head at hd 128, whose blocks ask for different shared
    memory, both over the 48 KiB a block gets without opting in). Every one
    of many launches from each succeeds and gives the single-thread bits."""
    import threading

    gen = torch.Generator(device=dev).manual_seed(12)
    cases = []
    for H, K in ((32, 8), (16, 8)):
        B, hd, Smax, fill = 1, 128, 288, 260
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
        ar = torch.arange(Smax, dtype=torch.int32, device=dev)[None].expand(B, Smax)
        lengths = torch.full((B,), fill, dtype=torch.int32, device=dev)
        pos = torch.where(ar <= lengths[:, None], ar, torch.full_like(ar, -1)).contiguous()
        args = (q, k, v, pos, lengths)
        cases.append((args, decode_attention(*args)))
    errors, start = [], threading.Barrier(len(cases))

    def run(args, want):
        start.wait()
        try:
            outs = [decode_attention(*args) for _ in range(3000)]
        except RuntimeError as e:
            errors.append(str(e))
            return
        if not torch.equal(torch.stack(outs), want.expand(len(outs), *want.shape)):
            errors.append("bits differ from the single-thread run")

    threads = [threading.Thread(target=run, args=c) for c in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", FLASH)
def test_flash_lse_matches_plain(dev, case, dtype, tol):
    B, S, H, K, hd, causal, win, cap = case
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    before = flash_attention.launches
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=win, softcap=cap)
    assert flash_attention.launches == before + 1
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=win, softcap=cap))
    want_out, want_lse = flash_attention_lse_ref(q, k, v, causal=causal, window=win, softcap=cap)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL[dtype], rtol=LSE_TOL[dtype])
    _mma_close(dtype, hd, q, k, v, dict(causal=causal, window=win, softcap=cap), out, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [FLASH[0], FLASH[2], FLASH[7], FLASH[-4], FLASH[-3]])
def test_flash_kernel_is_deterministic_in_float32_and_bfloat16(dev, case, dtype):
    """float32 (split-TF32 tensor cores): two key halves merge
    in a fixed order; bfloat16 at hd 64 and 128 (flash_wg_kernel) and at hd
    8, 16, 32 (flash_mma_kernel): every sum in a fixed order, no atomics. Two
    runs give the same bits."""
    B, S, H, K, hd, causal, win, cap = case
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    first = flash_attention_lse(q, k, v, causal=causal, window=win, softcap=cap)
    for _ in range(2):
        again = flash_attention_lse(q, k, v, causal=causal, window=win, softcap=cap)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _head_inputs(dev, B=4, S=512, D=896, V=151_936, seed=14):
    """qwen2-0.5b's CE chunk: bf16 activations, the float32 tied embedding (V, D)
    and a float32 cotangent of the logits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, D), generator=gen, device=dev).to(torch.bfloat16)
    embed = torch.randn((V, D), generator=gen, device=dev) * 0.02
    g = torch.randn((B, S, V), generator=gen, device=dev) * 1e-5
    return x, embed, g


def _head_grads(head, x, embed, g):
    xx, ee = x.detach().requires_grad_(), embed.detach().requires_grad_()
    logits = head(xx, ee.T)
    logits.backward(g)
    return logits.detach(), xx.grad, ee.grad


@pytest.mark.cuda
def test_bf16_head_matches_plain_head(dev):
    x, embed, g = _head_inputs(dev)
    got = _head_grads(lambda a, w: head_logits(a, w.to(a.dtype)), x, embed, g)
    want = _head_grads(plain_head_logits, x, embed, g)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    scale = float(want[0].abs().max())
    torch.testing.assert_close(got[0], want[0], atol=1e-5 * scale, rtol=1e-5)
    ax, ag = x.float().abs().reshape(-1, x.shape[-1]), g.abs().reshape(-1, g.shape[-1])
    aw = embed.to(torch.bfloat16).float().abs()
    behind = {"dx": (ag @ aw).reshape(x.shape), "dW": ag.T @ ax}
    # g's hi half alone, which the bound above does not tell from the split
    gf = g.reshape(-1, g.shape[-1])
    hi = gf.to(torch.bfloat16)
    w16 = embed.to(torch.bfloat16)
    hi_only = {"dx": torch.mm(hi, w16, out_dtype=torch.float32).to(torch.bfloat16).reshape(x.shape),
               "dW": torch.mm(hi.T, x.reshape(-1, x.shape[-1]),
                              out_dtype=torch.float32).to(torch.bfloat16).float()}
    for name, a, b in (("dx", got[1], want[1]), ("dW", got[2], want[2])):
        excess = (a.float() - b.float()).abs() - (2.0 ** -7 * b.float().abs()
                                                  + 2.0 ** -15 * behind[name])
        assert float(excess.max()) <= 0, f"{name}: beyond its tolerance by {float(excess.max())}"
        exact = float((a == b).float().mean())
        exact_hi = float((hi_only[name] == b).float().mean())
        assert exact >= HEAD_EXACT_SHARE > exact_hi, f"{name}: exact {exact:.4f}, hi alone {exact_hi:.4f}"


@pytest.mark.cuda
def test_bf16_head_runs_no_float32_gemm(dev):
    """The kernels of the bf16 route share none with the float32 route's GEMMs."""
    x, embed, g = _head_inputs(dev, S=128)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = {}
    for route, head in (("bf16", lambda a, w: head_logits(a, w.to(a.dtype))),
                        ("f32", plain_head_logits)):
        _head_grads(head, x, embed, g)  # warm up outside the profile
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            _head_grads(head, x, embed, g)
            torch.cuda.synchronize()
        names[route] = {e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and e.self_device_time_total > 0}
    f32_gemms = {n for n in names["f32"] if any(w in n.lower() for w in ("gemm", "nvjet", "xmma"))}
    assert f32_gemms, names["f32"]
    assert not names["bf16"] & f32_gemms, names["bf16"] & f32_gemms
    assert not [n for n in names["bf16"] if "f32f32" in n or "sgemm" in n.lower()], names["bf16"]


def _bwd_inputs(dev, case, dtype, seed):
    """q, k, v, the output's gradient, and the kernel forward's output and
    log-sum-exp."""
    B, S, H, K, hd, causal, win, cap = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
    o, lse = flash_attention_lse(q, k, v, causal=causal, window=win, softcap=cap)
    return q, k, v, g, o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", FLASH_BWD)
def test_flash_bwd_kernel_matches_plain(dev, case, dtype, tol):
    *_, causal, win, cap = case
    q, k, v, g, o, lse = _bwd_inputs(dev, case, dtype, 8)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, g, lse, causal=causal, window=win, softcap=cap)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, g, lse, causal=causal, window=win, softcap=cap)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _grads_close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [FLASH_BWD[0], FLASH_BWD[4], *FLASH_BWD[6:]])
def test_flash_bwd_kernel_is_deterministic(dev, case, dtype):
    *_, causal, win, cap = case
    q, k, v, g, o, lse = _bwd_inputs(dev, case, dtype, 9)
    first = flash_attention_bwd(q, k, v, o, g, lse, causal=causal, window=win, softcap=cap)
    for _ in range(2):
        again = flash_attention_bwd(q, k, v, o, g, lse, causal=causal, window=win, softcap=cap)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# float32 on the split-TF32 tensor cores: gemma2-2b's served forward and
# backward (hd 256, softcap 50, global and a window that bites; Sq != Sk
# both ways), and the backward with cut key tiles (GQA 7:1), a window, a
# softcap and Sq != Sk: B, Sq, Sk, H, K, hd, causal, window, softcap
F32_SPLIT = [(1, 333, 333, 8, 4, 256, True, 128, 50.0), (1, 512, 512, 14, 2, 64, True, 0, 0.0),
             (1, 200, 200, 8, 2, 128, True, 64, 0.0), (1, 100, 100, 4, 2, 16, True, 8, 50.0),
             (1, 100, 333, 4, 2, 64, True, 0, 0.0), (1, 333, 129, 4, 2, 32, True, 0, 0.0),
             (1, 333, 333, 8, 4, 256, True, 0, 50.0), (2, 129, 333, 8, 4, 256, False, 0, 50.0),
             (1, 333, 129, 8, 4, 256, True, 0, 0.0)]
# bf16 at hd 8, 16, 32 on the same kernels (no lo halves): the reduced
# qwen2-0.5b's q (4,32,7,8), a ragged cut walk, a window and softcap, Sq != Sk
BF16_SPLIT = [(4, 32, 32, 7, 1, 8, True, 0, 0.0), (1, 300, 300, 7, 1, 16, True, 0, 0.0),
              (1, 256, 256, 4, 2, 32, True, 64, 30.0), (2, 64, 200, 4, 4, 32, False, 0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_SPLIT + BF16_SPLIT)
def test_float32_kernels_match_their_split_plain_versions(dev, case):
    """The float32 forward and backward at every head dim, and the bf16
    backward at hd 8, 16, 32, against the plain versions that write their
    algorithms out step by step in split-TF32: float32 at 1e-4 (the
    gradients at 1e-4 of their scale), bf16's gradients at 2^-7 of their
    scale (both sides round float32 sums, in other orders, once to bf16:
    one unit in the last place), twice bit for bit."""
    B, Sq, Sk, H, K, hd, causal, win, cap = case
    dtype = torch.float32 if case in F32_SPLIT else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd)))
    kw = dict(causal=causal, window=win, softcap=cap)
    o, lse = flash_attention_lse(q, k, v, **kw)
    if dtype == torch.float32:
        want_o, want_lse = flash_attention_split_ref(q, k, v, **kw)
        torch.testing.assert_close(o, want_o, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    got = flash_attention_bwd(q, k, v, o, g, lse, **kw)
    again = flash_attention_bwd(q, k, v, o, g, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, flash_attention_bwd_split_ref(q, k, v, o, g, lse, **kw)):
        assert a.dtype == dtype
        _grads_close(a, b, 1e-4 if dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64), (torch.float32, 8),
                                      (torch.bfloat16, 128), (torch.bfloat16, 256),
                                      (torch.float32, 256)])
def test_flash_refuses_inputs_off_a_16_byte_boundary(dev, dtype, hd):
    """Every route copies 16 bytes at a time: a contiguous view one element
    into its buffer is refused with a ValueError that says so, bf16 at hd 16
    (mma.sync) too."""
    def shifted(d, dt):
        n = 8 * 4 * d
        return torch.randn(n + 1, device=dev).to(dt)[1:].view(1, 8, 4, d)

    q = shifted(hd, dtype)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(*(shifted(16, torch.bfloat16),) * 3)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 4, 24), device=dev)  # head_dim 24
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 16), device=dev)
    with pytest.raises(ValueError):  # not contiguous
        flash_attention(q, q[:, :, ::2], q[:, :, ::2])
    with pytest.raises(TypeError):
        flash_attention(q.half(), q[:, :, :2].half(), q[:, :, :2].half())
    q, kv = torch.zeros((1, 8, 4, 24), device=dev), torch.zeros((1, 8, 2, 24), device=dev)
    lse = torch.zeros((1, 4, 8), device=dev)
    with pytest.raises(ValueError):  # head_dim 24
        flash_attention_bwd(q, kv, kv, q, q, lse)
    q, kv = torch.zeros((1, 8, 4, 16), device=dev), torch.zeros((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError):  # lse of the wrong shape
        flash_attention_bwd(q, kv, kv, q, q, lse[:, :, :4].contiguous())
    with pytest.raises(TypeError):  # lse not float32
        flash_attention_bwd(q.bfloat16(), kv.bfloat16(), kv.bfloat16(), q.bfloat16(),
                            q.bfloat16(), lse.bfloat16())
    with pytest.raises(TypeError):  # mixed float types
        flash_attention_bwd(q, kv, kv, q, q.bfloat16(), lse)
    with pytest.raises(ValueError):  # the output's gradient not contiguous
        flash_attention_bwd(q, kv, kv, q, q.transpose(1, 2).contiguous().transpose(1, 2), lse)


@pytest.mark.cuda
def test_moe_decode_refuses_what_the_kernel_does_not_take(dev):
    x, eidx, gate, wi, wg, wo, _ = _moe_inputs(dev, MOE_DECODE[0])
    with pytest.raises(ValueError, match="activation"):
        moe_decode(x, eidx, gate, wi, wg, wo, act="gelu")
    with pytest.raises(ValueError, match="contiguous"):
        moe_decode(x, eidx, gate, wi.transpose(1, 2).contiguous().transpose(1, 2), wg, wo)
    with pytest.raises(ValueError, match="16-byte"):  # 4 bytes past an aligned start
        off = torch.empty(wi.numel() + 1, device=dev)[1:].view(wi.shape)
        moe_decode(x, eidx, gate, off, wg, wo)
    with pytest.raises(TypeError):  # bf16 weights under float32 x
        moe_decode(x, eidx, gate, wi.bfloat16(), wg.bfloat16(), wo.bfloat16())


def _ssd_inputs(dev, B, S, H, P, N, dtype, seed=3, single_group=False):
    """x, dt, A, B_, C_ drawn as tests/test_kernels.py draws them; with
    ``single_group`` B_ and C_ are one (B,S,N) group viewed over the heads
    (head stride 0), as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rnd(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    A = -torch.exp(rnd(H) * 0.3)
    if single_group:
        Bm, Cm = ((rnd(B, S, 1, N) * 0.5).to(dtype).expand(B, S, H, N) for _ in range(2))
    else:
        Bm, Cm = ((rnd(B, S, H, N) * 0.5).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
@pytest.mark.parametrize("case", SSD)
def test_ssd_kernel_matches_plain(dev, case, dtype, tol):
    B, S, H, P, N, chunk = case
    args = _ssd_inputs(dev, B, S, H, P, N, dtype)
    before = ssd_scan.launches
    y, h = ssd_scan(*args, chunk=chunk)
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32 and h.shape == (B, H, P, N)
    yr, hr = ssd_scan_ref(*args, chunk=chunk)
    ys, hs = ssd_sequential_ref(*args)
    for got, want in ((y, yr), (h, hr), (y, ys), (h, hs)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
def test_ssd_kernel_reads_a_single_group_over_the_heads(dev, dtype, tol):
    args = _ssd_inputs(dev, 1, 384, 80, 64, 128, dtype, single_group=True)
    assert args[3].stride(2) == 0
    y, h = ssd_scan(*args, chunk=128)
    yr, hr = ssd_scan_ref(*args, chunk=128)
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hr, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
@pytest.mark.parametrize("case", SSD_MORE)
def test_ssd_kernel_matches_plain_over_many_chunks(dev, case, dtype, tol):
    B, S, H, P, N, chunk, single = case
    args = _ssd_inputs(dev, B, S, H, P, N, dtype, single_group=single)
    y, h = ssd_scan(*args, chunk=chunk)
    yr, hr = ssd_scan_ref(*args, chunk=chunk)
    ys, hs = ssd_sequential_ref(*args)
    for got, want in ((y, yr), (h, hr), (y, ys), (h, hs)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [SSD_MORE[0], SSD_MORE[1]])
def test_ssd_kernel_is_deterministic(dev, case, dtype):
    """No atomics, sums in a fixed order: two runs give the same bits."""
    B, S, H, P, N, chunk, single = case
    args = _ssd_inputs(dev, B, S, H, P, N, dtype, seed=12, single_group=single)
    y, h = ssd_scan(*args, chunk=chunk)
    y2, h2 = ssd_scan(*args, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, dt, A, Bm, Cm = _ssd_inputs(dev, 1, 16, 2, 16, 16, torch.float32)
    with pytest.raises(NotImplementedError):  # an initial state
        ssd_scan(x, dt, A, Bm, Cm, chunk=8, h0=torch.zeros((1, 2, 16, 16), device=dev))
    with pytest.raises(TypeError):  # dt not float32
        ssd_scan(x, dt.bfloat16(), A, Bm, Cm, chunk=8)
    with pytest.raises(TypeError):  # mixed float types
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm, chunk=8)
    with pytest.raises(ValueError):  # x not contiguous
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):  # B_ strided along its last dim
        ssd_scan(x, dt, A, torch.cat([Bm, Bm], -1)[..., ::2], Cm, chunk=8)
    with pytest.raises(ValueError):  # S not a multiple of the chunk
        ssd_scan(x, dt, A, Bm, Cm, chunk=6)


# --- the autograd Functions and training ---------------------------------------

def _grads_close(got, want, tol):
    """max |got - want| within ``tol`` of the gradient's scale (max |want|)."""
    scale = float(want.float().abs().max().clamp(min=1e-6))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


def _grads(fn, inputs, cotangents):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, cotangents)
    return out, [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", FLASH_BWD)
def test_flash_attention_diff_grads_match_plain_autograd(dev, case, dtype, tol):
    B, S, H, K, hd, causal, win, cap = case
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
    before = flash_attention.launches, flash_attention_bwd.launches
    (out,), got = _grads(lambda *a: flash_attention_diff(*a, causal, win, cap), (q, k, v), (g,))
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    (want_out,), want = _grads(
        lambda *a: flash_attention_ref(*a, causal=causal, window=win, softcap=cap), (q, k, v), (g,))
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=tol)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _grads_close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_diff_runs_the_kernels_and_no_plain_version(dev, dtype, monkeypatch):
    """One forward and one backward launch, and no plain version on the way."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((flash_module, "flash_attention_ref"), (flash_module, "flash_attention_lse_ref"),
                      (flash_bwd_module, "flash_attention_bwd_ref")):
        monkeypatch.setattr(mod, name, boom)
    gen = torch.Generator(device=dev).manual_seed(10)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((2, 200, 14, 64), (2, 200, 2, 64), (2, 200, 2, 64), (2, 200, 14, 64)))
    before = flash_attention.launches, flash_attention_bwd.launches
    (out,), grads = _grads(lambda *a: flash_attention_diff(*a, True, 0, 0.0), (q, k, v), (g,))
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert all(t.dtype == dtype and bool(torch.isfinite(t).all()) for t in [out, *grads])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
@pytest.mark.parametrize("case", [(1, 384, 80, 64, 128, 128), (1, 74, 4, 64, 128, 37)])
def test_ssd_scan_diff_grads_match_plain_autograd(dev, case, dtype, tol):
    B, S, H, P, N, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(dev, B, S, H, P, N, dtype, single_group=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    gy = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    gh = torch.randn((B, H, P, N), generator=gen, device=dev)
    # the model's single group: differentiate through its broadcast over the heads
    groups = (Bm[:, :, :1].contiguous(), Cm[:, :, :1].contiguous())

    def run(fn):
        def f(x, dt, A, b, c):
            return fn(x, dt, A, b.expand(B, S, H, N), c.expand(B, S, H, N))
        return _grads(f, (x, dt, A) + groups, (gy, gh))

    before = ssd_scan.launches
    _, got = run(lambda *a: ssd_scan_diff(*a, chunk))
    assert ssd_scan.launches == before + 1
    _, want = run(lambda *a: ssd_scan_ref(*a, chunk=chunk))
    for a, b in zip(got, want):
        _grads_close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["flash", "flash_bwd", "decode", "ssd", "moe"])
def test_raw_wrappers_refuse_cuda_inputs_that_require_grad(dev, which):
    def t(*shape):
        return torch.zeros(shape, device=dev)

    if which == "flash":
        fn, args = flash_attention, (t(1, 8, 4, 16).requires_grad_(), t(1, 8, 2, 16), t(1, 8, 2, 16))
    elif which == "flash_bwd":
        fn, args = flash_attention_bwd, (t(1, 8, 4, 16), t(1, 8, 2, 16).requires_grad_(),
                                         t(1, 8, 2, 16), t(1, 8, 4, 16), t(1, 8, 4, 16), t(1, 4, 8))
    elif which == "decode":
        pos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
        fn, args = decode_attention, (t(1, 4, 16).requires_grad_(), t(1, 8, 2, 16),
                                      t(1, 8, 2, 16), pos, pos[:, 0].contiguous())
    elif which == "ssd":
        fn, args = (lambda *a: ssd_scan(*a, chunk=8)), (
            t(1, 8, 2, 16), t(1, 8, 2), t(2).requires_grad_(), t(1, 8, 2, 16), t(1, 8, 2, 16))
    else:
        ids = torch.zeros((2, 2), dtype=torch.long, device=dev)
        fn, args = moe_decode, (t(2, 64), ids, t(2, 2), t(4, 64, 128).requires_grad_(),
                                t(4, 64, 128), t(4, 128, 64))
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    with torch.no_grad():
        fn(*args)  # no gradient is asked for: the kernel runs


@pytest.mark.cuda
def test_reduced_train_step_kernels_match_plain(dev):
    """One float32 step from one state: the loss, every grad leaf and the
    new state. (Further steps are not compared at 1e-5: Adam's first
    update is sign(g) x lr, which amplifies a rounding of a grad near 0.)"""
    from repro_torch.configs import get_config
    from repro_torch.data.batches import TokenStream
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training import step

    cfg = get_config("qwen2-0.5b", reduced=True)
    batch = TokenStream(cfg, 4, 64, device=dev).next()
    state = step.init_state(LM(cfg, device=dev), torch.Generator(device=dev).manual_seed(0))
    out = {}
    for impl in ("cuda", "plain"):
        lm = LM(cfg, impl=impl, device=dev)
        before = flash_attention.launches, flash_attention_bwd.launches
        _, _, grads = step.loss_and_grads(lm, state["params"], batch, remat=None,
                                          compute_dtype=torch.float32)
        fn = step.make_train_step(lm, OptConfig(lr=1e-3, warmup_steps=1), compute_dtype=torch.float32)
        new_state, metrics = fn(state, batch)
        # the step's remat="full" runs each layer's forward again in the backward pass
        n = cfg.num_layers if impl == "cuda" else 0
        assert flash_attention.launches - before[0] == 3 * n
        assert flash_attention_bwd.launches - before[1] == 2 * n
        out[impl] = (metrics, grads, new_state)
    for name in ("loss", "grad_norm"):
        torch.testing.assert_close(out["cuda"][0][name], out["plain"][0][name], atol=1e-5, rtol=1e-5)
    for i in (1, 2):
        for a, b in zip(tree_leaves(out["cuda"][i]), tree_leaves(out["plain"][i])):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# MoE layer cases: B, S, experts (top-2, d_model 256, d_ff 512): prefill,
# the gathered decode, and the decode routed as one group (17 tokens; 16
# experts)
MOE = [(4, 333, 8), (4, 1, 8), (17, 1, 8), (4, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE)
def test_moe_layer_matches_float64(dev, case):
    """The router runs in float32 on both sides (the reference's cast), so
    both take the same experts and drop the same slots."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe_apply, moe_decl
    from repro_torch.models.params import init_tree

    B, S, E = case
    cfg = get_config("mixtral-8x7b", reduced=True).replace(d_model=256, d_ff=512, num_experts=E)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_tree(gen, moe_decl(cfg), torch.float32, dev)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    y, aux = moe_apply(p, x, cfg)
    y2, aux2 = moe_apply(p, x, cfg)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    y64, aux64 = moe_apply({k: v.double() for k, v in p.items()}, x.double(), cfg)
    assert y.shape == (B, S, cfg.d_model) and bool(torch.isfinite(y).all())
    assert float((y.double() - y64).abs().max()) <= 1e-4 * float(y64.abs().max())
    assert abs(float(aux) - float(aux64)) <= 1e-5


# the gathered MoE decode kernel: B tokens, D, F, E experts, the experts
# held [e0, e0 + E_l), the F slice held, x's type, the weights' type
MOE_DECODE = [
    (4, 256, 512, 8, 0, 8, None, torch.float32, torch.float32),
    (16, 512, 1024, 4, 0, 4, None, torch.float32, torch.float32),  # 8 pairs an expert
    (1, 64, 128, 4, 0, 4, None, torch.float32, torch.float32),  # reduced mixtral
    (3, 4096, 1024, 8, 0, 8, None, torch.float32, torch.float32),  # mixtral's D
    (8, 256, 512, 8, 4, 4, None, torch.float32, torch.float32),  # a rank's 4 experts of 8
    (8, 256, 512, 8, 0, 8, (128, 384), torch.float32, torch.float32),  # an F slice
    (4, 256, 512, 8, 0, 8, None, torch.bfloat16, torch.float32),
    (16, 256, 512, 8, 0, 8, None, torch.bfloat16, torch.bfloat16),
]
#: against ``moe_gathered_ref`` and the plain loop, relative to the output's
#: scale: float32 sums in other orders; in bf16 a sum on a rounding boundary
#: moves an output by a bf16 unit or two
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _moe_inputs(dev, case, seed=5, eidx=None):
    """x, the top-2 ids and gates of a seeded router, and the weights held
    (contiguous, as a rank's shard), e0."""
    from repro_torch.models.layers import moe_topk

    B, D, F, E, e0, E_l, fs, xdt, wdt = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, D), generator=gen, device=dev).to(xdt)
    probs = torch.softmax(x.float() @ torch.randn((D, E), generator=gen, device=dev), -1)
    gate, ids = moe_topk(probs, 2)
    gate = (gate / gate.sum(-1, keepdim=True)).to(xdt)
    wi, wg = (torch.randn((E, D, F), generator=gen, device=dev) * D ** -0.5 for _ in range(2))
    wo = torch.randn((E, F, D), generator=gen, device=dev) * F ** -0.5
    f0, f1 = fs or (0, F)
    wi, wg = (w[e0:e0 + E_l, :, f0:f1].contiguous().to(wdt) for w in (wi, wg))
    wo = wo[e0:e0 + E_l, f0:f1].contiguous().to(wdt)
    return x, (ids if eidx is None else eidx.to(dev)).contiguous(), gate, wi, wg, wo, e0


def _moe_check(args, dtype):
    from repro_torch.models.layers import _gathered_loop

    x, eidx, gate, wi, wg, wo, e0 = args
    n0 = moe_decode.launches
    got = moe_decode(x, eidx, gate, wi, wg, wo, e0=e0)
    again = moe_decode(x, eidx, gate, wi, wg, wo, e0=e0)
    assert torch.equal(got, again) and moe_decode.launches == n0 + 2
    assert got.shape == x.shape and got.dtype == x.dtype and bool(torch.isfinite(got).all())
    for want in (moe_gathered_ref(x, eidx, gate, wi, wg, wo, e0=e0),
                 _gathered_loop(x, eidx, gate, wi, wg, wo, e0=e0)):
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= MOE_TOL[dtype] * scale
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_DECODE)
def test_moe_decode_kernel_matches_plain(dev, case):
    """Against its step-by-step plain version and the plain loop, twice bit
    for bit; a token whose choices all lie outside a rank's experts gets 0."""
    args = _moe_inputs(dev, case)
    got = _moe_check(args, case[7])
    _, eidx, _, wi, _, _, e0 = args
    outside = ((eidx < e0) | (eidx >= e0 + wi.shape[0])).all(-1)
    assert not got[outside].any()


@pytest.mark.cuda
def test_moe_decode_kernel_takes_repeated_ids(dev):
    """Ids repeated within a token put more pairs on one expert than a
    thread keeps (np 4 at B 4): the kernel takes further passes over the
    tile, with the plain versions' result."""
    eidx = torch.tensor([[2, 2], [2, 0], [2, 2], [3, 2]])
    _moe_check(_moe_inputs(dev, MOE_DECODE[0], eidx=eidx), torch.float32)


# flash at Sq != Sk: B, Sq, Sk, H, K, hd, causal (positions arange(Sq) and
# arange(Sk), causal aligned at the top left)
FLASH_XQ = [
    (4, 200, 512, 16, 16, 64, False),  # seamless-m4t-large-v2 cross-attention prefill
    (2, 512, 200, 4, 2, 64, True),
    (1, 37, 100, 4, 2, 16, False),  # reduced widths
    (1, 100, 37, 4, 2, 16, True),
    (2, 129, 333, 8, 4, 128, False),
    (1, 333, 129, 8, 4, 128, True),
    (1, 37, 4097, 14, 2, 64, False),  # few queries against a ragged last key tile
    (2, 300, 77, 8, 2, 128, True),  # Sk under one key tile at hd 128
    (1, 37, 100, 4, 2, 32, False),  # the bf16 route at hd 8-32 at hd 32 and 8 too
    (1, 100, 37, 4, 2, 32, True),
    (2, 129, 65, 7, 1, 8, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", FLASH_XQ)
def test_flash_kernel_at_sq_ne_sk_matches_plain(dev, case, dtype, tol):
    """Every forward route (split-TF32 float32, bf16 wgmma at hd 64 and 128,
    bf16 mma.sync at hd 8, 16, 32, the last also against its step-by-step
    plain version) with its log-sum-exp, and a second run bit for bit."""
    B, Sq, Sk, H, K, hd, causal = case
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert torch.equal(got, flash_attention(q, k, v, causal=causal))
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    want, want_lse = flash_attention_lse_ref(q, k, v, causal=causal)
    assert torch.equal(o, got) and lse.shape == (B, H, Sq)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL[dtype], rtol=LSE_TOL[dtype])
    _mma_close(dtype, hd, q, k, v, dict(causal=causal), o, lse)


# the backward at Sq != Sk: FLASH_XQ, each causal and not, and causal at Sk >
# Sq with keys no query sees (seamless's training cross shape at the end)
FLASH_BWD_XQ = sorted({c[:6] + (causal,) for c in FLASH_XQ for causal in (False, True)}) + [
    (2, 512, 768, 16, 16, 64, True),
    (2, 512, 768, 16, 16, 64, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", FLASH_BWD_XQ)
def test_flash_bwd_kernel_at_sq_ne_sk_matches_plain(dev, case, dtype, tol):
    """Every backward route (float32 on the CUDA cores, bf16 on the tensor
    cores at hd 64 and 128, bf16 hd 16 on the CUDA cores) against the FA2
    plain version at the gradients' tolerance; dK and dV of keys past Sq - 1
    under the causal mask exactly 0; a second run bit for bit."""
    B, Sq, Sk, H, K, hd, causal = case
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd)))
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, g, lse, causal=causal)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, g, lse, causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _grads_close(a, b, tol)
    if causal and Sk > Sq:
        assert not got[1][:, Sq:].any() and not got[2][:, Sq:].any()
    again = flash_attention_bwd(q, k, v, o, g, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", [(4, 16, 16, 64, 512, 199), (2, 4, 2, 16, 20, 3),
                                  (2, 8, 4, 128, 333, 0)])
def test_decode_against_a_cross_cache_sees_every_encoder_slot(dev, case, dtype, tol):
    """One token against seamless's read-only cross cache (pos_ids
    arange(Se)) through the adapter's cross route, the decoder at a position
    below Se - 1: every slot is valid, as the dense non-causal oracle has
    it; a second run bit for bit."""
    from repro_torch.kernels.ops import sdpa_kernel
    from repro_torch.models.layers import _sdpa_dense

    B, H, K, hd, Se, qpos = case
    gen = torch.Generator(device=dev).manual_seed(22)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, 1, H, hd), (B, Se, K, hd), (B, Se, K, hd)))
    q_pos = torch.full((B, 1), qpos, dtype=torch.int32, device=dev)
    k_pos = torch.arange(Se, dtype=torch.int32, device=dev)[None].expand(B, Se).contiguous()
    before = decode_attention.launches
    got = sdpa_kernel(q, k, v, q_pos, k_pos, None, False, None, "cross")
    assert decode_attention.launches == before + 1
    assert torch.equal(got, sdpa_kernel(q, k, v, q_pos, k_pos, None, False, None, "cross"))
    want = _sdpa_dense(q, k, v, q_pos, k_pos, None, False, None)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", SSD_DTYPES)
def test_ssd_kernel_at_jamba_width(dev, dtype, tol):
    """jamba-v0.1-52b's mamba mixer: 128 heads of P 64 over one group of N
    16, chunk 128, a 256-token prompt; a second run bit for bit."""
    args = _ssd_inputs(dev, 2, 256, 128, 64, 16, dtype, seed=23, single_group=True)
    y, h = ssd_scan(*args, chunk=128)
    y2, h2 = ssd_scan(*args, chunk=128)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    yr, hr = ssd_scan_ref(*args, chunk=128)
    ys, hs = ssd_sequential_ref(*args)
    for got, want in ((y, yr), (h, hr), (y, ys), (h, hs)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kv_quant", [("paper-default", True), ("gemma2-2b", True),
                                           ("jamba-v0.1-52b", False),
                                           ("seamless-m4t-large-v2", False),
                                           ("internvl2-76b", False)])
def test_reduced_model_kernels_match_plain(dev, arch, kv_quant):
    """The slice's archs at reduced size on the card: prefill and 4
    teacher-forced decode steps through the kernels against the plain
    versions, float32, logits within 1e-4; seamless with 29 encoder frames
    for a 20-token prompt, internvl2 with a cache small enough to ring-place
    its 148-position prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    cfg = get_config(arch, reduced=True)
    gen = torch.Generator(device=dev).manual_seed(24)
    params = LM(cfg, device=dev).init(gen)
    S = 140 if arch == "internvl2-76b" else 20
    toks = torch.randint(0, cfg.vocab_size, (2, S + 4), generator=gen, device=dev)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_embeds"] = torch.randn((2, S + 9, cfg.d_model), generator=gen, device=dev)
    if cfg.frontend == "vision_patches":
        kw["frontend_embeds"] = torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                                            generator=gen, device=dev)
    kv_len = 4 if arch == "internvl2-76b" else 32
    out = {}
    with torch.no_grad():
        for impl in ("cuda", "plain"):
            lm = LM(cfg, impl=impl, device=dev, kv_quant=kv_quant)
            logits, cache = lm.prefill(params, toks[:, :S], kv_len=kv_len, dtype=torch.float32,
                                       **kw)
            steps = [logits]
            for i in range(4):
                logits, cache = lm.decode_step(params, cache, toks[:, S + i:S + i + 1],
                                               dtype=torch.float32)
                steps.append(logits)
            out[impl] = steps
    for a, b in zip(out["cuda"], out["plain"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b", "jamba-v0.1-52b",
                                  "mixtral-8x7b"])
def test_reduced_training_across_the_registry_kernels_match_plain(dev, arch):
    """The loss and every grad leaf at reduced size, float32, through the
    kernels against the plain versions within 1e-5: seamless with 24
    encoder frames for 16 tokens (its cross-attention's backward at Sq !=
    Sk), internvl2 with 8 patch positions before 8 tokens; one flash forward
    and one backward launch an attention layer (encoder and cross included).
    The kernels' loss and gradients under remat "full", "dots" and "coll"
    equal those without, bit for bit."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.batches import make_batch
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import LM
    from repro_torch.training import step

    cfg = get_config(arch, reduced=True)
    batch = make_batch(np.random.default_rng(3), cfg, batch=2, seq=16, device=dev)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn((2, 24, cfg.d_model), device=dev)
    params = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    n_attn = (sum(k == "attn" for k in cfg.layer_kinds()) * (2 if cfg.is_encoder_decoder else 1)
              + cfg.num_encoder_layers)
    out = {}
    for impl in ("cuda", "plain"):
        before = flash_attention.launches, flash_attention_bwd.launches
        out[impl] = step.loss_and_grads(LM(cfg, impl=impl, device=dev), params, batch,
                                        remat=None, compute_dtype=torch.float32)
        n = n_attn if impl == "cuda" else 0
        assert (flash_attention.launches - before[0], flash_attention_bwd.launches - before[1]) \
            == (n, n)
    (lk, mk, gk), (lp, mp, gp) = out["cuda"], out["plain"]
    torch.testing.assert_close(lk, lp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mk["aux"], mp["aux"], atol=1e-6, rtol=0)
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    for remat in ("full", "dots", "coll"):
        loss, _, grads = step.loss_and_grads(LM(cfg, impl="cuda", device=dev), params, batch,
                                             remat=remat, compute_dtype=torch.float32)
        assert torch.equal(loss, lk), remat
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(gk))), remat


def _served(dev, arch, batch=2, prompt=20):
    """(LM, float32 params, the cache and next token of one prefill) of
    ``arch`` at reduced size on the card, seeded; "<arch>@16" gives it 16
    experts (every reduced MoE config has 4), whose decode routes as one
    group over the batch."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    name, _, experts = arch.partition("@")
    cfg = get_config(name, reduced=True)
    if experts:
        cfg = cfg.replace(num_experts=int(experts))
    gen = torch.Generator(device=dev).manual_seed(33)
    lm = LM(cfg, device=dev)
    params = lm.init(gen, dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_embeds"] = torch.randn((batch, prompt, cfg.d_model), generator=gen, device=dev)
    if cfg.frontend == "vision_patches":
        kw["frontend_embeds"] = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                                            generator=gen, device=dev)
    with torch.no_grad():
        logits, cache = lm.prefill(params, toks, kv_len=32, dtype=torch.float32, **kw)
    return lm, params, cache, torch.argmax(logits, -1)[:, None]


def _eager_steps(lm, params, cache, tok, steps):
    """``steps`` greedy eager ``LM.decode_step`` calls from a copy of
    ``cache``: (each step's logits, the last cache)."""
    from repro_torch.launch import graphs

    cache, out = graphs.clone_tree(cache), []
    with torch.no_grad():
        for _ in range(steps):
            logits, cache = lm.decode_step(params, cache, tok, dtype=torch.float32)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(logits)
    return out, cache


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["paper-default", "mamba2-2.7b", "gemma2-2b",
                                  "seamless-m4t-large-v2", "internvl2-76b", "mixtral-8x7b",
                                  "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
                                  "phi3.5-moe-42b-a6.6b@16"])
def test_captured_decode_replays_the_eager_steps_bit_for_bit(dev, arch):
    """A captured decode step (launch/graphs.py), replayed 8 times from a
    prefill's cache, gives the logits of 8 eager ``LM.decode_step`` calls and
    their cache, bit for bit; the decode kernel's launches are counted at
    each replay (one a self-attention layer, two with cross-attention) and
    none at the capture, and so are the gathered MoE decode's (one an MoE
    layer; none where 16 experts route the decode as one group)."""
    from repro_torch.launch import graphs

    lm, params, cache, tok = _served(dev, arch)
    want, want_cache = _eager_steps(lm, params, cache, tok, 8)
    n0, m0 = decode_attention.launches, moe_decode.launches
    step = graphs.decode_step(lm, params, graphs.clone_tree(cache))
    assert step.route == "graph" and step.graph is not None
    sites = lm.cfg.layer_kinds().count("attn") * (2 if lm.cfg.is_encoder_decoder else 1)
    moe_sites = lm.cfg.ffn_kinds().count("moe") if lm.cfg.num_experts % 16 else 0
    assert moe_sites or "moe" not in lm.cfg.ffn_kinds() or arch.endswith("@16")
    # the warm-up's, not the capture's
    assert (decode_attention.launches, moe_decode.launches) == (n0 + sites, m0 + moe_sites)
    step.buffers["tok"].copy_(tok)
    for i in range(8):
        assert torch.equal(step(), want[i]), i
    assert decode_attention.launches == n0 + 9 * sites
    assert moe_decode.launches == m0 + 9 * moe_sites
    got = _flat(step.buffers["cache"])
    assert got.keys() == _flat(want_cache).keys()
    for k, v in _flat(want_cache).items():
        assert torch.equal(got[k], v), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.cuda
def test_capture_beside_an_eager_decode_on_another_thread(dev):
    """The live engine's workers share the default stream: one thread
    captures a decode step (``capture_error_mode="thread_local"``) while
    another decodes eagerly on the default stream, over and over. Every
    eager run equals the eager run made alone, and the captured step's
    replays equal it too."""
    import threading

    from repro_torch.launch import graphs

    lm, params, cache, tok = _served(dev, "paper-default")
    want, want_cache = _eager_steps(lm, params, cache, tok, 8)
    captured, done, errors, runs = [], threading.Event(), [], []
    start = threading.Barrier(2)

    def eager():
        start.wait()
        try:
            while not done.is_set() or not runs:
                got, _ = _eager_steps(lm, params, cache, tok, 8)
                runs.append(all(torch.equal(a, b) for a, b in zip(got, want)))
        except RuntimeError as e:
            errors.append(f"eager: {e}")

    def capture():
        a = torch.ones((64, 64), device=dev)  # this thread's cuBLAS handles, as
        torch.addmm(a[0], a, a @ a)           # the live engine's _warm_thread
        torch.cuda.current_stream().synchronize()
        start.wait()
        try:
            captured.append(graphs.decode_step(lm, params, graphs.clone_tree(cache),
                                               warmup=False))
        except RuntimeError as e:
            errors.append(f"capture: {e}")
        finally:
            done.set()

    threads = [threading.Thread(target=eager), threading.Thread(target=capture)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and runs and all(runs), (errors, runs)
    step = captured[0]
    step.buffers["tok"].copy_(tok)
    for i in range(8):
        assert torch.equal(step(), want[i]), i
    for k, v in _flat(want_cache).items():
        assert torch.equal(_flat(step.buffers["cache"])[k], v), k


def _launch_counts():
    from repro_torch.kernels import ssd_scan as ssd_module

    return (flash_attention.launches, flash_attention_bwd.launches, ssd_module.ssd_scan.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,remat,seq", [
    ("qwen2-0.5b", None, 64), ("mamba2-2.7b", None, 64), ("mixtral-8x7b", None, 64),
    ("qwen2-0.5b", None, 1536), ("qwen2-0.5b", "full", 1536), ("qwen2-0.5b", "dots", 1536),
    ("qwen2-0.5b", "coll", 1536)])
def test_captured_train_step_replays_the_eager_steps_bit_for_bit(dev, arch, remat, seq):
    """A reduced train step captured (launch/graphs.py::train_step) after one
    eager step, as train() runs it, then replayed 4 times: each replay's
    metrics and the final state equal 5 eager donated steps from the same
    state on the same batches, bit for bit, in bf16 compute. The kernels'
    launches (the backward's from autograd's own thread, and under a remat
    policy the forward recomputed there; at 1,536 tokens the CE's
    checkpointed chunks too) are counted at each replay, as many as an
    eager step's, and none at the capture."""
    from repro_torch.configs import get_config
    from repro_torch.data.batches import TokenStream
    from repro_torch.launch import graphs
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.training import step

    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, device=dev)
    fn = step.make_train_step(lm, OptConfig(warmup_steps=2, total_steps=10), remat=remat,
                              compute_dtype=torch.bfloat16, donate=True)
    stream = TokenStream(cfg, 2, seq, seed=1, device=dev)
    batches = [stream.next() for _ in range(5)]
    state = step.init_state(lm, torch.Generator(device=dev).manual_seed(0))
    twin = graphs.clone_tree(state)
    want = []
    before = _launch_counts()
    for b in batches:
        twin, m = fn(twin, b)
        want.append(m)
    per_step = [(a - b) // 5 for a, b in zip(_launch_counts(), before)]
    assert per_step[0] > 0 and per_step[1] > 0 or per_step[2] > 0, per_step

    state, m = fn(state, batches[0])
    got = [m]
    before = _launch_counts()
    captured = graphs.train_step(lm, fn, state, batches[0])
    assert captured.route == "graph" and captured.graph is not None
    assert _launch_counts() == before  # nothing ran at the capture
    for b in batches[1:]:
        graphs.copy_tree(captured.buffers["batch"], b)
        got.append({k: v.clone() for k, v in captured().items()})
    assert [(a - b) for a, b in zip(_launch_counts(), before)] == [4 * n for n in per_step]
    for g, w in zip(got, want):
        assert all(torch.equal(g[k], w[k]) for k in w), (g, w)
    final = captured.buffers["state"]
    assert int(final["step"]) == 5
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(final), tree_leaves(twin)))
