"""The int8 KV cache (``LM(kv_quant=True)``) of the port against the JAX
package's on the CPU: ``quantize_kv`` / ``dequantize_kv`` code for code, and
prefill, the cache and four greedy decode steps of paper-default,
qwen2-0.5b and gemma2-2b (whose reduced window of 8 makes a ring that the
12-token prompt and the decode steps wrap). Tolerances: tests/_lm_parity.py
(float leaves and logits 5e-4; int8 codes, pos_ids and tokens equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import check_prefill_and_decode, jax_model, leaves
from repro.models.layers import dequantize_kv as jax_dequantize_kv
from repro.models.layers import quantize_kv as jax_quantize_kv
from repro_torch.configs import get_config
from repro_torch.models.layers import dequantize_kv, quantize_kv
from repro_torch.models.transformer import LM

torch.set_num_threads(1)

ARCHS = ["paper-default", "qwen2-0.5b", "gemma2-2b"]


def _halfway(shape, seed):
    """Values whose codes fall on a tie: each (slot, head) row's largest
    magnitude is 127 (scale 1), the rest k + 0.5, which round half to even."""
    rng = np.random.default_rng(seed)
    t = rng.integers(-126, 126, shape).astype(np.float32) + 0.5
    t[..., 0] = 127.0
    return t


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "bf16"])
def test_quantize_kv_matches_jax(case):
    rng = np.random.default_rng(7)
    shape = (2, 9, 3, 16)
    if case == "ties":
        t = _halfway(shape, 7)
    elif case == "zeros":  # an all-zero row: the 1e-8 floor on the scale
        t = rng.standard_normal(shape).astype(np.float32)
        t[:, 3] = 0.0
    else:
        t = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    dt = torch.bfloat16 if case == "bf16" else torch.float32
    tt = torch.as_tensor(t).to(dt)
    jt = jnp.asarray(tt.float().numpy()).astype(jnp.bfloat16 if case == "bf16" else jnp.float32)
    q, s = quantize_kv(tt)
    jq, js = jax_quantize_kv(jt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == shape and s.shape == shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if case == "ties":  # half to even, as jnp.round
        np.testing.assert_array_equal(q.numpy()[..., 1:], np.round(t[..., 1:]).astype(np.int8))
    np.testing.assert_array_equal(dequantize_kv(q, s, torch.float32).numpy(),
                                  np.asarray(jax_dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_and_decode_match_jax(arch, impl):
    """impl "cuda" on CPU tensors runs the kernel adapters' routing with the
    wrappers' plain versions (decode after the dequantizing pass)."""
    cache = check_prefill_and_decode(arch, impl, kv_quant=True)
    attn = cache["blocks"]["sub0"]["attn"]
    assert sorted(attn) == ["k_q", "k_s", "pos_ids", "v_q", "v_s"]
    assert attn["k_q"].dtype == torch.int8 and attn["k_s"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_spec_matches_jax(arch):
    _, jm, _ = jax_model(arch, kv_quant=True)
    lm = LM(get_config(arch, reduced=True), device="cpu", kv_quant=True)
    want = {tuple(k.key for k in path): (tuple(s.shape), np.dtype(s.dtype).name)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jm.cache_spec(3, 20, jnp.float32))[0]}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in leaves(lm.init_cache(3, 20, torch.float32)).items()}
    assert got == want


def test_int8_cache_is_a_quarter_and_a_bit_of_the_float_cache():
    """hd int8 codes and one float32 scale a (slot, head), against hd
    float32 values: (hd + 4) / (4 hd) of the bytes (68 / 256 at hd 64)."""
    cfg = get_config("paper-default", reduced=True)

    def nbytes(kv_quant):
        lm = LM(cfg, device="cpu", kv_quant=kv_quant)
        return sum(t.numel() * t.element_size() for path, t in
                   leaves(lm.init_cache(2, 40, torch.float32)).items()
                   if path[-1] not in ("pos_ids", "lengths"))

    hd = cfg.head_dim
    assert nbytes(True) * 4 * hd == nbytes(False) * (hd + 4)


def test_int8_decode_writes_the_cache_in_place():
    """A decode step writes the new slot's codes and scales into the cache it
    is given and leaves every other slot as it was."""
    cfg = get_config("paper-default", reduced=True)
    lm = LM(cfg, device="cpu", kv_quant=True)
    params = lm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(1))
    _, cache = lm.prefill(params, toks, kv_len=16, dtype=torch.float32)
    before = {k: v.clone() for k, v in leaves(cache).items()}
    _, after = lm.decode_step(params, cache, toks[:, :1], dtype=torch.float32)
    kq = cache["blocks"]["sub0"]["attn"]["k_q"]
    assert after["blocks"]["sub0"]["attn"]["k_q"] is kq
    old = before[("blocks", "sub0", "attn", "k_q")]
    assert torch.equal(kq[:, :, :5], old[:, :, :5]) and torch.equal(kq[:, :, 6:], old[:, :, 6:])
    assert not torch.equal(kq[:, :, 5], old[:, :, 5])
    pos = cache["blocks"]["sub0"]["attn"]["pos_ids"]
    assert pos[:, :, 5].tolist() == [[5, 5]] * lm.n_super
