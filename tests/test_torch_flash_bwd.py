"""The plain versions behind the port's flash backward kernel against the
JAX package on the CPU: ``flash_attention_lse_ref`` (the forward's output
and its float32 log-sum-exp, which the CUDA forward writes beside its
output) and ``flash_attention_bwd_ref`` (the FlashAttention-2 backward from
o and the log-sum-exp, the algorithm of ``csrc/flash_attention_bwd.cu``).
The CUDA kernels themselves are held against these on the card by
tests/test_torch_cuda.py (marked ``cuda``) and chip_smoke.py.

Inputs come from a seeded numpy generator and go to both packages.
Tolerances, float32 on both sides: the log-sum-exp atol/rtol 1e-5 (one
reduction in another order); the gradients 1e-4, as
tests/test_torch_train.py holds ``flash_attention_diff``.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.layers import causal_window_mask
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_lse_ref

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

LSE_TOL = 1e-5
GRAD_TOL = 1e-4

# B, S, H, K, hd, causal, window, softcap: tests/test_torch_train.py's FLASH_GRAD_CASES
CASES = [
    (1, 128, 4, 2, 16, True, 0, 0.0),
    (2, 128, 7, 1, 8, True, 0, 0.0),  # qwen2-0.5b reduced: GQA 7:1 at hd 8
    (1, 256, 7, 1, 8, True, 64, 0.0),  # window
    (1, 128, 4, 4, 16, True, 0, 30.0),  # softcap
    (1, 128, 4, 2, 16, False, 0, 0.0),  # non-causal
    (2, 37, 7, 1, 8, True, 0, 0.0),  # ragged: the Pallas kernel takes multiples of 128
    (1, 37, 4, 2, 16, True, 8, 20.0),  # ragged, window and softcap
]


def _inputs(case, seed):
    B, S, H, K, hd = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd))]


# the JAX side runs compiled, one program per shape: compiling op by op
# loads the CPU in bursts that disturb the wall-clock tests running beside
# this file (tests/test_live.py)
@functools.partial(jax.jit, static_argnames=("causal", "window", "softcap"))
def _jax_lse(q, k, causal, window, softcap):
    """jax.nn.logsumexp of the JAX oracle's masked, scaled, capped scores,
    (B,H,S) with h = kv_head * G + g (the math of repro.models.layers._sdpa_dense)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    s = jnp.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    mask = causal_window_mask(pos, pos, window if window else None, causal)
    s = jnp.where(mask[:, None, None], s, -1e30)  # the oracle's finite mask value
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, S)


@functools.partial(jax.jit, static_argnames=("causal", "window", "softcap"))
def _jax_oracle_vjp(q, k, v, g, causal, window, softcap):
    """The JAX oracle's output and jax.vjp of it at the cotangent g."""
    out, vjp = jax.vjp(lambda q, k, v: jax_ref.flash_attention_ref(
        q, k, v, causal=causal, window=window, softcap=softcap), q, k, v)
    return out, vjp(g)


@pytest.mark.parametrize("case", CASES)
def test_lse_ref_matches_jax_logsumexp(case):
    _, _, _, _, _, causal, win, cap = case
    q, k, v, _ = _inputs(case, 11)
    out, lse = flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                       window=win, softcap=cap)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse(q, k, causal, win, cap)),
                               atol=LSE_TOL, rtol=LSE_TOL)
    want, _ = _jax_oracle_vjp(q, k, v, np.zeros_like(q), causal, win, cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_jax_vjp_of_the_oracle(case):
    """From the JAX oracle's own output and log-sum-exp, the FA2 backward
    gives jax.vjp's gradients."""
    _, _, _, _, _, causal, win, cap = case
    q, k, v, g = _inputs(case, 12)
    out, want = _jax_oracle_vjp(q, k, v, g, causal, win, cap)
    lse = _jax_lse(q, k, causal, win, cap)
    got = flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(np.array(out)), torch.from_numpy(g),
                                  torch.from_numpy(np.array(lse)), causal=causal, window=win,
                                  softcap=cap)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] % 128 == 0])
def test_bwd_wrapper_matches_the_reference_custom_vjp(case):
    """At multiples of 128, against the reference's own custom VJP (its
    Pallas forward in interpret mode), through the port's CPU wrappers:
    the log-sum-exp and output of flash_attention_lse_ref, then
    flash_attention_bwd (which on CPU tensors runs flash_attention_bwd_ref)."""
    _, _, _, _, _, causal, win, cap = case
    q, k, v, g = _inputs(case, 13)

    def jf(q, k, v):
        return jnp.sum(jax_ops.flash_attention_diff(q, k, v, causal, win, cap) * g)

    want = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_lse_ref(tq, tk, tv, causal=causal, window=win, softcap=cap)
    got = flash_attention_bwd(tq, tk, tv, out, torch.from_numpy(g), lse, causal=causal,
                              window=win, softcap=cap)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_bwd_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    q, k, v, g = map(torch.from_numpy, _inputs(CASES[-1], 14))
    out, lse = flash_attention_lse_ref(q, k, v, window=8, softcap=20.0)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, g, lse, window=8, softcap=20.0)
    want = flash_attention_bwd_ref(q, k, v, out, g, lse, window=8, softcap=20.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attention_bwd.launches == before
