"""The port's attention kernels (repro_torch.kernels) against the JAX
package on the CPU: the port's plain versions against the Pallas kernels in
interpret mode at multiple-of-128 shapes, and against repro.kernels.ref at
ragged lengths, windows, softcaps and a ring cache mid-wrap. On the CPU each
wrapper computes its plain version and launches nothing; the CUDA kernels
themselves are held against the plain versions by tests/test_torch_cuda.py
(marked ``cuda``, skipped without a GPU) and by chip_smoke.py.

Tolerance: atol/rtol 1e-4 in float32 (same arithmetic, another summation
order).
"""
import importlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels import ref as jax_ref
from repro_torch.configs import _MODULES, get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as decode_module
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels import flash_attention_bwd as flash_bwd_module
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref
from repro_torch.models import layers
from repro_torch.models.transformer import LM
from repro_torch.perf.hw import H100, V5E, kernel_bound

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

TOL = 1e-4

# the JAX oracles run compiled, one program per shape: compiling op by op
# for every new shape loads the CPU in bursts that disturb the wall-clock
# tests running beside this file (tests/test_live.py)
jax_flash_ref = jax.jit(jax_ref.flash_attention_ref, static_argnames=("causal", "window", "softcap"))
jax_decode_ref = jax.jit(jax_ref.decode_attention_ref, static_argnames=("window", "softcap"))


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _flash_inputs(seed, B, S, H, K, hd):
    return _normal(seed, (B, S, H, hd), (B, S, K, hd), (B, S, K, hd))


def _decode_inputs(seed, B, H, K, hd, Smax, fill):
    q, k, v = _normal(seed, (B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd))
    ar = np.arange(Smax)[None].repeat(B, 0)
    lengths = np.full((B,), fill, np.int32)
    pos = np.where(ar <= lengths[:, None], ar, -1).astype(np.int32)
    return q, k, v, pos, lengths


def _ring_inputs(seed, B, H, K, hd, Smax, first):
    """Absolute positions first..first+Smax-1 stored at slot p % Smax."""
    q, k, v = _normal(seed, (B, H, hd), (B, Smax, K, hd), (B, Smax, K, hd))
    abs_pos = np.arange(first, first + Smax)
    pos = np.zeros((B, Smax), np.int32)
    pos[:, abs_pos % Smax] = abs_pos
    lengths = np.full((B,), first + Smax - 1, np.int32)
    return q, k, v, pos, lengths


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)


# --- plain versions against the Pallas kernels (interpret mode) -------------

# B, S, H, K, hd, causal, window, softcap
FLASH_KERNEL_CASES = [
    (1, 128, 4, 2, 16, True, 0, 0.0),
    (1, 256, 4, 2, 16, True, 128, 0.0),
    (1, 128, 4, 4, 32, True, 0, 50.0),
    (1, 128, 7, 1, 8, False, 0, 0.0),
]


@pytest.mark.parametrize("case", FLASH_KERNEL_CASES)
def test_flash_ref_matches_pallas_kernel(case):
    B, S, H, K, hd, causal, win, cap = case
    q, k, v = _flash_inputs(0, B, S, H, K, hd)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=win, softcap=cap, interpret=True)
    got = flash_attention_ref(*_t(q, k, v), causal=causal, window=win, softcap=cap)
    _close(got, want)


# B, H, K, hd, Smax, window, fill
DECODE_KERNEL_CASES = [
    (2, 4, 2, 16, 128, 0, 60),
    (1, 7, 1, 8, 256, 128, 200),
    (2, 4, 4, 32, 128, 0, 127),
]


@pytest.mark.parametrize("case", DECODE_KERNEL_CASES)
def test_decode_ref_matches_pallas_kernel(case):
    B, H, K, hd, Smax, win, fill = case
    q, k, v, pos, lengths = _decode_inputs(1, B, H, K, hd, Smax, fill)
    want = jax_decode(*map(jnp.asarray, (q, k, v, pos, lengths)), window=win, interpret=True)
    got = decode_attention_ref(*_t(q, k, v, pos, lengths), window=win)
    _close(got, want)


def test_decode_ref_matches_pallas_kernel_on_ring_cache():
    q, k, v, pos, lengths = _ring_inputs(2, 1, 4, 2, 64, 128, 200)
    want = jax_decode(*map(jnp.asarray, (q, k, v, pos, lengths)), window=128, interpret=True)
    got = decode_attention_ref(*_t(q, k, v, pos, lengths), window=128)
    _close(got, want)


# --- plain versions against repro.kernels.ref at what the TPU kernels refuse --

FLASH_RAGGED = [
    (1, 37, 4, 2, 16, True, 0, 0.0),
    (2, 200, 8, 4, 32, True, 0, 0.0),
    (1, 333, 4, 2, 16, True, 8, 0.0),  # window, ragged
    (2, 100, 7, 1, 8, True, 0, 30.0),  # GQA 7:1 at hd 8, softcap
    (1, 129, 4, 1, 64, False, 0, 0.0),  # MQA, non-causal
]


@pytest.mark.parametrize("case", FLASH_RAGGED)
def test_flash_ref_matches_jax_ref_at_ragged_lengths(case):
    B, S, H, K, hd, causal, win, cap = case
    q, k, v = _flash_inputs(3, B, S, H, K, hd)
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=win, softcap=cap)
    got = flash_attention_ref(*_t(q, k, v), causal=causal, window=win, softcap=cap)
    _close(got, want)


# B, H, K, hd, Smax, window, softcap, fill
DECODE_RAGGED = [
    (4, 16, 8, 16, 640, 0, 0.0, 332),
    (2, 7, 1, 8, 200, 0, 0.0, 150),
    (2, 8, 4, 16, 333, 0, 50.0, 250),
    (2, 4, 2, 16, 37, 0, 0.0, -1),  # empty cache: the mean of V, no NaN
    (1, 8, 1, 32, 100, 16, 0.0, 99),  # window inside a full cache
]


@pytest.mark.parametrize("case", DECODE_RAGGED)
def test_decode_ref_matches_jax_ref_at_ragged_lengths(case):
    B, H, K, hd, Smax, win, cap, fill = case
    q, k, v, pos, lengths = _decode_inputs(4, B, H, K, hd, Smax, fill)
    want = jax_decode_ref(*map(jnp.asarray, (q, k, v, pos, lengths)), window=win, softcap=cap)
    got = decode_attention_ref(*_t(q, k, v, pos, lengths), window=win, softcap=cap)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)


@pytest.mark.parametrize("Smax,first,win", [(100, 250, 64), (37, 1000, 37)])
def test_decode_ref_matches_jax_ref_on_ragged_ring_cache(Smax, first, win):
    q, k, v, pos, lengths = _ring_inputs(5, 2, 4, 2, 16, Smax, first)
    want = jax_decode_ref(*map(jnp.asarray, (q, k, v, pos, lengths)), window=win)
    got = decode_attention_ref(*_t(q, k, v, pos, lengths), window=win)
    _close(got, want)


# --- the wrappers and the adapter on the CPU -------------------------------

def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    before = (flash_attention.launches, decode_attention.launches)
    q, k, v = _t(*_flash_inputs(6, 1, 37, 4, 2, 16))
    assert torch.equal(flash_attention(q, k, v, window=8, softcap=20.0),
                       flash_attention_ref(q, k, v, window=8, softcap=20.0))
    dq, dk, dv, pos, lengths = _t(*_decode_inputs(7, 2, 4, 2, 16, 37, 20))
    assert torch.equal(decode_attention(dq, dk, dv, pos, lengths),
                       decode_attention_ref(dq, dk, dv, pos, lengths))
    assert (flash_attention.launches, decode_attention.launches) == before


def test_wrappers_refuse_a_device_that_is_neither_cpu_nor_cuda():
    q = torch.empty((1, 8, 4, 16), device="meta")
    k = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    pos = torch.empty((1, 8), dtype=torch.int32, device="meta")
    lengths = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], k, k, pos, lengths)


@pytest.mark.parametrize("site,Sq,Sk", [("decode", 1, 40), ("prefill", 37, 37),
                                         ("prefill", 5, 9), ("cross", 5, 9), ("cross", 1, 9)])
def test_adapter_routes_the_served_shapes_to_the_wrappers(site, Sq, Sk):
    """Prefill at arange positions (causal, Sq != Sk aligned at the top
    left), decode against a cache, and cross-attention (non-causal: flash
    at Sq != Sk, or one token against every valid encoder slot)."""
    q, k, v = _t(*_normal(8, (2, Sq, 4, 16), (2, Sk, 2, 16), (2, Sk, 2, 16)))
    causal = site != "cross"
    if site == "decode":
        lengths = torch.tensor([39, 20], dtype=torch.int32)
        q_pos = lengths[:, None]
        ar = torch.arange(Sk, dtype=torch.int32)[None].expand(2, Sk)
        k_pos = torch.where(ar <= q_pos, ar, -1).to(torch.int32)
    else:
        q_pos = torch.arange(Sq, dtype=torch.int32)[None].expand(2, Sq)
        k_pos = torch.arange(Sk, dtype=torch.int32)[None].expand(2, Sk)
    got = ops.sdpa_kernel(q, k, v, q_pos, k_pos, None, causal, None, site)
    want = layers._sdpa_dense(q, k, v, q_pos, k_pos, None, causal, None)
    _close(got, want)


@pytest.mark.parametrize("grad_mode,requires_grad,want", [
    (False, True, "flash_attention"), (True, False, "flash_attention"),
    (True, True, "FlashAttentionDiff")])
def test_adapter_serves_prefill_without_the_autograd_function(grad_mode, requires_grad, want,
                                                              monkeypatch):
    """Served prefill (grad off, or no input that requires grad) reaches
    flash_attention, the variant that is timed; only a wanted gradient goes
    through the autograd Function and its log-sum-exp."""
    calls = []
    flash, apply = ops.flash_attention, ops.FlashAttentionDiff.apply

    def spy_flash(*a, **kw):
        calls.append("flash_attention")
        return flash(*a, **kw)

    def spy_apply(*a):
        calls.append("FlashAttentionDiff")
        return apply(*a)

    monkeypatch.setattr(ops, "flash_attention", spy_flash)
    monkeypatch.setattr(ops.FlashAttentionDiff, "apply", spy_apply)
    q, k, v = (t.requires_grad_(requires_grad)
               for t in _t(*_normal(10, (2, 37, 4, 16), (2, 37, 2, 16), (2, 37, 2, 16))))
    pos = torch.arange(37, dtype=torch.int32)[None].expand(2, 37)
    with torch.set_grad_enabled(grad_mode):
        got = ops.sdpa_kernel(q, k, v, pos, pos, None, True, None, "prefill")
    assert calls == [want]
    assert (got.grad_fn is not None) == (want == "FlashAttentionDiff")
    _close(got.detach(), layers._sdpa_dense(q, k, v, pos, pos, None, True, None).detach())


@pytest.mark.parametrize("site,Sq,Sk", [("decode", 2, 40), ("decode", 3, 17), ("train", 5, 5)])
def test_adapter_raises_for_shapes_off_the_slice(site, Sq, Sk):
    """A multi-token decode and an unknown site have no kernel route."""
    q, k, v = _t(*_normal(9, (1, Sq, 4, 16), (1, Sk, 2, 16), (1, Sk, 2, 16)))
    pos = torch.zeros((1, Sq), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        ops.sdpa_kernel(q, k, v, pos, pos, None, True, None, site)


def test_unknown_sdpa_impl_raises():
    with pytest.raises(KeyError):
        LM(get_config("paper-default", reduced=True), impl="jnp", device="cpu")
    q = torch.zeros((1, 2, 4, 16))
    pos = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(KeyError):
        layers.sdpa(q, q[:, :, :2], q[:, :, :2], q_pos=pos, k_pos=pos, window=None,
                    causal=True, cap=None, site="prefill", impl="pallas")


def test_every_attention_head_dim_of_the_port_configs_has_a_kernel():
    """gemma2-2b's head_dim 256 included: every arch, full and reduced, can
    prefill, train and decode through the kernels at its own width."""
    dims = {get_config(name, reduced=reduced).head_dim
            for name in _MODULES for reduced in (False, True)} - {0}
    assert 256 in dims
    for mod in (flash_module, flash_bwd_module, decode_module):
        assert dims <= set(mod.HEAD_DIMS), (mod.__name__, sorted(dims - set(mod.HEAD_DIMS)))


def test_kernel_modules_import_and_build_nothing_without_nvcc(monkeypatch, tmp_path):
    def no_process(*a, **k):
        raise AssertionError("a kernel module started a process on import")

    monkeypatch.setattr(subprocess, "Popen", no_process)
    for mod in (_build, importlib.import_module("repro_torch.kernels.flash_attention"),
                importlib.import_module("repro_torch.kernels.flash_attention_bwd"),
                importlib.import_module("repro_torch.kernels.decode_attention"),
                importlib.import_module("repro_torch.kernels.ssd_scan")):
        importlib.reload(mod)
    # asked to build where there is no nvcc, _build says so
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# --- hardware model ---------------------------------------------------------

def test_h100_spec_and_kernel_bound():
    assert (H100.peak_flops_bf16, H100.peak_flops_f32, H100.hbm_bandwidth) == (989e12, 67e12, 3.35e12)
    assert H100.hbm_bytes == 80 * 10**9
    assert V5E.peak_flops_bf16 == 197e12 and V5E.hbm_bandwidth == 819e9
    t, by = kernel_bound(67e12, 1.0, f32=True)
    assert (t, by) == (1.0, "operations")
    t, by = kernel_bound(1.0, 3.35e12, f32=False)
    assert (t, by) == (1.0, "bytes")
    with pytest.raises(ValueError):
        kernel_bound(1.0, 1.0, f32=True, hw=V5E)


def test_split_tf32_bound_counts_three_tf32_products():
    assert H100.peak_flops_tf32 == 495e12 and V5E.peak_flops_tf32 is None
    t, by = kernel_bound(165e12, 1.0, f32=True, split_tf32=True)
    assert (t, by) == (1.0, "operations")
    # the served flash shape: 227.8 MFLOP is 1.38 us so, 3.4 us on the CUDA cores
    assert kernel_bound(227.8e6, 0, f32=True, split_tf32=True)[0] < kernel_bound(227.8e6, 0, f32=True)[0]
    with pytest.raises(ValueError):  # a float32 route only
        kernel_bound(1.0, 1.0, f32=False, split_tf32=True)
    with pytest.raises(ValueError):
        kernel_bound(1.0, 1.0, f32=True, split_tf32=True, hw=V5E)
