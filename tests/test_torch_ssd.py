"""The port's Mamba2 SSD (repro_torch.models.ssd, the plain versions in
repro_torch.kernels.ref and the ssd_scan wrapper) against the JAX package
on the CPU: the chunked scan against the Pallas ``ssd_scan`` in interpret
mode and against the sequential recurrence, the decode step, and the mixer
layer in prefill and decode at mamba2-2.7b reduced. Inputs come from a
seeded numpy generator; mixer params are drawn by the JAX ``LM.init`` and
carried across with ``params_from_jax``.

Tolerance: atol/rtol 2e-4 in float32, the reference's own for its scan
(the same arithmetic in another summation order, over chunks of up to 128
steps); 5e-4 for the mixer layer, as for the model in test_torch_model.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import ssd as jax_ssd
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref, ssd_sequential_ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssd

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

TOL = 2e-4
LAYER_TOL = 5e-4
ARCH = "mamba2-2.7b"

# the JAX oracles run compiled, one program per shape: compiling op by op
# for every new shape loads the CPU in bursts that disturb the wall-clock
# tests running beside this file (tests/test_live.py)
jax_seq_ref = jax.jit(jax_ref.ssd_sequential_ref)
jax_chunked = jax.jit(jax_ssd.ssd_chunked, static_argnums=5)
jax_decode_step = jax.jit(jax_ssd.ssd_decode_step)
jax_causal_conv = jax.jit(jax_ssd._causal_conv)
jax_mamba_prefill = jax.jit(functools.partial(jax_ssd.mamba_apply, want_cache=True),
                            static_argnames="cfg")
jax_mamba_decode = jax.jit(jax_ssd.mamba_apply, static_argnames="cfg")


def _ssd_inputs(seed, B, S, H, P, N):
    """x, dt (softplus'ed), A (negative), B_, C_ as float32 numpy arrays, drawn
    as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


# --- the chunked scan -------------------------------------------------------

# B, S, H, P, N, chunk
SSD_CASES = [
    (2, 16, 8, 16, 16, 8),  # mamba2-2.7b reduced
    (1, 128, 8, 16, 16, 32),  # jamba-like small state
    (1, 74, 2, 16, 32, 37),  # a chunk that is not a power of two
    (2, 256, 2, 32, 64, 128),
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_ref_matches_pallas_kernel_and_recurrence(case):
    B, S, H, P, N, chunk = case
    x, dt, A, Bm, Cm = _ssd_inputs(0, B, S, H, P, N)
    yk, hk = jax_ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk, interpret=True)
    y, h = ssd_scan_ref(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    ys, hs = ssd_sequential_ref(*_t(x, dt, A, Bm, Cm))
    assert y.dtype == torch.float32 and h.shape == (B, H, P, N)
    _close(y, yk)
    _close(h, hk)
    _close(y, ys)
    _close(h, hs)


@pytest.mark.parametrize("case", [(2, 40, 3, 8, 16), (1, 1, 2, 4, 8)])
def test_ssd_sequential_ref_matches_jax(case):
    x, dt, A, Bm, Cm = _ssd_inputs(1, *case)
    yj, hj = jax_seq_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    y, h = ssd_sequential_ref(*_t(x, dt, A, Bm, Cm))
    _close(y, yj)
    _close(h, hj)


@pytest.mark.parametrize("S,chunk", [(50, 37), (13, 8), (129, 128)])
def test_ssd_scan_ref_right_padded_with_zero_dt(S, chunk):
    """mamba_apply pads S up to a multiple of the chunk with dt = 0: the
    first S outputs and the final state are those of the unpadded input."""
    x, dt, A, Bm, Cm = _ssd_inputs(2, 1, S, 2, 16, 16)
    pad = (-S) % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)) for a in (x, dt, Bm, Cm)]
    xp, dtp, Bp, Cp = padded
    y, h = ssd_scan_ref(*_t(xp, dtp, A, Bp, Cp), chunk=chunk)
    yj, hj = jax_chunked(*map(jnp.asarray, (xp, dtp, A, Bp, Cp)), chunk)
    ys, hs = ssd_sequential_ref(*_t(x, dt, A, Bm, Cm))
    _close(y, yj)
    _close(h, hj)
    _close(y[:, :S], ys)
    _close(h, hs)


def test_ssd_chunked_from_an_initial_state_matches_jax():
    x, dt, A, Bm, Cm = _ssd_inputs(3, 2, 24, 3, 8, 16)
    h0 = np.random.default_rng(4).standard_normal((2, 3, 8, 16)).astype(np.float32)
    yj, hj = jax_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 8, jnp.asarray(h0))
    y, h = ssd.ssd_chunked(*_t(x, dt, A, Bm, Cm), 8, h0=torch.from_numpy(h0))
    _close(y, yj)
    _close(h, hj)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(5)
    B, H, P, N = 3, 4, 8, 16
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, H, N)).astype(np.float32) for _ in range(2))
    yj, hj = jax_decode_step(*map(jnp.asarray, (h, x, dt, A, Bm, Cm)))
    y, hn = ssd.ssd_decode_step(*_t(h, x, dt, A, Bm, Cm))
    _close(y, yj)
    _close(hn, hj)


# --- the mixer layer --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mixer():
    """(cfg, JAX params of layer 0's mixer, the same as torch tensors)."""
    cfg = jax_get_config(ARCH, reduced=True)
    jp = JaxLM(cfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
    p0 = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"]["sub0"]["mamba"])
    return cfg, p0, params_from_jax(p0, device="cpu")


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("S", [13, 8])
def test_mamba_apply_prefill_and_decode_match_jax(impl, S):
    """Prefill with want_cache (y, ssm, conv), then one decode step from that
    cache; S = 13 pads to two chunks of 8. impl "cuda" on CPU tensors runs
    the adapter with the wrapper's plain version."""
    cfg, jp, tp = _mixer()
    tcfg = get_config(ARCH, reduced=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jax_mamba_prefill(jp, jnp.asarray(x), cfg=cfg)
    ty, tc = ssd.mamba_apply(tp, torch.from_numpy(x), cfg=tcfg, want_cache=True, impl=impl)
    _close(ty, jy, LAYER_TOL)
    assert sorted(tc) == ["conv", "ssm"] and tc["ssm"].dtype == torch.float32
    _close(tc["ssm"], jc["ssm"], LAYER_TOL)
    _close(tc["conv"], jc["conv"], LAYER_TOL)

    jy1, jc1 = jax_mamba_decode(jp, jnp.asarray(x1), cfg=cfg, cache=jc)
    ssm, conv = tc["ssm"], tc["conv"]
    ty1, tc1 = ssd.mamba_apply(tp, torch.from_numpy(x1), cfg=tcfg, cache=tc, impl=impl)
    _close(ty1, jy1, LAYER_TOL)
    # decode writes the new state into the given tensors in place
    assert tc1["ssm"] is ssm and tc1["conv"] is conv
    _close(ssm, jc1["ssm"], LAYER_TOL)
    _close(conv, jc1["conv"], LAYER_TOL)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    _close(ssd._causal_conv(*_t(u, w, b)), jax_causal_conv(*map(jnp.asarray, (u, w, b))))


def test_mamba_decls_and_cache_decl_match_jax():
    cfg, tcfg = jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jd, td = jax_ssd.mamba_decl(cfg), ssd.mamba_decl(tcfg)
    assert {k: (d.shape, d.axes, d.init, d.fan_in) for k, d in jd.items()} == \
        {k: (d.shape, d.axes, d.init, d.fan_in) for k, d in td.items()}
    jc = jax_ssd.mamba_cache_decl(cfg, 3, jnp.float32)
    tc = ssd.mamba_cache_decl(tcfg, 3, torch.float32)
    assert {k: v.shape for k, v in jc.items()} == {k: v[0] for k, v in tc.items()}
    assert tc["ssm"][1] == torch.float32


# --- the wrapper, the adapter and the registry on the CPU -------------------

def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    before = ssd_scan.launches
    args = _t(*_ssd_inputs(8, 1, 74, 2, 16, 16))
    y, h = ssd_scan(*args, chunk=37)
    want_y, want_h = ssd_scan_ref(*args, chunk=37)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    # with an initial state the CPU wrapper still computes the plain version
    h0 = torch.ones((1, 2, 16, 16))
    assert torch.equal(ssd_scan(*args, chunk=37, h0=h0)[1],
                       ssd_scan_ref(*args, chunk=37, h0=h0)[1])
    assert ssd_scan.launches == before


def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda():
    x = torch.empty((1, 8, 2, 16), device="meta")
    dt = torch.empty((1, 8, 2), device="meta")
    A = torch.empty((2,), device="meta")
    Bm = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Bm, chunk=8)
    with pytest.raises(NotImplementedError):
        ssd_scan(x, dt, A, Bm, Bm, chunk=8, h0=torch.empty((1, 2, 16, 16), device="meta"))


def test_ssd_impls_are_registered_and_an_unknown_one_raises():
    assert ssd.SSD_IMPL["plain"] is ssd.ssd_chunked
    assert ssd.SSD_IMPL["cuda"] is ops.ssd_kernel
    cfg, _, tp = _mixer()
    with pytest.raises(KeyError):
        ssd.mamba_apply(tp, torch.zeros((1, 8, cfg.d_model)), cfg=get_config(ARCH, reduced=True),
                        impl="pallas")
