"""Head dim 256 (gemma2-2b's attention) on the CPU: the plain versions behind
the bf16 ``wgmma`` kernels at hd 256 against the JAX package, the slice as a
whole against it, and the route's plans and schedule.

* ``ref.flash_attention_lse_ref`` against the reference's Pallas kernel
  (``repro.kernels.flash_attention.flash_attention``, interpret mode) and
  its log-sum-exp against ``jax.nn.logsumexp`` of the reference's scores, at
  8 query heads over 4, hd 256, softcap 50, window 0 and 64, S 128 and 256;
* ``ref.flash_attention_bwd_ref`` against ``jax.vjp`` of the reference's
  ``repro.kernels.ops.flash_attention_diff`` (its Pallas forward in
  interpret mode, its backward ``_fa_bwd``), at the same cases;
* the slice: gemma2-2b's config at its attention width (hd 256, 8 heads over
  4, softcaps 50 and 30, the "lg" pattern with the window cut to 64) with
  2 layers and a narrow d_model, d_ff and vocab: the port's ``LM.loss`` and
  every grad leaf (impl "plain", and "cuda", which on the CPU runs the
  autograd Functions over the plain versions) against the reference's
  ``LM(impl="pallas")``, weights carried across by ``params_from_jax``;
* the backward's launch plan at every head dim of its tensor-core route
  (``tc_plan``) held to the source's ``WgTiling`` and to a block's 232,448
  bytes; its misaligned inputs refused; the dK/dV schedule and workspace
  at hd 256; gemma2's traced train step (the dry run's trace route) holding
  the hd-256 workspace.

Inputs come from seeded numpy generators. Tolerances, float32 on both
sides: ``TOL`` of tests/test_torch_kernels.py (atol/rtol 1e-4) for the
kernels' plain versions; the loss rtol 1e-5 and its grads atol 1e-4, as
tests/test_torch_train.py holds every arch. The CUDA kernels themselves are
held against these plain versions on the card (chip_smoke.py phases 3, 8,
12 and 17 (f)).
"""
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.layers import causal_window_mask
from repro.models.transformer import LM as JaxLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention_bwd as bwd_module
from repro_torch.kernels import trace as ktrace
from repro_torch.kernels.flash_attention_bwd import (check_tc_route, dkdv_schedule, tc_plan,
                                                     target_blocks, workspace_numel)
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_lse_ref
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import LM
from repro_torch.perf.hw import H100
from repro_torch.perf.trace import TraceCounts
from repro_torch.training import step

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

TOL = 1e-4  # tests/test_torch_kernels.py's
CSRC = Path(bwd_module.__file__).parents[1] / "csrc"

# B, S, H, K, hd, causal, window, softcap: gemma2-2b's heads, its global
# (window 0) and a local layer (its window cut to 64 of 4096)
CASES = [(1, S, 8, 4, 256, True, w, 50.0) for S in (128, 256) for w in (0, 64)]


def _inputs(case, seed):
    B, S, H, K, hd = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd))]


@functools.partial(jax.jit, static_argnames=("causal", "window", "softcap"))
def _jax_lse(q, k, causal, window, softcap):
    """jax.nn.logsumexp of the reference's masked, scaled, capped scores,
    (B,H,Sq) with h = kv_head * G + g, at positions arange(S)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    s = jnp.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, K, H // K, hd), k) / math.sqrt(hd)
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    qpos = jnp.broadcast_to(jnp.arange(Sq, dtype=jnp.int32)[None], (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk, dtype=jnp.int32)[None], (B, Sk))
    mask = causal_window_mask(qpos, kpos, window if window else None, causal)
    s = jnp.where(mask[:, None, None], s, -1e30)  # the reference's finite mask value
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, Sq)


@functools.partial(jax.jit, static_argnames=("causal", "window", "softcap"))
def _jax_diff_vjp(q, k, v, g, causal, window, softcap):
    """The reference's flash_attention_diff (Pallas forward in interpret
    mode) and jax.vjp of it at g (its custom backward, _fa_bwd)."""
    out, vjp = jax.vjp(lambda q, k, v: jax_ops.flash_attention_diff(q, k, v, causal, window,
                                                                    softcap), q, k, v)
    return out, vjp(g)


@pytest.mark.parametrize("case", CASES)
def test_lse_ref_matches_the_pallas_kernel_at_hd_256(case):
    _, _, _, _, _, causal, win, cap = case
    q, k, v, _ = _inputs(case, 21)
    out, lse = flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                       window=win, softcap=cap)
    want = jax_flash(q, k, v, causal=causal, window=win, softcap=cap, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert lse.dtype == torch.float32 and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse(q, k, causal, win, cap)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_the_reference_custom_vjp_at_hd_256(case):
    """From the plain forward's output and log-sum-exp, the FA2 backward
    gives the gradients of jax.vjp of the reference's flash_attention_diff."""
    _, _, _, _, _, causal, win, cap = case
    q, k, v, g = _inputs(case, 22)
    want_out, want = _jax_diff_vjp(q, k, v, g, causal, win, cap)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_lse_ref(tq, tk, tv, causal=causal, window=win, softcap=cap)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL, rtol=TOL)
    got = flash_attention_bwd_ref(tq, tk, tv, out, torch.from_numpy(g), lse, causal=causal,
                                  window=win, softcap=cap)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


# --- the slice: gemma2-2b at its attention width ------------------------------

#: gemma2-2b's attention as published (hd 256, 8 heads over 4, softcaps 50
#: and 30, local and global layers), one local and one global layer, the
#: window cut to 64 so that it bites at 128 tokens; narrow elsewhere
SLICE = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512, sliding_window=64)
SLICE_B, SLICE_S = 2, 128  # a multiple of 128: the reference's Pallas route


def _slice_batch(seed=0):
    toks = np.random.default_rng(seed).integers(
        0, SLICE["vocab_size"], (SLICE_B, SLICE_S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_slice():
    cfg = jax_get_config("gemma2-2b").replace(**SLICE)
    jm = JaxLM(cfg, impl="pallas")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=None, dtype=jnp.float32), has_aux=True))(
            params, _slice_batch())
    return params, float(loss), float(metrics["ce"]), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_gemma2_slice_loss_and_every_grad_leaf_match_jax(impl):
    cfg = get_config("gemma2-2b").replace(**SLICE)
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.attn_logit_softcap,
            cfg.final_logit_softcap, cfg.local_global_pattern) == (256, 8, 4, 50.0, 30.0, "lg")
    jparams, jloss, jce, jgrads = _jax_slice()
    lm = LM(cfg, impl=impl, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _slice_batch().items()}
    loss, metrics, grads = step.loss_and_grads(lm, params_from_jax(jparams, device="cpu"), batch,
                                               remat=None, compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), jce, rtol=1e-5)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tleaves = tree_leaves(grads)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.detach().float().numpy(), np.asarray(a, np.float32),
                                   atol=1e-4, rtol=0, err_msg=jax.tree_util.keystr(path))


# --- the backward's plan, route and schedule ---------------------------------

def _bwd_tiling(hd):
    """Every ``static constexpr`` of flash_attention_bwd.cu's
    ``WgTiling<hd>``, evaluated in order (``kSubTile`` from
    csrc/wgmma.cuh; C's integer division)."""
    head = (CSRC / "wgmma.cuh").read_text()
    env = {"HD": hd,
           "kSubTile": int(eval(re.search(r"constexpr int kSubTile = ([^;]+);", head).group(1)))}
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    body = re.search(r"struct WgTiling \{(.*?)\n\};", src, re.S).group(1)
    for line in body.splitlines():
        for name, expr in re.findall(r"(k\w+) = ([^;,]+)[;,]", line.split("//")[0]):
            env[name] = eval(expr.replace("/", "//"), {}, env)
    return env


@pytest.mark.parametrize("hd", bwd_module.TC_HEAD_DIMS)
def test_tc_plan_is_the_sources_and_fits_a_block(hd):
    """The backward's launch at each head dim of the tensor-core route is
    what the source's ``WgTiling<hd>`` computes, each pass's shared memory
    fits a block's 232,448 bytes, and the blocks an SM fit its 228 KiB (1
    KiB of it reserved a block). At hd 256 two warpgroups a block, one
    block an SM."""
    w, plan = _bwd_tiling(hd), tc_plan(hd)
    assert (plan["warpgroups"], plan["threads"], plan["blocks_per_sm"]) == (
        w["kNW"], w["kThreads"], w["kBlocks"])
    assert (plan["smem1"], plan["smem2"]) == (w["kSmem1"], w["kSmem2"])
    assert max(plan["smem1"], plan["smem2"]) <= H100.vmem_bytes == 232_448
    assert plan["blocks_per_sm"] * (max(plan["smem1"], plan["smem2"]) + 1024) <= 228 * 1024
    assert target_blocks(hd) == 2 * 132 * plan["blocks_per_sm"]
    if hd == 256:
        assert (plan["warpgroups"], plan["blocks_per_sm"]) == (2, 1)
        assert (plan["smem1"], plan["smem2"]) == (215_040, 222_208)


def _shifted(dtype, shape):
    """A contiguous view one element into its buffer: off a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype,hd,tensor_cores", [
    (torch.bfloat16, 256, True), (torch.bfloat16, 32, True), (torch.float32, 256, True),
    (torch.bfloat16, 16, True), (torch.float32, 64, True), (torch.float32, 128, True)])
def test_bwd_tensor_core_route_refuses_inputs_off_16_bytes(dtype, hd, tensor_cores):
    """Every route of the backward runs on the tensor cores and copies 16
    bytes at a time (bf16 at hd 64, 128 and 256 on wgmma; float32 at every
    head dim and bf16 at hd 8, 16, 32 in split-TF32): a misaligned q, k, v,
    o or do raises, rather than taking another route."""
    q = torch.zeros((1, 8, 4, hd), dtype=dtype)
    kv = torch.zeros((1, 8, 2, hd), dtype=dtype)
    check_tc_route(q, kv, kv, q, q)
    shifted = _shifted(dtype, (1, 8, 4, hd))
    if tensor_cores:
        with pytest.raises(ValueError, match="16-byte"):
            check_tc_route(q, kv, kv, q, shifted)
    else:
        check_tc_route(q, kv, kv, q, shifted)


def _walk(S, G, causal, window, j):
    """The folded rows whose query sees a key of key tile j, by brute force
    over the mask: (first, last + 1), or None."""
    q = np.arange(S)[:, None]
    keys = np.arange(j * 64, min(S, (j + 1) * 64))[None, :]
    seen = np.ones((S, keys.shape[1]), bool)
    if causal:
        seen &= keys <= q
    if window:
        seen &= q - keys < window
    rows = np.flatnonzero(seen.any(1))
    return (rows.min() * G, rows.max() * G + G) if rows.size else None


@pytest.mark.parametrize("shape", [(2048, 2, True, 0, 16), (2048, 2, True, 4096, 16),
                                   (2048, 2, True, 64, 16)])
def test_dkdv_schedule_and_workspace_at_hd_256(shape):
    """gemma2-2b's training shape (4 x 2048, 4 kv heads: 16 copies of the
    schedule), global and local: every key tile's segments are contiguous
    and cover the rows that see it, at the hd-256 route's target of two
    waves at one block an SM (264 blocks). That target cuts fewer tiles than
    hd 64's (792), and the workspace holds a 64 x 256 float32 dK and dV a
    slot a copy."""
    S, G, causal, window, kv_blocks = shape
    items, tiles, slots = dkdv_schedule(S, S, G, causal, window, kv_blocks, 256)
    assert (items, tiles, slots) == dkdv_schedule(S, S, G, causal, window, kv_blocks, 256)
    for j in range(S // 64):
        segs = sorted(it for it in items if it[0] == j)
        lo, hi = _walk(S, G, causal, window, j)
        assert all(a[2] == b[1] for a, b in zip(segs, segs[1:]))
        assert segs[0][1] <= lo < segs[0][1] + 64 and segs[-1][2] == hi
        assert (len(segs) == 1) == (segs[0][3] == -1) == (tiles[j] == (j, -1, 1, 0))
    assert len(items) * kv_blocks >= target_blocks(256) == 264
    _, _, slots64 = dkdv_schedule(S, S, G, causal, window, kv_blocks, 64)
    assert slots <= slots64
    assert workspace_numel(slots, kv_blocks, 256) == slots * kv_blocks * 2 * 64 * 256


def test_gemma2_traced_train_step_holds_the_hd_256_workspace(monkeypatch):
    """gemma2-2b's bf16 train step at its attention width, traced as the
    production dry run traces it (the kernels' trace route, ``TraceCounts``):
    each layer's backward allocates the tensor-core route's float32
    workspace of its schedule at hd 256 (the local layer's window and the
    global one), and the trace's peak holds it. At 2048 tokens the global
    layer's key tiles are cut (its workspace is not empty)."""
    cfg = get_config("gemma2-2b").replace(**SLICE)
    B, S = 1, 2048
    lm = LM(cfg, device="cpu")
    lm.impl = "trace"
    params = lm.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    seen = []
    real = ktrace.workspace_numel
    monkeypatch.setattr(ktrace, "workspace_numel",
                        lambda *a: seen.append(a) or real(*a))
    counts = TraceCounts()
    with counts.counting():
        step.loss_and_grads(lm, params, batch, remat=None, compute_dtype=torch.bfloat16)
    assert counts.kernel_calls["flash_attention_bwd"] == cfg.num_layers == 2
    want = [(dkdv_schedule(S, S, 2, True, w, B * 4, 256)[2], B * 4, 256) for w in (64, 0)]
    assert sorted(seen) == sorted(want)
    workspace = 4 * max(real(*a) for a in want)
    assert workspace > 0 and counts.peak_bytes >= workspace
