"""Float32 attention on the tensor cores (split-TF32) on the CPU: the plain
versions that write out the float32 kernels' algorithms step by step, held
against the JAX package, and the kernels' tilings and routes held to the
sources.

* ``ref.flash_attention_bwd_split_ref`` (the algorithm of
  ``dkdv_tf32_kernel``, ``dkdv_merge_kernel<float>`` and ``dq_tf32_kernel``:
  the D pre-pass, the dK/dV schedule's segments in 32-row stages with the
  cut tiles' partials added in slot order, the dQ pass in 32-key stages,
  every product split into tf32 halves, P and dS too) against
  ``ref.flash_attention_bwd_ref`` and against the reference's oracle VJP
  (``repro.kernels.ops._fa_bwd``), at hd 8, 16, 32, 64, 128 and 256 (GQA
  2:1, the column-split kernels' tiling), GQA 7:1, windows, softcap 50,
  ragged S, non-causal, and Sq != Sk both ways;
* ``ref.flash_attention_split_ref`` at hd 256 (gemma2-2b's served float32
  forward: 8 query heads over 4, softcap 50, a window) against the
  reference's Pallas ``flash_attention`` in interpret mode;
* ``tf32_plan`` (the forward's ``Tf32Tiling``) and ``tf32_bwd_plan`` (the
  backward's ``Tf32BwdTiling``) held to the sources and to a block's
  232,448 bytes; the dispatch in both sources and the wrappers' routes:
  float32 takes the tensor cores at hd 8 to 256 both ways; the float32
  schedule's target; the trace route's float32 backward holding its
  workspace.

Inputs come from seeded numpy generators. Tolerances, float32 on both
sides: the output and log-sum-exp atol/rtol 1e-4 (tests/test_torch_kernels.py's),
the gradients 1e-4 of their scale (max |want|), as chip_smoke.py holds the
float32 kernels.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fwd_module
from repro_torch.kernels import flash_attention_bwd as bwd_module
from repro_torch.kernels import trace as ktrace
from repro_torch.kernels.flash_attention import check_route, tf32_plan
from repro_torch.kernels.flash_attention_bwd import (check_tc_route, dkdv_schedule, route,
                                                     target_blocks, tf32_bwd_plan)
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_bwd_split_ref,
                                     flash_attention_lse_ref, flash_attention_split_ref)
from repro_torch.perf.hw import H100
from repro_torch.perf.trace import TraceCounts

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

TOL = 1e-4
CSRC = Path(bwd_module.__file__).parents[1] / "csrc"
F32 = torch.float32

# B, Sq, Sk, H, K, hd, causal, window, softcap
BWD_CASES = {
    "hd8_g7_ragged": (2, 100, 100, 7, 1, 8, True, 0, 0.0),  # reduced qwen2-0.5b's GQA 7:1
    "hd64_g7_cut_tiles": (1, 300, 300, 14, 2, 64, True, 0, 0.0),  # segments merged
    "hd128_window": (1, 200, 200, 4, 2, 128, True, 64, 0.0),
    "hd64_softcap50": (1, 128, 128, 4, 2, 64, True, 0, 50.0),
    "hd16_window_softcap_ragged": (1, 37, 37, 4, 2, 16, True, 8, 50.0),
    "hd32_window_inside_a_tile": (1, 150, 150, 4, 1, 32, True, 40, 0.0),
    "sq_lt_sk_causal": (1, 100, 333, 4, 2, 64, True, 0, 0.0),  # keys past Sq - 1: zeros
    "sq_gt_sk_causal": (1, 333, 129, 4, 2, 32, True, 0, 0.0),
    "cross_non_causal": (2, 64, 200, 4, 4, 64, False, 0, 0.0),  # seamless's cross shape
    "hd128_non_causal_window": (1, 129, 129, 4, 1, 128, False, 48, 0.0),
    # hd 256 (gemma2-2b's heads, 8 over 4: the column-split kernels'
    # 16-row and 16-key stages, B operands split as read)
    "hd256_softcap50_ragged": (1, 100, 100, 8, 4, 256, True, 0, 50.0),
    "hd256_window_bites": (1, 150, 150, 8, 4, 256, True, 40, 50.0),
    "hd256_sq_lt_sk": (2, 37, 129, 8, 4, 256, True, 0, 50.0),
    "hd256_sq_gt_sk": (1, 140, 70, 8, 4, 256, True, 0, 0.0),
    "hd256_cross_non_causal": (1, 33, 90, 8, 4, 256, False, 0, 50.0),
    "hd256_cut_tiles": (1, 512, 512, 8, 4, 256, True, 0, 50.0),
}


def _inputs(case, seed):
    B, Sq, Sk, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd))]


@functools.partial(jax.jit, static_argnames=("causal", "window", "softcap"))
def _jax_fa_bwd(q, k, v, g, causal, window, softcap):
    """The reference's backward of ``flash_attention_diff``: jax.vjp of its
    jnp oracle (``repro.kernels.ops._fa_bwd``)."""
    return jax_ops._fa_bwd(causal, window, softcap, (q, k, v), g)


def _grad_close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{name}: max abs err {err} beyond {TOL} x {scale}"


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_bwd_split_ref_matches_the_plain_version_and_the_oracle_vjp(name):
    """The split-TF32 backward's algorithm gives the FA2 backward's gradients
    and the reference's custom VJP's, from the forward's own output and
    log-sum-exp."""
    case = BWD_CASES[name]
    causal, win, cap = case[6:]
    q, k, v, g = _inputs(case, 7)
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    o, lse = flash_attention_lse_ref(*t[:3], causal=causal, window=win, softcap=cap)
    got = flash_attention_bwd_split_ref(*t[:3], o, t[3], lse, causal=causal, window=win,
                                        softcap=cap)
    plain = flash_attention_bwd_ref(*t[:3], o, t[3], lse, causal=causal, window=win,
                                    softcap=cap)
    oracle = _jax_fa_bwd(*map(jnp.asarray, (q, k, v, g)), causal, win, cap)
    for n, a, b, w, x in zip("qkv", got, plain, oracle, (q, k, v)):
        assert a.dtype == F32 and a.shape == x.shape
        _grad_close(a, b, f"{name} d{n} vs plain")
        _grad_close(a, w, f"{name} d{n} vs jax")
    if causal and case[2] > case[1]:  # keys no query sees
        assert not got[1][:, case[1]:].any() and not got[2][:, case[1]:].any()


# B, S, H, K, hd, causal, window, softcap: gemma2-2b's served float32 heads
HD256_CASES = {
    "global_softcap50": (1, 128, 8, 4, 256, True, 0, 50.0),
    "window128_softcap50": (1, 256, 8, 4, 256, True, 128, 50.0),
}


@pytest.mark.parametrize("name", list(HD256_CASES))
def test_flash_split_ref_at_hd_256_matches_pallas_kernel(name):
    """The float32 forward's algorithm at hd 256 (four groups of 8 keys,
    32-key stages) against the reference's Pallas kernel in interpret mode, and
    its log-sum-exp against the plain version's."""
    B, S, H, K, hd, causal, win, cap = HD256_CASES[name]
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got, lse = flash_attention_split_ref(*t, causal=causal, window=win, softcap=cap)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, window=win, softcap=cap,
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    want, want_lse = flash_attention_lse_ref(*t, causal=causal, window=win, softcap=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=TOL, rtol=TOL)


def _c_eval(expr, env):
    """A C constant expression of the tilings (ints, ternaries, sizeof)."""
    expr = expr.replace("(int)sizeof(float)", "4").replace("/", "//")
    while "?" in expr:
        m = re.search(r"\(([^()]*\?[^()]*)\)", expr)
        inner = m.group(1) if m else expr
        cond, rest = inner.split("?", 1)
        a, b = rest.split(":", 1)
        py = f"(({a}) if ({cond}) else ({b}))"
        expr = expr.replace(f"({inner})", py) if m else py
    return eval(expr, {}, env)


def _tiling(source, struct, hd):
    """Every ``static constexpr`` of ``struct<hd>`` in ``source``, evaluated
    in order (``kKeys`` from the source's namespace scope)."""
    src = (CSRC / source).read_text()
    env = {"HD": hd}
    keys = re.search(r"\nconstexpr int kKeys = (\d+);", src)
    if keys:
        env["kKeys"] = int(keys.group(1))
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    for line in body.splitlines():
        m = re.search(r"static constexpr (?:int|bool) (k\w+) = ([^;]+);", line.split("//")[0])
        if m:
            env[m.group(1)] = _c_eval(m.group(2), env)
    return env


@pytest.mark.parametrize("hd", fwd_module.HEAD_DIMS)
def test_tf32_plan_is_the_sources_and_fits_a_block(hd):
    """The float32 forward's tiling at every head dim is the source's
    ``Tf32Tiling<hd>``, and its shared memory fits a block's 232,448 bytes
    (hd 256: Q's hi and lo halves and the 32-key ring, 199,680)."""
    w, plan = _tiling("flash_attention.cu", "Tf32Tiling", hd), tf32_plan(hd)
    assert (plan["split"], plan["threads"], plan["rows"], plan["keys"], plan["stage"],
            plan["ld"]) == (w["kSplit"], w["kThreads"], w["kBM"], w["kBN"], w["kStage"],
                            w["kLd"])
    assert plan["q_in_registers"] == w["kQRegs"]
    assert plan["smem_bytes"] == w["kSmem"] <= H100.vmem_bytes == 232_448
    if hd == 256:  # four groups of 8 keys, 8 warps, one block an SM
        assert (plan["split"], plan["keys"], plan["threads"], plan["smem_bytes"]) == (
            4, 8, 256, 199_680)


@pytest.mark.parametrize("hd", bwd_module.TF32_HEAD_DIMS)
def test_tf32_bwd_plan_is_the_sources_and_fits_a_block(hd):
    """The float32 backward's launch is the source's ``Tf32BwdTiling<hd>``:
    each pass's shared memory fits a block's 232,448 bytes and the blocks
    an SM its 228 KiB (1 KiB of it reserved a block); the schedule aims at
    two waves of those blocks."""
    w, plan = _tiling("flash_attention_bwd.cu", "Tf32BwdTiling", hd), tf32_bwd_plan(hd)
    assert (plan["split"], plan["cols"], plan["threads"], plan["blocks_per_sm"], plan["rows"],
            plan["dq_rows"], plan["dq_keys"], plan["ld"], plan["keys"]) == (
        w["kSplit"], w["kCols"], w["kThreads"], w["kBlocks"], w["kBR"], w["kBQ"], w["kBK"],
        w["kLd"], w["kKeys"])
    assert (plan["smem1"], plan["smem2"]) == (w["kSmem1"], w["kSmem2"])
    assert max(plan["smem1"], plan["smem2"]) <= H100.vmem_bytes
    assert plan["blocks_per_sm"] * (max(plan["smem1"], plan["smem2"]) + 1024) <= 228 * 1024
    assert target_blocks(hd, F32) == 2 * 132 * plan["blocks_per_sm"]
    # the 64-row stages of the schedule are walked as whole 32-row (16-row) stages
    assert bwd_module.TC_ROWS % plan["rows"] == 0 and plan["keys"] == bwd_module.TC_KEYS
    # 65,536 registers an SM hold the blocks' threads at 255 registers each
    assert plan["blocks_per_sm"] * plan["threads"] * 256 <= 65536
    if hd == 128:  # two warp groups, one block an SM
        assert (plan["smem1"], plan["smem2"], plan["blocks_per_sm"]) == (203_264, 202_752, 1)
        assert (plan["split"], plan["threads"]) == (2, 256)


def _dispatch(source, dtype_branch):
    """{hd: launcher} of a source's switch under ``dtype_branch``."""
    src = (CSRC / source).read_text()
    body = src[src.index(dtype_branch):]
    body = body[:body.index("}")]
    return {int(hd): fn for hd, fn in re.findall(r"case (\d+): err = (\w+)", body)}


def test_float32_takes_the_tensor_cores_forward_at_every_head_dim():
    assert _dispatch("flash_attention.cu", "if (dtype == 0) {") == {
        hd: "launch_tf32" for hd in (8, 16, 32, 64, 128, 256)}
    for hd in fwd_module.HEAD_DIMS:  # so every float32 input must be 16-byte aligned
        q = torch.zeros((1, 8, 4, hd))
        kv = torch.zeros((1, 8, 2, hd))
        shifted = torch.zeros(8 * 2 * hd + 1)[1:].view(1, 8, 2, hd)
        check_route(q, kv, kv)
        with pytest.raises(ValueError, match="16-byte"):
            check_route(q, shifted, kv)


def test_float32_takes_the_tensor_cores_backward_at_hd_8_to_128():
    """float32 takes the split-TF32 backward at every head dim (hd 256
    too, since its column-split kernels), bf16 at hd 8, 16, 32 as well; so
    every input must be 16-byte aligned."""
    assert _dispatch("flash_attention_bwd.cu", "if (dtype == 0) {") == {
        hd: "launch_tf32" for hd in (8, 16, 32, 64, 128, 256)}
    for hd in bwd_module.HEAD_DIMS:
        assert route(F32, hd) == "tf32"
        assert route(torch.bfloat16, hd) == ("wgmma" if hd >= 64 else "tf32")
        q = torch.zeros((1, 8, 4, hd))
        kv = torch.zeros((1, 8, 2, hd))
        shifted = torch.zeros(8 * 4 * hd + 1)[1:].view(1, 8, 4, hd)
        with pytest.raises(ValueError, match="16-byte"):
            check_tc_route(q, kv, kv, q, shifted)


@pytest.mark.parametrize("shape", [(512, 7, True, 0, 2), (1024, 7, True, 0, 2),
                                   (512, 4, True, 0, 4), (333, 2, True, 64, 3)])
def test_float32_schedule_covers_each_walk_and_aims_at_its_blocks(shape):
    """The float32 route's schedule (phase 9 (b), 18 (b) and 19 (c)'s
    shapes and a window): each key tile's segments are contiguous, cover
    the rows that see it, start on 64-row stages, are the fewest of at most
    ``seg`` stages, and are the same at any kv_blocks."""
    S, G, causal, window, kv_blocks = shape
    items, tiles, slots = dkdv_schedule(S, S, G, causal, window, kv_blocks, 64, F32)
    assert (items, tiles, slots) == dkdv_schedule(S, S, G, causal, window, kv_blocks, 64, F32)
    for j in range(-(-S // 64)):
        segs = sorted(it for it in items if it[0] == j)
        assert all(a[2] == b[1] for a, b in zip(segs, segs[1:]))
        assert all((lo - segs[0][1]) % 64 == 0 for _, lo, _, _ in segs)
        q = np.arange(S)[:, None]
        keys = np.arange(j * 64, min(S, j * 64 + 64))[None]
        seen = (keys <= q) & ((q - keys < window) if window else True)
        rows = np.flatnonzero(seen.any(1))
        assert segs[0][1] <= rows.min() * G < segs[0][1] + 64
        assert segs[-1][2] == rows.max() * G + G
    # segments of at most ``seg`` 64-row stages, seg the float32 route's
    # shortest or what makes one copy about a wave of its blocks; the cuts
    # do not depend on kv_blocks (a mesh rank's local call cuts a kv head's
    # walk as one device does, so their float32 sums agree bit for bit)
    stages = sum(-(-(hi - lo) // 64) for _, lo, hi, _ in items)
    seg = max(bwd_module.TF32_MIN_SEGMENT, -(-stages * bwd_module.TARGET_WAVES
                                           // target_blocks(64, F32)))
    for other in (1, 2 * kv_blocks, 64):
        assert dkdv_schedule(S, S, G, causal, window, other, 64, F32) == (items, tiles, slots)
    assert max(-(-(hi - lo) // 64) for _, lo, hi, _ in items) <= seg
    for j in range(-(-S // 64)):
        walk = sum(-(-(hi - lo) // 64) for jj, lo, hi, _ in items if jj == j)
        assert sum(it[0] == j for it in items) == max(1, -(-walk // seg))


def test_traced_float32_backward_holds_its_workspace(monkeypatch):
    """The trace route (the production dry run's) allocates the float32
    tensor-core route's dK/dV workspace from the float32 schedule, at hd 64
    and at hd 256 (its split-TF32 route since the column-split kernels)."""
    seen = []
    real = ktrace.workspace_numel
    monkeypatch.setattr(ktrace, "workspace_numel", lambda *a: seen.append(a) or real(*a))
    B, S, K = 1, 1024, 2
    for hd in (64, 256):
        q, k, v = (torch.randn(B, S, n, hd, requires_grad=True) for n in (14, K, K))
        counts = TraceCounts()
        with counts.counting(), torch.enable_grad():
            pos = torch.arange(S, dtype=torch.int32)[None]
            o = ktrace.sdpa_trace(q, k, v, pos, pos, 0, True, None, "prefill")
            torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        assert counts.kernel_calls["flash_attention_bwd"] == 1
    want = [(dkdv_schedule(S, S, 7, True, 0, B * K, hd, F32)[2], B * K, hd) for hd in (64, 256)]
    assert all(slots > 0 for slots, _, _ in want) and seen == want
