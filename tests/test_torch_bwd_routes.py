"""The flash backward's last two routes moved onto the tensor cores, on the
CPU: float32 at head dim 256 (gemma2-2b's float32 gradient) and bf16 at hd
8, 16 and 32 (the reduced configs' training), both on the split-TF32
kernels (``dkdv_tf32_kernel``, ``dkdv_merge_kernel<T>``, ``dq_tf32_kernel``
in csrc/flash_attention_bwd.cu).

* ``ref.flash_attention_bwd_split_ref`` (those kernels' algorithm step by
  step; its float32 cases, hd 256 among them, are tests/test_torch_f32_tc.py's)
  on bf16 inputs at hd 8, 16 and 32, against the float32 plain version on
  the same (bf16) values and against the reference's custom VJP of
  ``flash_attention_diff`` (``repro.kernels.ops._fa_bwd``: ``jax.vjp`` of
  its oracle; the Pallas forward takes only whole 128-row blocks, so the
  backward is called on its own);
* ``tf32_bwd_plan(256)`` against the source's ``Tf32BwdTiling<256>`` and a
  block's 232,448 bytes; the route table, which no longer names the CUDA
  cores, and the source, which no longer holds the CUDA-core kernels;
* the dK/dV schedule and workspace at float32 hd 256 and bf16 hd 8, and the
  trace route (the production dry run's) holding bf16's workspace.

Inputs come from seeded numpy generators. Tolerances, each over the
gradient's scale (max |want|): the bf16 split plain version, rounded once
to bf16, against the
float32 plain version 2^-8 (a bf16 value's rounding is at most 2^-8 of a
value below the scale) plus float32's 1e-4; against the reference's VJP,
which recomputes its own float32 output where the port's path carries the
forward's bf16 output into D = rowsum(dO O), 2e-2 (chip_smoke.py's bf16
bound for the backward).
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
from repro_torch.kernels import flash_attention_bwd as bwd_module
from repro_torch.kernels import trace as ktrace
from repro_torch.kernels.flash_attention_bwd import (HEAD_DIMS, dkdv_schedule, route,
                                                     target_blocks, tf32_bwd_plan,
                                                     workspace_numel)
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_bwd_split_ref,
                                     flash_attention_lse_ref)
from repro_torch.perf.hw import H100
from repro_torch.perf.trace import TraceCounts

# one intra-op thread: the suite runs in parallel workers beside tests that
# time wall-clock stage walls (tests/test_live.py)
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
TOL = 1e-4
BF16_VS_F32_TOL = 2.0 ** -8 + TOL
BF16_VS_REF_TOL = 2e-2
CSRC = Path(bwd_module.__file__).parents[1] / "csrc"

# B, Sq, Sk, H, K, hd, causal, window, softcap: the reduced configs' heads
BF16_CASES = {
    "hd8_g7": (4, 32, 32, 7, 1, 8, True, 0, 0.0),  # the reduced qwen2-0.5b
    "hd8_g7_ragged_cut": (1, 300, 300, 7, 1, 8, True, 0, 0.0),
    "hd16_window_softcap": (1, 100, 100, 4, 2, 16, True, 8, 50.0),
    "hd16_sq_gt_sk": (2, 90, 40, 4, 2, 16, True, 0, 0.0),
    "hd32_window_softcap30": (1, 150, 150, 4, 2, 32, True, 40, 30.0),
    "hd32_cross": (2, 40, 100, 4, 4, 32, False, 0, 0.0),
}


@functools.partial(jax.jit, static_argnames=("causal", "window", "softcap"))
def _jax_fa_bwd(q, k, v, g, causal, window, softcap):
    """The reference's custom VJP of ``flash_attention_diff``: jax.vjp of its
    jnp oracle (``repro.kernels.ops._fa_bwd``)."""
    return jax_ops._fa_bwd(causal, window, softcap, (q, k, v), g)


def _inputs(B, Sq, Sk, H, K, hd, seed, dtype=F32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd))]


def _grad_close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max abs err {err} beyond {tol} x {scale}"


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_split_ref_matches_float32_plain_and_the_reference_vjp(name):
    """bf16 inputs through the split-TF32 algorithm (their lo halves 0, so
    S and dP take one tf32 product, dV, dK, dQ two): the gradients, in bf16,
    against the float32 plain version on the same bf16 values and the
    forward's bf16 output, and against the reference's VJP of those
    values."""
    B, Sq, Sk, H, K, hd, causal, win, cap = BF16_CASES[name]
    q, k, v, g = _inputs(B, Sq, Sk, H, K, hd, 5, BF16)
    kw = dict(causal=causal, window=win, softcap=cap)
    o, lse = flash_attention_lse_ref(q, k, v, **kw)
    assert o.dtype == BF16 and route(BF16, hd) == "tf32"
    got = flash_attention_bwd_split_ref(q, k, v, o, g, lse, **kw)
    f32 = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), g.float(), lse,
                                  **kw)
    ref = _jax_fa_bwd(*(jnp.asarray(_np(t)) for t in (q, k, v, g)), causal, win, cap)
    for n, a, b, w, x in zip("qkv", got, f32, ref, (q, k, v)):
        assert a.dtype == BF16 and a.shape == x.shape
        _grad_close(_np(a), _np(b), BF16_VS_F32_TOL, f"{name} d{n} vs float32 plain")
        _grad_close(_np(a), np.asarray(w), BF16_VS_REF_TOL, f"{name} d{n} vs jax")


def test_bf16_split_ref_is_the_float32_one_rounded_once():
    """On bf16 values the split-TF32 algorithm's float32 sums are those of
    its float32 run on the same values (a zero lo half adds nothing): the
    bf16 gradients are the float32 ones rounded once."""
    q, k, v, g = _inputs(2, 37, 37, 7, 1, 8, 11, BF16)
    o, lse = flash_attention_lse_ref(q, k, v)
    got = flash_attention_bwd_split_ref(q, k, v, o, g, lse)
    wide = flash_attention_bwd_split_ref(q.float(), k.float(), v.float(), o.float(), g.float(),
                                         lse)
    for a, b in zip(got, wide):
        assert torch.equal(a, b.to(BF16))


def _tiling(hd):
    """``Tf32BwdTiling<hd>``'s constants, evaluated in order from the source."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    env = {"HD": hd, "kKeys": int(re.search(r"\nconstexpr int kKeys = (\d+);", src).group(1))}
    body = re.search(r"struct Tf32BwdTiling \{(.*?)\n\};", src, re.S).group(1)
    for line in body.splitlines():
        m = re.search(r"static constexpr (?:int|bool) (k\w+) = ([^;]+);", line.split("//")[0])
        if m:
            expr = re.sub(r"(\S[^?]*?) \? (\S+) : (\S+)$", r"(\2 if \1 else \3)", m.group(2))
            env[m.group(1)] = eval(expr.replace("/", "//"), {}, env)
    return env, body


def test_tf32_bwd_plan_at_hd_256_splits_the_columns():
    """At hd 256 two warp groups split the columns of dK, dV and dQ (128
    accumulator registers a thread), the rings hold Q and dO (K and V) once
    in float32 in 16-row (16-key) stages: 208,128 and 207,872 bytes of the
    232,448 a block may use, one block an SM. The plan is the source's, and
    the source asserts both facts."""
    w, body = _tiling(256)
    plan = tf32_bwd_plan(256)
    assert (plan["cols"], plan["split"], plan["threads"], plan["blocks_per_sm"]) == (
        w["kCols"], w["kSplit"], w["kThreads"], w["kBlocks"]) == (2, 1, 256, 1)
    assert (plan["rows"], plan["dq_rows"], plan["dq_keys"], plan["ld"], plan["keys"]) == (
        w["kBR"], w["kBQ"], w["kBK"], w["kLd"], w["kKeys"]) == (16, 64, 16, 260, 64)
    assert plan["pre_split"] is w["kPreSplit"] is False
    assert (plan["smem1"], plan["smem2"]) == (w["kSmem1"], w["kSmem2"]) == (208_128, 207_872)
    assert max(plan["smem1"], plan["smem2"]) <= H100.vmem_bytes == 232_448
    assert "static_assert(kSmem1 <= 232448 && kSmem2 <= 232448" in body
    assert "static_assert(2 * (HD / kCols) / 8 * 4 <= 128" in body
    # without the column split: K and V at ld 260 and a hi + lo ring of
    # 16-row stages (133,120 + 133,120) would not fit
    assert (2 * 64 * 260 + 2 * 4 * 16 * 260) * 4 > H100.vmem_bytes
    assert target_blocks(256, F32) == 264


def test_every_route_is_on_the_tensor_cores():
    """``route`` names the wgmma route (bf16 at hd 64, 128, 256) or the
    split-TF32 route (float32 at every head dim, bf16 at hd 8, 16, 32), and
    the source dispatches so; the CUDA-core backward is gone from it."""
    for hd in HEAD_DIMS:
        assert route(F32, hd) == "tf32"
        assert route(BF16, hd) == ("tf32" if hd in (8, 16, 32) else "wgmma")
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    for gone in ("dkdv_kernel<", "dq_kernel<", "struct Tiling", "dispatch<", "launch<T"):
        assert gone not in src
    bf16 = src[src.index("} else if (dtype == 1) {") + 1:]
    bf16 = bf16[:bf16.index("}")]
    assert dict(re.findall(r"case (\d+): err = (\w+)<?(?:bf16, )?", bf16)) == {
        "8": "launch_tf32", "16": "launch_tf32", "32": "launch_tf32", "64": "launch_tc",
        "128": "launch_tc", "256": "launch_tc"}


@pytest.mark.parametrize("shape", [(333, 1, 2, True, 0, 4), (2048, 4, 2, True, 0, 4),
                                   (2048, 4, 2, True, 4096, 4), (333, 1, 2, True, 128, 4)])
def test_hd256_float32_schedule_and_workspace(shape):
    """gemma2-2b's float32 backward, served (1 x 333) and at the training
    shape (4 x 2048), global and local: each key tile's segments cover its
    walk in 64-row stages, one copy of the schedule makes about one wave of
    the route's blocks (one an SM) whatever B x K is, and the workspace holds
    a 64 x 256 float32 dK and dV a slot a copy."""
    S, B, G, causal, window, K = shape
    items, tiles, slots = dkdv_schedule(S, S, G, causal, window, B * K, 256, F32)
    assert dkdv_schedule(S, S, G, causal, window, 1, 256, F32) == (items, tiles, slots)
    for j in range(-(-S // 64)):
        segs = sorted(it for it in items if it[0] == j)
        assert all(a[2] == b[1] for a, b in zip(segs, segs[1:]))
        assert all((lo - segs[0][1]) % 64 == 0 for _, lo, _, _ in segs)
        assert segs[-1][2] == (min(S, j * 64 + 64 - 1 + window) if window else S) * G
        assert (len(segs) == 1) == (segs[0][3] == -1)
    stages = sum(-(-(hi - lo) // 64) for _, lo, hi, _ in items)
    seg = max(bwd_module.min_segment(256, F32), -(-stages * 2 // target_blocks(256, F32)))
    assert bwd_module.min_segment(256, F32) == bwd_module.TF32_MIN_SEGMENT == 2
    assert max(-(-(hi - lo) // 64) for _, lo, hi, _ in items) <= seg
    assert workspace_numel(slots, B * K, 256) == slots * B * K * 2 * 64 * 256
    if (S, B, window) == (333, 1, 0):  # gemma2's served shape: 84 dK/dV blocks
        assert len(items) * B * K == 84 and slots > 0


def test_bf16_small_head_dims_cut_their_walks_a_stage_at_a_time():
    """bf16 at hd 8 (the reduced qwen2-0.5b's q (4,32,7,8)) takes the
    split-TF32 route's schedule with one-stage segments (its stages cost a
    load's round trip, not products): the 224-row walk in 4 segments of at
    most 64 rows a copy, 16 dK/dV blocks, where the CUDA-core route had 4
    blocks in all and float32 cuts 2 segments. Independent of B x K, as
    float32's."""
    items, tiles, slots = dkdv_schedule(32, 32, 7, True, 0, 4, 8, BF16)
    assert (items, tiles, slots) == dkdv_schedule(32, 32, 7, True, 0, 1, 8, BF16)
    assert bwd_module.min_segment(8, BF16) == 1 and bwd_module.min_segment(8, F32) == 2
    assert len(items) * 4 == 16 and tiles == [(0, 0, 4, 0)] and slots == 4
    assert sorted((lo, hi) for _, lo, hi, _ in items) == [(0, 64), (64, 128), (128, 192),
                                                          (192, 224)]
    assert len(dkdv_schedule(32, 32, 7, True, 0, 4, 8, F32)[0]) == 2
    assert workspace_numel(slots, 4, 8) == 4 * 4 * 2 * 64 * 8


@pytest.mark.parametrize("hd", (8, 16, 32))
def test_traced_bf16_backward_holds_its_workspace(monkeypatch, hd):
    """The trace route (the production dry run's) allocates the dK/dV
    workspace of the split-TF32 schedule for bf16 at hd 8, 16, 32 (float32
    at hd 64 and 256: tests/test_torch_f32_tc.py)."""
    dtype = BF16
    seen = []
    real = ktrace.workspace_numel
    monkeypatch.setattr(ktrace, "workspace_numel", lambda *a: seen.append(a) or real(*a))
    B, S, H, K = 1, 1024, 8, 4
    q, k, v = (torch.randn(B, S, n, hd, dtype=dtype, requires_grad=True) for n in (H, K, K))
    counts = TraceCounts()
    with counts.counting(), torch.enable_grad():
        pos = torch.arange(S, dtype=torch.int32)[None]
        o = ktrace.sdpa_trace(q, k, v, pos, pos, 0, True, None, "prefill")
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    assert counts.kernel_calls["flash_attention_bwd"] == 1
    _, _, slots = dkdv_schedule(S, S, H // K, True, 0, B * K, hd, dtype)
    assert slots > 0 and seen == [(slots, B * K, hd)]
