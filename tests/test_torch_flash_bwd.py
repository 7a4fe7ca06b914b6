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

The file also checks, exactly, the segment schedule of the tensor-core
dK/dV pass (``dkdv_schedule``), which the kernel takes as it is: every row
step of each key tile's walk once, in order, and a fixed merge order; at
Sq != Sk too, where a key tile that no query sees (causal, Sk > Sq) is one
empty segment, and the pass carried out segment by segment in float64
gives flash_attention_bwd_ref's dK and dV, zeros past the last query.
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

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.layers import causal_window_mask
from repro_torch.kernels import flash_attention_bwd as bwd_module
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
    (B,H,Sq) with h = kv_head * G + g (the math of repro.models.layers._sdpa_dense),
    at positions arange(Sq) and arange(Sk)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    s = jnp.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    qpos = jnp.broadcast_to(jnp.arange(Sq, dtype=jnp.int32)[None], (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk, dtype=jnp.int32)[None], (B, Sk))
    mask = causal_window_mask(qpos, kpos, window if window else None, causal)
    s = jnp.where(mask[:, None, None], s, -1e30)  # the oracle's finite mask value
    return jax.nn.logsumexp(s, axis=-1).reshape(B, H, Sq)


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


# Sq != Sk: tests/test_torch_cuda.py's FLASH_XQ shapes (B, Sq, Sk, H, K, hd),
# each causal (aligned at the top left) and not
XQ_SHAPES = [(4, 200, 512, 16, 16, 64), (2, 512, 200, 4, 2, 64), (1, 37, 100, 4, 2, 16),
             (1, 100, 37, 4, 2, 16), (2, 129, 333, 8, 4, 128), (1, 333, 129, 8, 4, 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", XQ_SHAPES)
def test_bwd_ref_at_sq_ne_sk_matches_jax_vjp_of_the_oracle(shape, causal):
    """seamless's cross-attention shape and the rest of FLASH_XQ: from the
    JAX oracle's output and log-sum-exp at Sq != Sk, the FA2 backward gives
    jax.vjp's gradients (causal at Sk > Sq: keys past Sq - 1 get none)."""
    B, Sq, Sk, H, K, hd = shape
    rng = np.random.default_rng(Sq * 7 + Sk)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd)))
    out, want = _jax_oracle_vjp(q, k, v, g, causal, 0, 0.0)
    lse = _jax_lse(q, k, causal, 0, 0.0)
    got = flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(np.array(out)), torch.from_numpy(g),
                                  torch.from_numpy(np.array(lse)), causal=causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)
    if causal and Sk > Sq:
        assert not got[1][:, Sq:].any() and not got[2][:, Sq:].any()


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


def test_count_launch_counts_launches_at_sq_ne_sk_apart():
    """The flash wrappers count every launch on ``launches`` and those at
    Sq != Sk (the cross call site's) on ``launches_sq_ne_sk`` as well."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention

    for wrapper in (flash_attention, flash_attention_bwd):
        assert wrapper.launches_sq_ne_sk >= 0

    def counted():
        pass

    counted.launches = counted.launches_sq_ne_sk = 0
    for sq_ne_sk in (False, True, True, False, True):
        _build.count_launch(counted, sq_ne_sk=sq_ne_sk)
    _build.count_launch(counted)
    assert (counted.launches, counted.launches_sq_ne_sk) == (6, 3)


# The tensor-core dK/dV pass's segment schedule (kernels/flash_attention_bwd.py::
# dkdv_schedule): qwen2-0.5b's training shape, chip_smoke.py's FLASH_BWD_CASES
# shapes (S, G, causal, window, B * K) and the long cases of
# tests/test_torch_cuda.py.
TRAIN_SHAPE = (2048, 7, True, 0, 4 * 2)
SCHEDULE_SHAPES = [
    TRAIN_SHAPE,
    (333, 7, True, 0, 2),
    (37, 7, True, 0, 2),
    (256, 2, True, 64, 2),
    (200, 4, True, 0, 2),
    (256, 4, False, 0, 1),
    (129, 4, False, 48, 2),
    (333, 2, True, 4096, 4),
    (333, 2, True, 128, 4),
    (1024, 7, True, 0, 2 * 2),
    (777, 8, True, 200, 1),
    (512, 4, False, 0, 2 * 2),
]


def _walk_rows(S, G, causal, window, k0, k_end):
    """The folded rows r = q * G + g whose query q (of S) sees a key of [k0,
    k_end), by brute force over the mask."""
    q = np.arange(S)[:, None]
    keys = np.arange(k0, k_end)[None, :]
    seen = np.ones((S, k_end - k0), bool)
    if causal:
        seen &= keys <= q
    if window:
        seen &= q - keys < window
    rows = np.flatnonzero(seen.any(1))
    return (rows[:, None] * G + np.arange(G)[None]).ravel()


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_dkdv_schedule_covers_each_walk_once_in_order(shape):
    S, G, causal, window, kv_blocks = shape
    BN, BM = bwd_module.TC_KEYS, bwd_module.TC_ROWS
    items, tiles, slots = bwd_module.dkdv_schedule(S, S, G, causal, window, kv_blocks)
    assert (items, tiles, slots) == bwd_module.dkdv_schedule(S, S, G, causal, window, kv_blocks)
    n_tiles = -(-S // BN)
    assert [t[0] for t in tiles] == list(range(n_tiles))
    by_tile = {j: sorted(it for it in items if it[0] == j) for j in range(n_tiles)}
    assert sum(map(len, by_tile.values())) == len(items)
    merged = {t[0]: t for t in tiles if t[2] > 1}
    used = []
    for j, segs in by_tile.items():
        # contiguous, stage-aligned segments from the tile's first row
        begin, end = segs[0][1], segs[-1][2]
        assert all(a[2] == b[1] for a, b in zip(segs, segs[1:]))
        assert all((lo - begin) % BM == 0 and lo < hi for _, lo, hi, _ in segs)
        # the walk holds every row that sees a key of the tile, and no stage
        # of rows outside it: it starts in the stage of the first such row
        rows = _walk_rows(S, G, causal, window, j * BN, min(S, (j + 1) * BN))
        assert begin <= rows.min() < begin + BM and end == rows.max() + 1
        if len(segs) == 1:
            assert segs[0][3] == -1 and tiles[j] == (j, -1, 1, 0)
            continue
        # a cut tile: its segments' slots are consecutive in row order, and
        # its merge adds exactly them, first slot first
        _, first, n, _ = merged[j]
        assert n == len(segs) and [s[3] for s in segs] == list(range(first, first + n))
        used += range(first, first + n)
    assert sorted(used) == list(range(slots))
    assert [m[1] for m in merged.values()] == sorted(m[1] for m in merged.values())
    # longest first: the blocks of a wave take about the same time
    lengths = [hi - lo for _, lo, hi, _ in items]
    assert lengths == sorted(lengths, reverse=True)


def test_dkdv_schedule_balances_the_training_shape():
    """At qwen2-0.5b's training shape the pass makes at least two waves of
    3 blocks on each of an H100's 132 SMs. The first key tile alone walks
    224 stages of 64 rows, the last 7: no block walks a fifth of the first
    tile's, and a cut tile's segments are at least half the longest."""
    S, G, causal, window, kv_blocks = TRAIN_SHAPE
    items, tiles, _ = bwd_module.dkdv_schedule(S, S, G, causal, window, kv_blocks)
    assert len(items) * kv_blocks >= 2 * 132 * 3
    stages = [-(-(hi - lo) // 64) for _, lo, hi, _ in items]
    assert max(stages) < 224 // 5
    assert min(st for st, it in zip(stages, items) if it[3] >= 0) * 2 >= max(stages)
    assert any(t[2] > 1 for t in tiles)


def test_tc_tiling_constants_match_the_source():
    """The schedule's tile sizes are the kernels' (``kKeys`` and
    ``WgTiling::kBM``)."""
    src = (Path(bwd_module.__file__).parents[1] / "csrc" / "flash_attention_bwd.cu").read_text()
    assert re.search(r"constexpr int kKeys = (\d+);", src).group(1) == str(bwd_module.TC_KEYS)
    body = re.search(r"struct WgTiling \{(.*?)\n\};", src, re.S).group(1)
    assert int(re.search(r"kBM = (\d+);", body).group(1)) == bwd_module.TC_ROWS


# Sq != Sk: (Sq, Sk, G, causal, window, B * K); seamless's cross shapes
# (non-causal), causal at Sk > Sq (key tiles past Sq - 1 see no row) and at
# Sq > Sk, ragged, windowed
XQ_SCHEDULE_SHAPES = [
    (512, 768, 1, False, 0, 2 * 16),
    (200, 512, 1, False, 0, 4 * 16),
    (512, 768, 1, True, 0, 2 * 16),
    (100, 333, 2, True, 0, 2),
    (333, 129, 2, True, 0, 4),
    (768, 512, 7, True, 0, 2),
    (37, 200, 2, True, 16, 1),
    (300, 100, 4, False, 48, 2),
]


@pytest.mark.parametrize("shape", XQ_SCHEDULE_SHAPES)
def test_dkdv_schedule_at_sq_ne_sk_covers_each_walk_once(shape):
    """Every key tile has its segments: contiguous, stage-aligned, covering
    the rows that see a key of the tile; a tile that no row sees is one
    empty segment of slot -1 (its block writes zeros), never a tile left
    unwritten."""
    Sq, Sk, G, causal, window, kv_blocks = shape
    BN, BM = bwd_module.TC_KEYS, bwd_module.TC_ROWS
    items, tiles, slots = bwd_module.dkdv_schedule(Sq, Sk, G, causal, window, kv_blocks)
    n_tiles = -(-Sk // BN)
    assert [t[0] for t in tiles] == list(range(n_tiles))
    for j in range(n_tiles):
        segs = sorted(it for it in items if it[0] == j)
        rows = _walk_rows(Sq, G, causal, window, j * BN, min(Sk, (j + 1) * BN))
        if not rows.size:
            assert len(segs) == 1 and segs[0][1] == segs[0][2] and segs[0][3] == -1
            assert tiles[j] == (j, -1, 1, 0)
            continue
        begin, end = segs[0][1], segs[-1][2]
        assert all(a[2] == b[1] for a, b in zip(segs, segs[1:]))
        assert all((lo - begin) % BM == 0 and lo < hi for _, lo, hi, _ in segs)
        assert begin <= rows.min() < begin + BM and end == rows.max() + 1
        assert (len(segs) == 1) == (segs[0][3] == -1)
    assert sum(t[2] for t in tiles if t[2] > 1) == slots
    if causal and Sk > Sq:
        assert any(lo == hi for _, lo, hi, _ in items)


@pytest.mark.parametrize("shape", [(1, 100, 333, 4, 2, 64, True), (2, 333, 129, 4, 2, 64, True),
                                   (1, 200, 512, 4, 4, 64, False)])
def test_dkdv_pass_by_its_schedule_gives_the_plain_dk_dv(shape):
    """The tensor-core dK/dV pass carried out as the kernel does it, in
    float64: each segment sums dS^T Q and P^T dO over its rows for its key
    tile, a cut tile's partials are added in slot order. At Sq != Sk this
    equals flash_attention_bwd_ref's dK and dV (within 1e-5: the plain
    versions compute in float32; a row left out would miss by O(1)),
    exactly zero for keys past the last query under the causal mask."""
    B, Sq, Sk, H, K, hd, causal = shape
    G, BN = H // K, bwd_module.TC_KEYS
    gen = torch.Generator().manual_seed(Sq + Sk)
    q, do = (torch.randn((B, Sq, H, hd), generator=gen, dtype=torch.float64) for _ in range(2))
    k, v = (torch.randn((B, Sk, K, hd), generator=gen, dtype=torch.float64) for _ in range(2))
    o, lse = flash_attention_lse_ref(q, k, v, causal=causal)
    _, want_dk, want_dv = flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    # the folded rows r = q * G + g of each KV head, as the kernel walks them
    fold = lambda t: t.reshape(B, Sq, K, G, hd).permute(0, 2, 1, 3, 4).reshape(B, K, Sq * G, hd)
    qf, dof = fold(q), fold(do)
    lsef = lse.reshape(B, K, G, Sq).permute(0, 1, 3, 2).reshape(B, K, Sq * G)
    delta = (dof * fold(o)).sum(-1)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # (B, K, Sk, hd)
    qpos = torch.arange(Sq * G) // G
    items, tiles, _ = bwd_module.dkdv_schedule(Sq, Sk, G, causal, 0, B * K)
    parts = {}
    for j, lo, hi, slot in items:
        keys = torch.arange(j * BN, min(Sk, (j + 1) * BN))
        s = torch.einsum("bkrd,bknd->bkrn", qf[:, :, lo:hi], kf[:, :, keys]) / math.sqrt(hd)
        seen = (keys[None] <= qpos[lo:hi, None]) if causal else torch.ones(hi - lo, len(keys),
                                                                              dtype=torch.bool)
        p = torch.where(seen, torch.exp(s - lsef[:, :, lo:hi, None]), 0.0)
        dp = torch.einsum("bkrd,bknd->bkrn", dof[:, :, lo:hi], vf[:, :, keys])
        ds = p * (dp - delta[:, :, lo:hi, None])
        parts[(j, slot)] = (torch.einsum("bkrn,bkrd->bknd", ds, qf[:, :, lo:hi]) / math.sqrt(hd),
                            torch.einsum("bkrn,bkrd->bknd", p, dof[:, :, lo:hi]))
    got_dk, got_dv = torch.full_like(kf, float("nan")), torch.full_like(vf, float("nan"))
    for j, first, n, _ in tiles:
        slots = [-1] if n == 1 else range(first, first + n)
        dk, dv = parts[(j, slots[0])]
        for sl in list(slots)[1:]:
            dk, dv = dk + parts[(j, sl)][0], dv + parts[(j, sl)][1]
        got_dk[:, :, j * BN:(j + 1) * BN], got_dv[:, :, j * BN:(j + 1) * BN] = dk, dv
    for got, want in ((got_dk, want_dk), (got_dv, want_dv)):
        torch.testing.assert_close(got.permute(0, 2, 1, 3), want, atol=1e-5, rtol=1e-5)
    if causal and Sk > Sq:
        assert not got_dk[:, :, Sq:].any() and not got_dv[:, :, Sq:].any()
