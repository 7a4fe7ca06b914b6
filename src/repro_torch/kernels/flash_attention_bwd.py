"""Flash attention backward: the wrapper of ``csrc/flash_attention_bwd.cu``.

The reference has no backward kernel (its ``repro/kernels/ops.py::_fa_bwd``
reruns the jnp oracle under ``jax.vjp``). This is the FlashAttention-2
backward (arXiv 2307.08691, Alg. 2) of ``flash_attention``: from q, k, v,
the forward's output o and its log-sum-exp lse (B,H,Sq) float32, and the
output's gradient do, it recomputes the probabilities tile by tile and
returns (dq, dk, dv) in q's type. Causal / window / softcap and the GQA
fold as the forward, at any Sq and Sk with the forward's positions
arange(Sq) and arange(Sk) (causal aligned at the top left: seamless's
cross-attention trains non-causal at Sq != Sk); a key that no query sees
(causal, past Sq - 1) gets dK = dV = 0. hd in {8, 16, 32, 64, 128, 256};
float32 or bfloat16. Every route runs on the tensor cores, where q, k, v, o
and do must lie on a 16-byte boundary (``ValueError`` if not): bfloat16 at
hd 64, 128 and 256 on Hopper's warpgroup products (wgmma; ``tc_plan``), and
float32 at every head dim and bfloat16 at hd 8, 16 and 32 in split-TF32
(``mma.sync`` tf32, each operand split into a tf32 hi and lo half, each
product lo·hi + hi·lo + hi·hi; a bf16 operand has no lo half; at hd 256
two warp groups a block split the columns of dK, dV and dQ;
``tf32_bwd_plan``; its algorithm step by step:
``ref.flash_attention_bwd_split_ref``). ``route`` names the route.

On both routes the dK/dV pass is balanced over the causal rows:
``dkdv_schedule`` cuts each key tile's walk over the folded query rows into
segments of about equal length, one block each. This module keeps the
schedule on the device per shape and allocates, per call, the float32
workspace in which the segments of a cut tile leave their sums; the
kernel's merge adds them in segment order. Deterministic: no atomics, and
the cuts and the order of every sum depend on the shape alone, so two calls
on the same inputs give the same bits.

On a CPU tensor the wrapper computes the plain version
(``ref.flash_attention_bwd_ref``); on a CUDA tensor it launches the kernels
or raises. ``flash_attention_bwd.launches`` counts the calls that launch,
``flash_attention_bwd.launches_sq_ne_sk`` those of them at Sq != Sk.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_bwd_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

#: head dims of the tensor-core route (bfloat16)
TC_HEAD_DIMS = (64, 128, 256)
#: head dims of the split-TF32 tensor-core route: float32 at all of them,
#: bfloat16 at those below the wgmma route's
TF32_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: the tensor-core dK/dV pass's tiles (``kKeys`` and ``WgTiling::kBM`` in the
#: source): keys a block, folded query rows a ring stage
TC_KEYS = 64
TC_ROWS = 64
#: the tensor-core route's blocks an SM by head dim (``WgTiling::kBlocks``:
#: registers at hd 64 and 128, shared memory at hd 256) and warpgroups a
#: block (``WgTiling::kNW``: two at hd 256, each with half the columns)
TC_BLOCKS_PER_SM = {64: 3, 128: 2, 256: 1}
TC_WARPGROUPS = {64: 1, 128: 1, 256: 2}
#: the split-TF32 route (``Tf32BwdTiling`` in the source) by head dim:
#: threads of a warp group (4 warps, 16 keys or rows each), warp groups
#: that share a stage (two at hd 128, each with half of a stage's rows or
#: keys) and that split the columns of dK, dV and dQ (two at hd 256, one
#: computing S, the other dP), folded rows a ring stage of the dK/dV pass,
#: folded rows a dQ block, keys a ring stage of the dQ pass, and blocks an
#: SM (shared memory: one block at hd 128 and 256)
TF32_THREADS = 128
TF32_SPLIT = {8: 1, 16: 1, 32: 1, 64: 1, 128: 2, 256: 1}
TF32_COLS = {8: 1, 16: 1, 32: 1, 64: 1, 128: 1, 256: 2}
TF32_STAGE_ROWS = {8: 32, 16: 32, 32: 32, 64: 32, 128: 32, 256: 16}
TF32_DQ_ROWS = 64
TF32_DQ_KEYS = {8: 32, 16: 32, 32: 32, 64: 32, 128: 32, 256: 16}
TF32_BLOCKS_PER_SM = {8: 2, 16: 2, 32: 2, 64: 2, 128: 1, 256: 1}
#: SMs of an H100, and the waves of them the dK/dV schedule aims at
SMS = 132
TARGET_WAVES = 2
#: 64-row stages of the shortest segment (a key tile's last may be
#: shorter), by route: the float32 route's blocks walk a stage slower, so
#: its walks are cut finer; finest (one stage) on bf16 inputs at hd 8-32,
#: whose stages cost a global load's round trip each, not products
#: (``min_segment``)
MIN_SEGMENT = 8
TF32_MIN_SEGMENT = 2
_schedules: dict = {}


def route(dtype, hd):
    """The backward's route for ``dtype`` at head dim ``hd``: "wgmma"
    (bfloat16 at ``TC_HEAD_DIMS``) or "tf32" (float32 at every head dim,
    bfloat16 at hd 8, 16 and 32)."""
    return "wgmma" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "tf32"


def min_segment(hd=64, dtype=torch.bfloat16):
    """64-row stages of the shortest dK/dV segment on the route of
    ``dtype`` at head dim ``hd``: ``MIN_SEGMENT`` (wgmma),
    ``TF32_MIN_SEGMENT`` (float32), 1 (bf16 on the split-TF32 route)."""
    if route(dtype, hd) == "wgmma":
        return MIN_SEGMENT
    return TF32_MIN_SEGMENT if dtype == torch.float32 else 1


def target_blocks(hd=64, dtype=torch.bfloat16):
    """dK/dV blocks the schedule aims at for the route of ``dtype`` at head
    dim ``hd``: ``TARGET_WAVES`` waves of the card's SMs at the route's
    blocks an SM (more segments balance better but add partial sums to
    merge)."""
    per_sm = {"wgmma": TC_BLOCKS_PER_SM, "tf32": TF32_BLOCKS_PER_SM}[route(dtype, hd)][hd]
    return TARGET_WAVES * SMS * per_sm


def tc_plan(hd):
    """The tensor-core route's launch at head dim ``hd``, as the source's
    ``WgTiling`` lays it out: ``warpgroups`` and ``threads`` a block,
    ``blocks_per_sm``, and the shared memory of the dK/dV pass
    (``smem1``: the Q and dO rings of two 64-row tiles, the K and V tiles,
    the rows' lse and D, and at two warpgroups their exchange: each one's
    half of its 64 x 32 float32 product, S^T or dP^T, then of the bf16 P^T
    and dS^T it formed) and of the dQ pass (``smem2``: the K and V rings,
    the Q and dO tiles, the exchange of halves of the 64 x 64 S or dP and of
    the bf16 dS), each with 1024 bytes for aligning the tiles by hand."""
    if hd not in TC_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the tensor-core route takes head_dim "
                         f"{TC_HEAD_DIMS}, not {hd}")
    tile = TC_ROWS * hd * 2  # a 64-row bf16 tile
    nw = TC_WARPGROUPS[hd]
    return {"warpgroups": nw, "threads": 128 * nw, "blocks_per_sm": TC_BLOCKS_PER_SM[hd],
            "smem1": 1024 + 6 * tile + 4 * TC_ROWS * 4 + (nw - 1) * 2 * (64 * 32 // 2) * (4 + 4),
            "smem2": 1024 + 6 * tile + (nw - 1) * 2 * (64 * 64 // 2) * (4 + 2)}


def tf32_bwd_plan(hd):
    """The split-TF32 route's launch at head dim ``hd``, as the source's
    ``Tf32BwdTiling`` lays it out: ``split`` (warp groups that share a
    stage, each with half its rows or keys), ``cols`` (warp groups that
    split the columns of dK and dV, dQ: two at hd 256, where a warp's 16
    keys x 256 columns of dK and dV would take 256 registers a thread),
    ``threads`` a block (4 warps a group), ``blocks_per_sm``, the dK/dV
    pass's ``keys`` a block (16 a warp) and ``rows`` a ring stage, the dQ
    pass's ``dq_rows`` a block (16 a warp) and ``dq_keys`` a ring stage,
    ``ld`` (a shared row's floats, hd + 4), ``pre_split`` (the rings' B
    operands split once a stage in place, as a tf32 hi and lo half; at two
    column groups stored once in float32 and split as read), and the
    shared memory of the dK/dV pass (``smem1``: K and V of the block's
    keys, two ring stages of Q and dO, the stages' lse and D, the column
    groups' exchange of S^T and dP^T) and of the dQ pass (``smem2``: Q and
    dO of the block's rows, two ring stages of K and V, the exchange of S
    and dP). bf16 inputs (hd 8, 16, 32) take the float32 plan: they are
    widened to float32 in shared memory."""
    if hd not in TF32_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the split-TF32 route takes head_dim "
                         f"{TF32_HEAD_DIMS}, not {hd}")
    ld, cols, rows, dq_keys = hd + 4, TF32_COLS[hd], TF32_STAGE_ROWS[hd], TF32_DQ_KEYS[hd]
    halves = 2 if cols == 1 else 1
    xch1, xch2 = (cols - 1) * 2 * 4 * 16 * rows, (cols - 1) * 2 * 4 * 16 * dq_keys
    return {"split": TF32_SPLIT[hd], "cols": cols,
            "threads": TF32_THREADS * TF32_SPLIT[hd] * cols,
            "blocks_per_sm": TF32_BLOCKS_PER_SM[hd], "keys": TC_KEYS, "rows": rows,
            "dq_rows": TF32_DQ_ROWS, "dq_keys": dq_keys, "ld": ld, "pre_split": cols == 1,
            "smem1": (2 * TC_KEYS * ld + 2 * 2 * halves * rows * ld + 2 * 2 * rows + xch1) * 4,
            "smem2": (2 * TF32_DQ_ROWS * ld + 2 * 2 * halves * dq_keys * ld + xch2) * 4}


def check_tc_route(q, k, v, o, do):
    """Every route of the backward copies 16 bytes at a time: raise
    ValueError unless q, k, v, o and do start on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError(f"flash_attention_bwd: {q.dtype} at head_dim {q.shape[-1]} runs on the "
                         "tensor cores, which need q, k, v, o and do to start on a 16-byte "
                         "boundary")


def dkdv_schedule(Sq, Sk, G, causal, window, kv_blocks, hd=64, dtype=torch.bfloat16):
    """The tensor-core dK/dV pass's work (either route: the split-TF32 one
    walks each 64-row stage as stages of ``TF32_STAGE_ROWS[hd]``), cut into
    segments of about equal length. Key tile j (keys 64j..64j+63 of one KV
    head of one batch row) walks the folded query rows r = q * G + g from its
    causal frontier to its window edge, in ring stages of ``TC_ROWS`` rows. A
    walk longer than ``seg`` stages is cut into the fewest segments of at most
    ``seg`` stages, whose lengths differ by at most a stage, with ``seg``
    chosen so that the ``kv_blocks`` (= B * K) copies of the schedule make
    about ``target_blocks(hd, dtype)`` blocks; on the float32 route, so that
    one copy makes about one wave of them (``target_blocks / TARGET_WAVES``),
    whatever ``kv_blocks`` is.

    Returns ``(items, tiles, slots)``. ``items``: one (key tile, first row,
    end row, slot) per segment, longest first; slot -1 marks a tile's only
    segment, which writes dK and dV itself, and the segments of a cut tile
    take consecutive slots in row order. A tile whose walk is empty (causal
    at Sk > Sq: its keys lie past every query) is one segment of no rows,
    which writes its dK and dV as zeros. ``tiles``: one (key tile, first
    slot, segments, 0) per key tile (-1 and 1 for an uncut one); a cut
    tile's float32 partials are added in slot order. ``slots``: the
    workspace's slots. The cuts and the order of the sums depend on the
    shape alone, so two runs give the same bits."""
    BN, BM = TC_KEYS, TC_ROWS
    walks = []
    for j in range(-(-Sk // BN)):
        k_last = min(Sk, (j + 1) * BN) - 1
        begin = j * BN * G // BM * BM if causal else 0
        end = (min(Sq, k_last + window) if window > 0 else Sq) * G
        walks.append((begin, max(begin, end)))
    stages = sum(-(-(e - b) // BM) for b, e in walks)
    if route(dtype, hd) == "tf32":
        # one wave of the route's blocks a copy, whatever kv_blocks is: a
        # (batch row, kv head)'s cuts, and so its float32 sums, depend on its
        # own walk alone, the same bits however rows and heads are split
        # over ranks (a mesh's local call against one device's)
        seg = max(min_segment(hd, dtype), -(-stages * TARGET_WAVES // target_blocks(hd, dtype)))
    else:
        seg = max(min_segment(hd, dtype), -(-stages * kv_blocks // target_blocks(hd, dtype)))
    items, tiles, slots = [], [], 0
    for j, (b, e) in enumerate(walks):
        n_stages = -(-(e - b) // BM)
        n = max(1, -(-n_stages // seg))
        if n == 1:
            items.append((j, b, e, -1))
            tiles.append((j, -1, 1, 0))
            continue
        # n segments of n_stages // n or one more stages
        bounds = [b + i * n_stages // n * BM for i in range(n)] + [e]
        tiles.append((j, slots, n, 0))
        items += [(j, lo, hi, slots + i) for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
        slots += n
    items.sort(key=lambda it: (it[1] - it[2], it[0], it[1]))
    return items, tiles, slots


def cached_schedule(device, *shape):
    """``(schedule, n_items, n_tiles, slots)``: dkdv_schedule(*shape)
    (Sq, Sk, G, causal, window, kv_blocks, hd[, dtype]) on ``device`` as one
    int32 tensor (the items' rows, then the tiles'), kept
    per device and shape, with its counts. None is made inside a CUDA graph
    capture, which refuses the copy from the host: raises there."""
    key = (device, *shape)
    got = _schedules.get(key)
    if got is None:
        if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"flash_attention_bwd: schedule {shape} needed inside a CUDA "
                               f"graph capture; run the step once eagerly first")
        items, tiles, slots = dkdv_schedule(*shape)
        got = (torch.tensor(items + tiles, dtype=torch.int32, device=device), len(items),
               len(tiles), slots)
        _schedules[key] = got
    return got


def workspace_numel(slots, kv_blocks, hd):
    """float32 elements of the dK/dV pass's workspace: a ``TC_KEYS`` x
    ``hd`` partial dK and dV for each slot of each of ``kv_blocks`` (= B * K)
    copies of the schedule."""
    return slots * kv_blocks * 2 * TC_KEYS * hd


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=0, softcap=0.0):
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window,
                                       softcap=softcap)
    _build.refuse_fake("flash_attention_bwd", q, k, v, o, do, lse)
    _build.refuse_grad("flash_attention_bwd", q, k, v, o, do, lse)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if (k.shape != (B, Sk, K, hd) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (B, H, Sq) or H % K):
        raise ValueError(
            f"flash_attention_bwd: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"o {tuple(o.shape)} do {tuple(do.shape)} lse {tuple(lse.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {hd} not in {HEAD_DIMS}")
    _build.check_cuda_inputs("flash_attention_bwd", q.dtype, q, k, v, o, do)
    _build.check_cuda_inputs("flash_attention_bwd", torch.float32, lse)
    if lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse on {lse.device}, q on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    check_tc_route(q, k, v, o, do)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)  # rowsum(do * o)
    sched, n_items, n_tiles, slots = cached_schedule(q.device, Sq, Sk, H // K, bool(causal),
                                                     int(window or 0), B * K, hd, q.dtype)
    work = torch.empty(workspace_numel(slots, B * K, hd), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_bwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            work.data_ptr() if work.numel() else None, sched.data_ptr(), n_items, n_tiles,
            B, Sq, Sk, H, K, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            stream,
        )
        _build.count_launch(flash_attention_bwd, sq_ne_sk=Sq != Sk, stream=stream)
    _build.raise_on_error("flash_attention_bwd", rc)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_sq_ne_sk = 0
