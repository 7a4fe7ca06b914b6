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
float32 or bfloat16 (hd 64 and 128 in bfloat16 on the tensor cores, where
q, k, v, o and do must lie on a 16-byte boundary).

On the tensor-core route (Hopper's warpgroup products, wgmma) the dK/dV
pass is balanced over the causal rows:
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
TC_HEAD_DIMS = (64, 128)
#: the tensor-core dK/dV pass's tiles (``kKeys`` and ``WgTiling::kBM`` in the
#: source): keys a block, folded query rows a ring stage
TC_KEYS = 64
TC_ROWS = 64
#: dK/dV blocks the schedule aims at: two waves of an H100's 132 SMs at 3
#: blocks an SM (more segments balance better but add partial sums to merge)
TARGET_BLOCKS = 2 * 132 * 3
#: ring stages of the shortest segment (a key tile's last may be shorter)
MIN_SEGMENT = 8
_schedules: dict = {}


def dkdv_schedule(Sq, Sk, G, causal, window, kv_blocks):
    """The tensor-core dK/dV pass's work, cut into segments of about equal
    length. Key tile j (keys 64j..64j+63 of one KV head of one batch row)
    walks the folded query rows r = q * G + g from its causal frontier to
    its window edge, in ring stages of ``TC_ROWS`` rows. A walk longer
    than ``seg`` stages is cut into the fewest segments of at most ``seg``
    stages, whose lengths differ by at most a stage, with ``seg`` chosen so
    that the ``kv_blocks`` (= B * K) copies of the schedule make about
    ``TARGET_BLOCKS`` blocks.

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
    seg = max(MIN_SEGMENT, -(-stages * kv_blocks // TARGET_BLOCKS))
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
    """``(schedule, n_items, n_tiles, slots)``: dkdv_schedule(*shape) on
    ``device`` as one int32 tensor (the items' rows, then the tiles'), kept
    per device and shape, with its counts."""
    key = (device, *shape)
    got = _schedules.get(key)
    if got is None:
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
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)  # rowsum(do * o)
    sched, n_items, n_tiles, work = None, 0, 0, None
    if q.dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:  # the tensor-core route
        sched, n_items, n_tiles, slots = cached_schedule(q.device, Sq, Sk, H // K, bool(causal),
                                                         int(window or 0), B * K)
        work = torch.empty(workspace_numel(slots, B * K, hd), dtype=torch.float32,
                           device=q.device)
    fn = _build.load("flash_attention_bwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            None if work is None or not work.numel() else work.data_ptr(),
            None if sched is None else sched.data_ptr(), n_items, n_tiles,
            B, Sq, Sk, H, K, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.count_launch(flash_attention_bwd, sq_ne_sk=Sq != Sk)
    _build.raise_on_error("flash_attention_bwd", rc)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_sq_ne_sk = 0
