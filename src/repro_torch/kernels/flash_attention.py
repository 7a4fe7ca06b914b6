"""Flash attention (prefill): the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
Causal / sliding-window / tanh-softcapped GQA attention of q (B,Sq,H,hd)
against k/v (B,Sk,K,hd) at implicit positions arange(Sq) and arange(Sk),
as the TPU kernel computes them: causal keeps key j for query i iff i >= j
(aligned at the top left), the window counts from the same positions, and
a tile past the frontier is skipped. Any Sq and Sk (the TPU kernel needs
multiples of 128): seamless's cross-attention runs non-causal at Sq != Sk;
hd in {8, 16, 32, 64, 128, 256}; float32 or bfloat16 in, out in q's type.
float32 at every head dim runs on the tensor cores in split-TF32
(``flash_tf32_kernel``; its algorithm step by step:
``ref.flash_attention_split_ref``; its tiling ``tf32_plan``), bfloat16 at hd
64, 128 and 256 on Hopper's warpgroup products (``flash_wg_kernel``: TMA loads
of K and V into mbarrier rings from a producer warpgroup, two consumer
warpgroups on wgmma; its shared memory, rings and TMA boxes are ``wg_plan``),
bfloat16 at hd 8, 16 and 32 on mma.sync (``flash_mma_kernel``: 64 folded rows
a block against 64-key tiles of a cp.async ring, P kept in registers as the A
operand of P V; its algorithm step by step: ``ref.flash_attention_mma_ref``;
its tiling ``mma_plan``). No route is left on the CUDA cores. Every route
copies 16 bytes at a time (TMA too needs 16-byte aligned tensors), so q, k and
v must start on a 16-byte boundary (a float32 view at an offset of a whole
number of 4 floats, a bfloat16 one of 8); the wrapper raises ``ValueError`` if
not (``check_route``, which also refuses shapes whose folded rows or blocks
overflow the bf16 kernels' 32-bit indices).

``flash_attention`` is the serving entry point; ``flash_attention_lse``
also returns the float32 log-sum-exp of each row, (B,H,Sq), which the
backward kernel (``flash_attention_bwd``) takes. Both launch the same
kernel and count on ``flash_attention.launches`` (those at Sq != Sk on
``flash_attention.launches_sq_ne_sk`` as well).

On a CPU tensor the wrappers compute the plain versions
(``ref.flash_attention_ref``, ``ref.flash_attention_lse_ref``); on a CUDA
tensor they launch the kernel or raise. They raise too for a CUDA input
that requires grad while grad mode is on, whose output would carry no
gradient: ``ops.flash_attention_diff`` is the differentiable form.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_lse_ref, flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]

#: the bf16 route (``WgTiling`` in csrc/flash_attention.cu): head dims,
#: threads a block (a producer warpgroup and two consumer warpgroups),
#: folded query rows a block (64 a consumer), keys a K/V tile and stages of
#: the K and V rings by head dim (hd 256: 64 keys, 2 stages, so that Q and
#: the rings fit a block's shared memory), the columns of a TMA box (the
#: 128-byte swizzle spans 64 bf16 columns) and the registers a thread that
#: setmaxnreg gives the producer and the consumers
WG_HEAD_DIMS = (64, 128, 256)
WG_THREADS = 384
WG_ROWS = 128
WG_KEYS = {64: 128, 128: 128, 256: 64}
WG_STAGES = {64: 3, 128: 3, 256: 2}
WG_BOX_COLS = 64
WG_REGS = (24, 240)
_INT_MAX = 2**31 - 1


def wg_plan(hd):
    """The bf16 route's plan at head dim ``hd``, as the kernel lays it out:
    ``threads``, ``rows`` (folded query rows a block), ``keys`` (a tile),
    ``stages`` of each of the K and V rings, ``smem_bytes`` (1024 for
    aligning the rings by hand, Q of both consumers, the K and V rings, a
    full and an empty 8-byte mbarrier a stage of each ring), the TMA
    ``box`` (columns, keys) of K or V, ``boxes`` a tile (K and V, hd/64
    each) and ``tx_bytes``, what the full barriers of a tile's K and V
    stages wait for together (whole boxes, zero-filled keys past Sk too)
    and the setmaxnreg ``regs`` of the producer and the consumers."""
    if hd not in WG_HEAD_DIMS:
        raise ValueError(f"flash_attention: the bf16 route takes head_dim {WG_HEAD_DIMS}, not {hd}")
    sub = hd // WG_BOX_COLS  # 64-column boxes a row
    keys, stages = WG_KEYS[hd], WG_STAGES[hd]
    box_bytes = WG_BOX_COLS * keys * 2
    q_bytes = WG_ROWS * hd * 2
    kv_tile = sub * box_bytes
    return {"threads": WG_THREADS, "rows": WG_ROWS, "keys": keys, "stages": stages,
            "smem_bytes": 1024 + q_bytes + 2 * stages * kv_tile + 4 * stages * 8,
            "box": (WG_BOX_COLS, keys), "boxes": 2 * sub, "tx_bytes": 2 * kv_tile,
            "regs": WG_REGS}


#: the float32 route (``Tf32Tiling`` in csrc/flash_attention.cu): folded
#: query rows a block (16 a row warp), and by head dim the warp groups that
#: share a ring stage's keys and the keys a warp takes from a stage
TF32_ROWS = 32
TF32_SPLIT = {8: 2, 16: 2, 32: 2, 64: 2, 128: 2, 256: 4}
TF32_KEYS = {8: 32, 16: 32, 32: 32, 64: 32, 128: 16, 256: 8}
TF32_SMEM_LIMIT = 232448  # shared memory a block may use on an H100


def tf32_plan(hd):
    """The float32 route's tiling at head dim ``hd``, as ``Tf32Tiling``
    lays it out: ``split`` (warp groups that share a stage's keys),
    ``threads`` a block (two row warps in each group), ``rows``, ``keys`` a
    warp takes from a stage, ``stage`` (keys a ring stage), ``ld`` (a
    shared row's floats, hd + 4: conflict-free fragments),
    ``q_in_registers`` (Q's split fragments; else Q's hi and lo halves in
    shared memory) and ``smem_bytes`` (Q, then two stages of K and V)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    split, keys = TF32_SPLIT[hd], TF32_KEYS[hd]
    stage, ld, q_regs = split * keys, hd + 4, hd <= 64
    q_words = (1 if q_regs else 2) * TF32_ROWS * ld
    return {"split": split, "threads": 32 * (TF32_ROWS // 16) * split, "rows": TF32_ROWS,
            "keys": keys, "stage": stage, "ld": ld, "q_in_registers": q_regs,
            "smem_bytes": (q_words + 4 * stage * ld) * 4}


#: the bf16 route at hd 8, 16 and 32 (``MmaTiling`` in csrc/flash_attention.cu):
#: warps a block (16 folded rows each), keys a K/V tile, stages of the
#: cp.async ring
MMA_HEAD_DIMS = (8, 16, 32)
MMA_WARPS = 4
MMA_KEYS = 64
MMA_STAGES = 2


def mma_plan(hd):
    """The bf16 mma.sync route's tiling at head dim ``hd``, as ``MmaTiling``
    lays it out: ``warps`` and ``threads`` a block, ``rows`` (folded query
    rows a block, 16 a warp), ``keys`` (a K/V tile), ``stages`` of the
    cp.async ring, ``ld`` (a shared row's bf16 elements: hd + 8, and 8 at hd
    8, so that the 8 rows of an ldmatrix phase fall in 8 distinct 16-byte
    bank groups) and ``smem_bytes`` (the K and V rings)."""
    if hd not in MMA_HEAD_DIMS:
        raise ValueError(f"flash_attention: the bf16 mma.sync route takes head_dim "
                         f"{MMA_HEAD_DIMS}, not {hd}")
    ld = hd + 8 * (hd > 8)
    return {"warps": MMA_WARPS, "threads": 32 * MMA_WARPS, "rows": 16 * MMA_WARPS,
            "keys": MMA_KEYS, "stages": MMA_STAGES, "ld": ld,
            "smem_bytes": 2 * MMA_STAGES * MMA_KEYS * ld * 2}


def check_route(q, k, v):
    """The checks that need no device: shapes, head dim, dtype, the 16-byte
    alignment every route's copies need and the index range of the bf16
    wgmma route. Raises ValueError or TypeError for what the kernels do not
    take."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} not in (float32, bfloat16)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: {q.dtype} at head_dim {hd} runs on the tensor cores, "
                         "which need q, k and v to start on a 16-byte boundary")
    wgmma = q.dtype == torch.bfloat16 and hd in WG_HEAD_DIMS
    rows = H // K * Sq
    if wgmma and (rows + WG_ROWS > _INT_MAX or -(-rows // WG_ROWS) * K * B > _INT_MAX):
        raise ValueError(f"flash_attention: {rows} folded rows a kv head at batch {B} overflow "
                         "the bf16 route's 32-bit row and block indices")


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return _launch(q, k, v, causal, window, softcap, with_lse=False)[0]


def flash_attention_lse(q, k, v, *, causal=True, window=0, softcap=0.0):
    """(output, log-sum-exp (B,H,Sq) float32), the row h = kv_head * G + g."""
    if q.device.type == "cpu":
        return flash_attention_lse_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return _launch(q, k, v, causal, window, softcap, with_lse=True)


def _launch(q, k, v, causal, window, softcap, with_lse):
    _build.refuse_fake("flash_attention", q, k, v)
    _build.refuse_grad("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    check_route(q, k, v)
    _build.check_cuda_inputs("flash_attention", q.dtype, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return o, lse
    fn = _build.load("flash_attention", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, Sq, Sk, H, K, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            stream,
        )
        _build.count_launch(flash_attention, sq_ne_sk=Sq != Sk, stream=stream)
    _build.raise_on_error("flash_attention", rc)
    return o, lse


flash_attention.launches = 0
flash_attention.launches_sq_ne_sk = 0
