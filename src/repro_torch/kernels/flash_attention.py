"""Flash attention (prefill): the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
Causal / sliding-window / tanh-softcapped GQA attention of q (B,Sq,H,hd)
against k/v (B,Sk,K,hd) at implicit positions arange(Sq) and arange(Sk),
as the TPU kernel computes them: causal keeps key j for query i iff i >= j
(aligned at the top left), the window counts from the same positions, and
a tile past the frontier is skipped. Any Sq and Sk (the TPU kernel needs
multiples of 128): seamless's cross-attention runs non-causal at Sq != Sk;
hd in {8, 16, 32, 64, 128, 256}; float32 or bfloat16 in, out in q's type.
float32 at hd <= 128 runs on the tensor cores in split-TF32 (its algorithm
step by step: ``ref.flash_attention_split_ref``), bfloat16 at hd 64 and
128 on Hopper's warpgroup products (``flash_wg_kernel``: TMA loads of K/V
into an mbarrier ring from a producer warpgroup, two consumer warpgroups on
wgmma; its shared memory, ring and TMA boxes are ``wg_plan``); the rest on the
CUDA cores. The tensor-core routes copy 16 bytes at a time (TMA too needs
16-byte aligned tensors), so there q, k and v must start on a 16-byte
boundary (a float32 view at an offset of a whole number of 4 floats, a
bfloat16 one of 8); the wrapper raises ``ValueError`` if not
(``check_route``, which also refuses shapes whose folded rows or blocks
overflow the kernels' 32-bit indices).

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
#: folded query rows a block (64 a consumer), keys a K/V tile, ring stages,
#: the columns of a TMA box (the 128-byte swizzle spans 64 bf16 columns)
#: and the registers a thread that setmaxnreg gives the producer and the
#: consumers
WG_HEAD_DIMS = (64, 128)
WG_THREADS = 384
WG_ROWS = 128
WG_KEYS = 128
WG_STAGES = 3
WG_BOX_COLS = 64
WG_REGS = (24, 240)
_INT_MAX = 2**31 - 1


def wg_plan(hd):
    """The bf16 route's plan at head dim ``hd``, as the kernel lays it out:
    ``threads``, ``rows`` (folded query rows a block), ``keys`` (a tile),
    ``stages`` of the K/V ring, ``smem_bytes`` (1024 for aligning the ring
    by hand, Q of both consumers, the K and V rings, a full and an empty
    8-byte mbarrier a stage), the TMA ``box`` (columns, keys) of K or V,
    ``boxes`` a tile (K and V, hd/64 each) and ``tx_bytes``, what a stage's
    full barrier waits for (whole boxes, zero-filled keys past Sk too) and
    the setmaxnreg ``regs`` of the producer and the consumers."""
    if hd not in WG_HEAD_DIMS:
        raise ValueError(f"flash_attention: the bf16 route takes head_dim {WG_HEAD_DIMS}, not {hd}")
    sub = hd // WG_BOX_COLS  # 64-column boxes a row
    box_bytes = WG_BOX_COLS * WG_KEYS * 2
    stages = WG_STAGES
    q_bytes = WG_ROWS * hd * 2
    kv_tile = sub * box_bytes
    return {"threads": WG_THREADS, "rows": WG_ROWS, "keys": WG_KEYS, "stages": stages,
            "smem_bytes": 1024 + q_bytes + 2 * stages * kv_tile + 2 * stages * 8,
            "box": (WG_BOX_COLS, WG_KEYS), "boxes": 2 * sub, "tx_bytes": 2 * kv_tile,
            "regs": WG_REGS}


def check_route(q, k, v):
    """The checks that need no device: shapes, head dim, dtype, the
    tensor-core routes' 16-byte alignment (float32 at hd <= 128, bfloat16
    at hd 64 and 128) and the index range of the bf16 route. Raises
    ValueError or TypeError for what the kernels do not take."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} not in (float32, bfloat16)")
    wgmma = q.dtype == torch.bfloat16 and hd in WG_HEAD_DIMS
    tensor_cores = wgmma or (q.dtype == torch.float32 and hd <= 128)
    if tensor_cores and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: {q.dtype} at head_dim {hd} runs on the tensor cores, "
                         "which need q, k and v to start on a 16-byte boundary")
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
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            B, Sq, Sk, H, K, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.count_launch(flash_attention, sq_ne_sk=Sq != Sk)
    _build.raise_on_error("flash_attention", rc)
    return o, lse


flash_attention.launches = 0
flash_attention.launches_sq_ne_sk = 0
