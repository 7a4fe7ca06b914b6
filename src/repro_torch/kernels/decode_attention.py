"""Decode attention: the wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention``.
One new token per sequence, q (B,H,hd), against a linear or ring KV cache
k/v (B,Smax,K,hd). A slot is valid iff ``pos_ids >= 0``,
``pos_ids <= lengths`` and, with a window, ``lengths - pos_ids < window``,
so slot order does not matter. Any Smax (the TPU kernel needs multiples of
128); hd in {8, 16, 32, 64, 128, 256}; float32 or bfloat16 in, out in q's type.
The kernel splits the slots across blocks (whole tiles of ``split_slots(hd)``
slots each) and the last block of each (batch, KV head) merges the splits'
partial softmax states, in one launch; the float32 workspace of the
partials is allocated here, and the counters that find the last block are
kept per device.

With ``return_lse`` the call also returns each head's log-sum-exp (B,H)
float32 of its scaled and capped scores over the valid slots (-inf for a
row with none), and the output in float32: what a merge of partial results
over disjoint slot ranges needs (``parallel/spmd.py::lse_merge``, a cache
split on its sequence across ranks), rounded once after it. Without it the
call computes what it did before, bit for bit.

On a CPU tensor the wrapper computes the plain version
(``ref.decode_attention_ref``); on a CUDA tensor it launches the kernel or
raises. It raises too for a CUDA input that requires grad while grad mode
is on, whose output would carry no gradient (no path differentiates a
decode step). ``decode_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import decode_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_counters: dict = {}


def _counter_buffer(device, n: int) -> torch.Tensor:
    """At least n int32 counters on device, kept between calls: the kernel
    counts each (batch, KV head)'s finished splits in them and leaves them
    at zero. Calls share them, so they run on one stream, as the port's do."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def split_slots(hd: int) -> int:
    """Cache slots a tile of the kernel takes (``kSplit`` in the source); a
    split block takes one or more whole tiles, so Smax / split_slots bounds
    the number of partials."""
    return 32 if hd >= 256 else 64


def decode_attention(q, k, v, pos_ids, lengths, *, window=0, softcap=0.0, return_lse=False):
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos_ids, lengths, window=window, softcap=softcap,
                                    return_lse=return_lse)
    _build.refuse_fake("decode_attention", q, k, v)
    _build.refuse_grad("decode_attention", q, k, v)
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    if (k.shape != (B, Smax, K, hd) or v.shape != k.shape or H % K
            or pos_ids.shape != (B, Smax) or lengths.shape != (B,)):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
            f"pos_ids {tuple(pos_ids.shape)} lengths {tuple(lengths.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in {HEAD_DIMS}")
    if H // K * hd > 2048:  # a block's shared memory holds the group's G rows of q
        raise ValueError(f"decode_attention: {H // K} query heads per kv head at hd {hd}")
    if pos_ids.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("decode_attention: pos_ids and lengths must be int32")
    _build.check_cuda_inputs("decode_attention", q.dtype, q, k, v, pos_ids, lengths)
    o = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    # each split's partial (acc (G, hd), m, l) for every query head
    nsplit = -(-Smax // split_slots(hd))
    work = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_ids.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
            work.data_ptr(), work.numel(), _counter_buffer(q.device, B * K).data_ptr(),
            B, H, K, Smax, hd, int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.count_launch(decode_attention)
    _build.raise_on_error("decode_attention", rc)
    return (o, lse) if return_lse else o


decode_attention.launches = 0
