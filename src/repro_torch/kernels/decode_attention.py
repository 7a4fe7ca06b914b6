"""Decode attention: the wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention``.
One new token per sequence, q (B,H,hd), against a linear or ring KV cache
k/v (B,Smax,K,hd). A slot is valid iff ``pos_ids >= 0``,
``pos_ids <= lengths`` and, with a window, ``lengths - pos_ids < window``,
so slot order does not matter. Any Smax (the TPU kernel needs multiples of
128); hd in {8, 16, 32, 64, 128, 256}; float32 or bfloat16 in, out in q's type.

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
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def decode_attention(q, k, v, pos_ids, lengths, *, window=0, softcap=0.0):
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos_ids, lengths, window=window, softcap=softcap)
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
    if H // K > 256 // max(1, hd // 8):  # a block's rows: 256 threads, hd/8 per row
        raise ValueError(f"decode_attention: {H // K} query heads per kv head at hd {hd}")
    if pos_ids.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("decode_attention: pos_ids and lengths must be int32")
    _build.check_cuda_inputs("decode_attention", q.dtype, q, k, v, pos_ids, lengths)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _build.load("decode_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_ids.data_ptr(),
            lengths.data_ptr(), o.data_ptr(),
            B, H, K, Smax, hd, int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        decode_attention.launches += 1
    _build.raise_on_error("decode_attention", rc)
    return o


decode_attention.launches = 0
