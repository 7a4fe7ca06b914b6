"""Flash attention (prefill): the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
Causal / sliding-window / tanh-softcapped GQA attention of q (B,Sq,H,hd)
against k/v (B,Sk,K,hd) at implicit arange positions, with a streaming
softmax in float32. Sq == Sk of any length (the TPU kernel needs
multiples of 128);
hd in {8, 16, 32, 64, 128}; float32 or bfloat16 in, out in q's type.

On a CPU tensor the wrapper computes the plain version
(``ref.flash_attention_ref``); on a CUDA tensor it launches the kernel or
raises. ``flash_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, K, hd) or v.shape != k.shape or H % K or Sq != Sk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    _build.check_cuda_inputs("flash_attention", q.dtype, q, k, v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _build.load("flash_attention", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, Sk, H, K, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        flash_attention.launches += 1
    _build.raise_on_error("flash_attention", rc)
    return o


flash_attention.launches = 0
