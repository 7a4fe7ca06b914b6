"""Flash attention (prefill): the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
Causal / sliding-window / tanh-softcapped GQA attention of q (B,Sq,H,hd)
against k/v (B,Sk,K,hd) at implicit arange positions, with a streaming
softmax in float32. Sq == Sk of any length (the TPU kernel needs
multiples of 128);
hd in {8, 16, 32, 64, 128, 256}; float32 or bfloat16 in, out in q's type.
float32 at hd <= 128 runs on the tensor cores in split-TF32 (its algorithm
step by step: ``ref.flash_attention_split_ref``), bfloat16 at hd 64 and
128 on the tensor cores in bf16; the rest on the CUDA cores. The
tensor-core routes copy 16 bytes at a time, so there q, k and v must start
on a 16-byte boundary (a float32 view at an offset of a whole number of
4 floats, a bfloat16 one of 8); the wrapper raises ``ValueError`` if not.

``flash_attention`` is the serving entry point; ``flash_attention_lse``
also returns the float32 log-sum-exp of each row, (B,H,Sq), which the
backward kernel (``flash_attention_bwd``) takes. Both launch the same
kernel and count on ``flash_attention.launches``.

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
    _build.refuse_grad("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, K, hd) or v.shape != k.shape or H % K or Sq != Sk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    _build.check_cuda_inputs("flash_attention", q.dtype, q, k, v)
    tensor_cores = hd <= 128 if q.dtype == torch.float32 else hd in (64, 128)
    if tensor_cores and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: {q.dtype} at head_dim {hd} runs on the tensor cores, "
                         "which need q, k and v to start on a 16-byte boundary")
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
        _build.count_launch(flash_attention)
    _build.raise_on_error("flash_attention", rc)
    return o, lse


flash_attention.launches = 0
