"""Flash attention backward: the wrapper of ``csrc/flash_attention_bwd.cu``.

The reference has no backward kernel (its ``repro/kernels/ops.py::_fa_bwd``
reruns the jnp oracle under ``jax.vjp``). This is the FlashAttention-2
backward (arXiv 2307.08691, Alg. 2) of ``flash_attention``: from q, k, v,
the forward's output o and its log-sum-exp lse (B,H,Sq) float32, and the
output's gradient do, it recomputes the probabilities tile by tile and
returns (dq, dk, dv) in q's type. Causal / window / softcap and the GQA
fold as the forward; Sq == Sk of any length; hd in {8, 16, 32, 64, 128,
256}; float32 or bfloat16 (hd 64 and 128 in bfloat16 on the tensor
cores). Deterministic: no atomics, so two calls on the same inputs give
the same bits.

On a CPU tensor the wrapper computes the plain version
(``ref.flash_attention_bwd_ref``); on a CUDA tensor it launches the kernel
or raises. ``flash_attention_bwd.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_bwd_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=0, softcap=0.0):
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window,
                                       softcap=softcap)
    _build.refuse_grad("flash_attention_bwd", q, k, v, o, do, lse)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if (k.shape != (B, Sk, K, hd) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (B, H, Sq) or H % K or Sq != Sk):
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
    fn = _build.load("flash_attention_bwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(
            0 if q.dtype == torch.float32 else 1,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, Sq, Sk, H, K, hd, int(bool(causal)), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.count_launch(flash_attention_bwd)
    _build.raise_on_error("flash_attention_bwd", rc)
    return dq, dk, dv


flash_attention_bwd.launches = 0
