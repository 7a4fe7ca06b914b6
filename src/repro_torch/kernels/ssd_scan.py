"""Mamba2 SSD chunked scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``: from a zero
state, y (B,S,H,P) and the final state (B,H,P,N) float32 of the chunked
scan over x (B,S,H,P), dt (B,S,H), A (H,), B_/C_ (B,S,H,N). x, B_ and C_
are float32 or bfloat16 (one type), y comes out in x's type; dt and A are
float32. S % chunk == 0 with any chunk in 1..128 (the TPU kernel is tiled
for 128); P and N in 1..128. x and dt are contiguous; B_ and C_ need only
a contiguous last dim, so the model's single group broadcast over the
heads (head stride 0) is read without a copy. The kernel is chunk-parallel
(the SSD paper's chunk states, state passing and chunk outputs, one C call
launching three kernels); its float32 workspace is allocated here.

On a CPU tensor the wrapper computes the plain version
(``ref.ssd_scan_ref``, which also takes an initial state ``h0``); on a CUDA
tensor it launches the kernel or raises: an ``h0`` there (multi-token
decode, off the served path) raises ``NotImplementedError``, and a CUDA
input that requires grad while grad mode is on raises ``RuntimeError``
(the output would carry no gradient): ``ops.ssd_scan_diff`` is the
differentiable form. ``ssd_scan.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_scan_ref

MAX_DIM = 128
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])


def ssd_scan(x, dt, A, B_, C_, *, chunk=128, h0=None):
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B_, C_, chunk=chunk, h0=h0)
    _build.refuse_fake("ssd_scan", x, dt, A, B_, C_)
    _build.refuse_grad("ssd_scan", x, dt, A, B_, C_)
    if h0 is not None:
        raise NotImplementedError("ssd_scan: the kernel scans from a zero state; "
                                  "an initial state h0 is not supported")
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or B_.shape != (Bsz, S, H, N)
            or C_.shape != B_.shape):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} dt {tuple(dt.shape)} A {tuple(A.shape)} "
                         f"B_ {tuple(B_.shape)} C_ {tuple(C_.shape)}")
    if not (1 <= chunk <= MAX_DIM and S % chunk == 0 and 1 <= P <= MAX_DIM
            and 1 <= N <= MAX_DIM):
        raise ValueError(f"ssd_scan: S {S}, chunk {chunk}, P {P}, N {N}: need S % chunk == 0 "
                         f"and chunk, P, N in 1..{MAX_DIM}")
    _build.check_cuda_inputs("ssd_scan", x.dtype, x)
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt {dt.dtype} and A {A.dtype} must be float32")
    _build.check_cuda_inputs("ssd_scan", torch.float32, dt, A)
    for name, t in (("dt", dt), ("A", A), ("B_", B_), ("C_", C_)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on {x.device}")
    for name, t in (("B_", B_), ("C_", C_)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: mixed dtypes {t.dtype} and {x.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} of strides {t.stride()} has a strided last dim")
    y = torch.empty_like(x)
    fs = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, fs.zero_()
    # the chunk states, then the states entering each chunk, and cs_last
    work = torch.empty(Bsz * H * (S // chunk) * (P * N + 1), dtype=torch.float32,
                       device=x.device)
    fn = _build.load("ssd_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(
            0 if x.dtype == torch.float32 else 1,
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), fs.data_ptr(), work.data_ptr(),
            Bsz, S, H, P, N, chunk, *B_.stride()[:3], *C_.stride()[:3],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.count_launch(ssd_scan)
    _build.raise_on_error("ssd_scan", rc)
    return y, fs


ssd_scan.launches = 0
