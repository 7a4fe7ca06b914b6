"""Build the CUDA sources in ``../csrc`` at first use and bind them.

Each ``csrc/<name>.cu`` exports a plain C entry point ``<name>`` and is
compiled on its own by ``nvcc`` for ``sm_90a`` into a shared library
under ``<repo>/build/kernels/`` (named by a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edit rebuilds), then
loaded with ``ctypes``. Every pointer and the stream pass as
``c_void_p``. Nothing is built or loaded when this module is imported:
the CPU never needs the libraries.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_fns: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the last build of ``name`` (ptxas register and
    shared-memory use per kernel)."""
    return BUILD_DIR / f"{name}.log"


def build(names=KERNELS) -> dict:
    """Compile every named source that has no library yet, one ``nvcc``
    each, all started together. Returns {name: build seconds} for the ones
    built; raises with nvcc's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        with open(log_path(name), "w") as log:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
            )
        jobs[name] = (proc, tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        if proc.wait() != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
        seconds[name] = time.perf_counter() - t0
    if failed:
        logs = "\n".join(f"--- {n}\n{log_path(n).read_text()}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def load(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name``, built if needed; returns a cudaError_t
    code as int."""
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(library_path(name))), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return fn


def count_launch(wrapper, sq_ne_sk: bool = False) -> None:
    """Add one to ``wrapper.launches``, and to ``wrapper.launches_sq_ne_sk``
    too for an attention launch whose queries and keys differ in length
    (seamless's cross-attention, where the encoder's and the decoder's run
    at Sq == Sk). Locked: the live engine launches from several worker
    threads, and ``+=`` on an attribute is a read and a write that another
    thread can come between."""
    with _count_lock:
        wrapper.launches += 1
        if sq_ne_sk:
            wrapper.launches_sq_ne_sk += 1


def refuse_fake(name: str, *tensors) -> None:
    """Raise for a FakeTensor (a step traced under ``FakeTensorMode``): the
    kernel reads ``data_ptr``, which means nothing there. A traced step
    takes the kernels' trace route (``kernels/trace.py``)."""
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError(f"{name}: a FakeTensor reached the kernel's wrapper; trace a step "
                           f"through the \"trace\" route (kernels/trace.py)")


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and a CUDA input requires grad: the kernel's
    output would carry no gradient. Differentiate through the
    ``torch.autograd.Function``s in kernels/ops.py instead (their forward
    runs with grad mode off)."""
    if torch.is_grad_enabled() and any(
            t.device.type == "cuda" and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a CUDA input requires grad, and the kernel's output has no "
            f"gradient; call it through kernels/ops.py's autograd Functions")


def check_cuda_inputs(name: str, dtype, *tensors) -> None:
    """Raise unless every tensor is contiguous, on one CUDA device, and the
    float ones share ``dtype`` (float32 or bfloat16)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not in (float32, bfloat16)")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors on {t.device} and {dev}; need one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
        if t.is_floating_point() and t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
