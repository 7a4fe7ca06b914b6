"""DTensor's all-gathers over gloo for CUDA tensors, staged through pinned
host memory.

NCCL takes one rank a device, so several ranks on one card (the port's
SPMD check on one H100: four ranks on ``cuda:0``) run gloo. On torch
2.11 gloo carries CUDA tensors for DTensor's all-reduce, reduce-scatter and
all-to-all, but its all-gather of a CUDA tensor (``funcol.all_gather_tensor``,
every Shard -> Replicate and ``full_tensor``) kills the process with
SIGSEGV (``scripts/gloo_cuda_probe.py``, on an H100). ``install()`` wraps
the functional all-gathers: on a CUDA tensor each copies its input to
pinned host memory, gathers there (the CPU path gloo carries) and copies
the result back to the tensor's device. The compute stays on the card. It
is installed only on a gloo world with a CUDA mesh (``launch/mesh.py``);
an NCCL world never uses it.
"""
from __future__ import annotations

import torch

#: the functional all-gathers wrapped, where this torch has them
COLLECTIVES = ("all_gather_tensor", "all_gather_single")

_installed = False


def _staged(fn):
    import torch.distributed._functional_collectives as funcol

    def run(t, *args, **kwargs):
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            return fn(t, *args, **kwargs)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        out = fn(host, *args, **kwargs)
        if isinstance(out, funcol.AsyncCollectiveTensor):
            out = out.wait()
        return out.to(t.device)

    run.__wrapped__ = fn
    return run


def install() -> None:
    """Wrap the all-gathers (once a process)."""
    global _installed
    if _installed:
        return
    import torch.distributed._functional_collectives as funcol

    for name in COLLECTIVES:
        fn = getattr(funcol, name, None)
        if fn is not None:
            setattr(funcol, name, _staged(fn))
    _installed = True
