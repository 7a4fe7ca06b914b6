"""Captured serving steps: the counterpart of the reference's ``jax.jit`` of a
fixed-shape serving step (``src/repro/launch/serve.py``'s
``ServeEngine._decode``, ``src/repro/core/live.py``'s prefill and decode
entry points).

In the reference one decode step is one dispatch of one XLA executable. Here
a ``CapturedStep`` holds

* static input buffers (a tree of tensors: the tokens, a decode cache in the
  ``LM.init_cache`` layout),
* a body that runs the step on those buffers and writes its state back into
  them, and
* on a CUDA device, a ``torch.cuda.CUDAGraph`` of that body with its own
  memory pool, captured once for the shape: one replay launches the same
  hand-written kernels and cuBLAS calls as one eager call of the body, from
  one host call. The body's outputs (the logits, a prefill's cache) are
  tensors in the graph's pool, rewritten by every replay: clone what must
  outlive the next one.

Capture: the body runs once eagerly on a copy of the buffers first (its
``warmup``), so the kernels are built (``nvcc`` at a wrapper's first call)
and their ``static cudaFuncSetAttribute`` calls have run, and so the step
does not advance the real state (a decode step writes its cache in place).
The capture then runs on a side stream of its own with
``capture_error_mode="thread_local"``: other threads keep launching on the
default stream meanwhile (the live engine's workers). Replays go to the
caller's current stream. A capture that fails raises; nothing falls back to
the eager step.

After the capture the graph is uploaded to the device (``cuGraphUpload``),
so its first replay costs what the others do.

Which steps are captured is decided up front by ``step_route``, never by
catching an error: a step whose body reads the device to the host cannot be
captured, so a step over DTensor params (a mesh: the collectives go through
the host) is not, nor one of a model whose ``impl`` is not the kernels (the
plain versions build constants from host data, and the plain gathered MoE
decode reads its chosen experts with ``tolist()``). The MoE archs are
captured like the others: their gathered decode takes the ``moe_decode``
kernel, which reads the chosen ids on the card, and the one-group and
prefill branches (``moe_dispatch``) read nothing to the host. The steps
kept eager, and every step on the CPU, run the same body eagerly on the same
static buffers: the code the graph holds is the code the CPU tests check.

The kernels count their launches (``kernels/_build.py::count_launch``): a
capture records each wrapper's launches instead of counting them, as nothing
runs there, and every replay adds them, so the counts stay exact.
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable

import torch

from ..kernels import _build
from ..models.params import tree_leaves, tree_map
from ..parallel import spmd

F32 = torch.float32


def clone_tree(tree: dict) -> dict:
    """A copy of every leaf of a tree of tensors."""
    return tree_map(torch.clone, tree)


def copy_tree(dst: dict, src: dict) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``; raises
    ``ValueError`` unless both trees have the same keys, shapes and dtypes."""
    if dst.keys() != src.keys():
        raise ValueError(f"copy_tree: keys {sorted(src)} into {sorted(dst)}")
    for k, d in dst.items():
        s = src[k]
        if isinstance(d, dict):
            copy_tree(d, s)
        elif d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"copy_tree: {k} {tuple(s.shape)} {s.dtype} into "
                             f"{tuple(d.shape)} {d.dtype}")
        else:
            d.copy_(s)


def step_route(model, params: dict) -> str:
    """"graph" where a step of ``model`` (an ``LM``) with ``params`` is
    captured, else the reason it runs eagerly."""
    if model.device.type != "cuda":
        return "eager: cpu"
    if model.impl != "cuda":
        return f"eager: impl {model.impl!r}, not the kernels"
    if any(spmd.is_dtensor(t) for t in tree_leaves(params)):
        return "eager: DTensor params (a mesh)"
    return "graph"


class CapturedStep:
    """One fixed-shape step: ``buffers`` (a tree of tensors the caller writes
    before each call), ``body(buffers)`` (runs the step, writes its state back
    into the buffers, returns its outputs) and, where ``route`` is "graph", a
    CUDA graph of the body. ``step()`` replays it (or, on another route, calls
    the body) and returns the outputs. ``warmup`` runs the body once eagerly
    on a copy of the buffers first, on every route; the caller may skip it
    only where the same step already ran once in this process."""

    def __init__(self, body: Callable, buffers: dict, *, route: str, warmup: bool = True):
        self.body = body
        self.buffers = buffers
        self.route = route
        self.graph = None
        self.out = None
        #: {wrapper: [launches, launches at Sq != Sk]} of one replay
        self.launches: dict = {}
        #: seconds of the warm-up and the capture
        self.capture_s = 0.0
        #: bytes the allocator reserved across the capture: the graph's
        #: pool, where no other thread allocates meanwhile
        self.pool_bytes = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            if warmup:
                self.body(clone_tree(self.buffers))
            if route == "graph":
                self._capture()
        self.capture_s = time.perf_counter() - t0

    def _capture(self) -> None:
        device = tree_leaves(self.buffers)[0].device
        graph = torch.cuda.CUDAGraph()
        before = torch.cuda.memory_reserved(device)
        with _build.recording_launches() as launches, torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = self.body(self.buffers)
            finally:
                graph.capture_end()
        self.pool_bytes = torch.cuda.memory_reserved(device) - before
        self.launches = launches
        self.graph = graph
        _upload(graph, torch.cuda.current_stream(device))

    def __call__(self):
        if self.graph is None:
            with torch.no_grad():
                self.out = self.body(self.buffers)
            return self.out
        self.graph.replay()
        _build.add_launches(self.launches)
        return self.out


def _upload(graph, stream) -> None:
    """Move an instantiated graph's work to the device now
    (``cuGraphUpload``), on the stream its replays go to: left to the first
    replay, it is paid there, inside a billed stage."""
    upload = ctypes.CDLL("libcuda.so.1").cuGraphUpload
    upload.argtypes, upload.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    rc = upload(graph.raw_cuda_graph_exec(), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cuGraphUpload failed with CUresult {rc}")


def decode_body(model, params: dict) -> Callable:
    """The body of one greedy decode step over buffers {"cache", "tok"}:
    ``LM.decode_step`` (which writes the new K/V and mamba state into the
    cache in place), its new ``lengths`` copied into the cache's (the step
    returns them out of place), the argmax token copied into "tok". Returns
    the logits (B, V). One call is one reference ``decode``
    (``src/repro/core/live.py:134-139``) with its output fed back."""

    def body(bufs):
        cache, tok = bufs["cache"], bufs["tok"]
        logits, out = model.decode_step(params, cache, tok, dtype=F32)
        cache["lengths"].copy_(out["lengths"])
        tok.copy_(torch.argmax(logits, -1)[:, None])
        return logits

    return body


def decode_step(model, params: dict, cache: dict, *, warmup: bool = True) -> CapturedStep:
    """A ``CapturedStep`` of ``decode_body`` over ``cache`` (its static cache:
    the step advances it in place) and a zero token buffer (B, 1) int64."""
    tok = torch.zeros((cache["lengths"].shape[0], 1), dtype=torch.long, device=model.device)
    return CapturedStep(decode_body(model, params), {"cache": cache, "tok": tok},
                        route=step_route(model, params), warmup=warmup)
