"""Captured steps: the counterpart of the reference's ``jax.jit`` of a
fixed-shape step: the serving steps (``src/repro/launch/serve.py``'s
``ServeEngine._decode``, ``src/repro/core/live.py``'s prefill and decode
entry points), the donated train step (``src/repro/launch/train.py``'s
``jax.jit(step_fn, donate_argnums=(0,))``: ``train_step``) and the cell
programs (``src/repro/launch/programs.py``'s ``CellProgram.jitted()``:
``ProgramCall``).

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
A train step and a program skip it: their first call of a shape runs
eagerly on the real inputs (the run's first step), and the next captures;
a copy of a training state would double the state's bytes.
The capture then runs on the calling thread's capture stream
(``capture_stream``: one a thread, kept) with
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

A train step's capture holds its backward pass too: autograd runs it on a
device thread of its own, on the forward's stream, so the capture stream
takes its launches and its allocations (the graph's pool), as it takes
those of the recomputed forward under a remat policy.

The kernels count their launches (``kernels/_build.py::count_launch``): a
capture records each wrapper's launches on its stream instead of counting
them, as nothing runs there, from whatever thread launched them, and every
replay adds them, so the counts stay exact.
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Callable

import torch

from ..kernels import _build
from ..models.params import tree_leaves, tree_map
from ..parallel import spmd

F32 = torch.float32
_streams = threading.local()  # each thread's capture streams, by device


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


def write_back(dst: dict, src: dict) -> None:
    """Copy into ``dst`` each leaf of ``src`` that is not already ``dst``'s
    tensor: a donated step returns most of its new state in the tensors it
    was given, and some leaves out of place (the step counter, a decode
    cache's lengths)."""
    for k, d in dst.items():
        s = src[k]
        if isinstance(d, dict):
            write_back(d, s)
        elif s is not d:
            d.copy_(s)


def capture_stream(device) -> torch.cuda.Stream:
    """This thread's stream for captures on ``device``, made at its first
    capture there and kept. cuBLAS and cuBLASLt keep a workspace for each
    handle and stream they meet, for the life of the process: one made
    inside a capture comes from that graph's pool and holds the pool's
    segment after the graph is gone. So the stream's workspaces are made
    here, outside any capture, by a few products forward and backward (the
    backward's on autograd's device thread, which has handles of its own),
    and every capture of the thread reuses the stream."""
    device = torch.device(device)
    held = getattr(_streams, "by_device", None)
    if held is None:
        held = _streams.by_device = {}
    stream = held.get(device)
    if stream is None:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream), torch.enable_grad():
            for dt in (F32, torch.bfloat16):
                a = torch.ones((64, 64), dtype=dt, device=device, requires_grad=True)
                bias = torch.ones(64, dtype=dt, device=device, requires_grad=True)
                y = torch.addmm(bias, a, a).float().sum() + torch.bmm(a[None], a[None]).sum()
                if dt == torch.bfloat16:  # the bf16 LM head's product (no autograd)
                    y = y + torch.mm(a.detach(), a.detach(), out_dtype=F32).sum()
                y.backward()
        stream.synchronize()
        held[device] = stream
    return stream


def step_route(model, params: dict, collectives: bool = False) -> str:
    """"graph" where a step of ``model`` (an ``LM``) with ``params`` is
    captured, else the reason it runs eagerly. ``collectives``: the step
    calls a process group itself (``train_dp``'s mean of the gradients)."""
    if collectives:
        return "eager: collectives of a process group (gloo goes through the host)"
    if any(spmd.is_dtensor(t) for t in tree_leaves(params)):
        return "eager: DTensor params (a mesh)"
    if model.device.type != "cuda":
        return "eager: cpu"
    if model.impl != "cuda":
        return f"eager: impl {model.impl!r}, not the kernels"
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
        stream = capture_stream(device)
        before = torch.cuda.memory_reserved(device)
        with _build.recording_launches(stream.cuda_stream) as launches, torch.cuda.stream(stream):
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
    cache in place), what it returns out of place (the new ``lengths``)
    written back into the cache, the argmax token copied into "tok".
    Returns the logits (B, V). One call is one reference ``decode``
    (``src/repro/core/live.py:134-139``) with its output fed back."""

    def body(bufs):
        cache, tok = bufs["cache"], bufs["tok"]
        logits, out = model.decode_step(params, cache, tok, dtype=F32)
        write_back(cache, out)
        tok.copy_(torch.argmax(logits, -1)[:, None])
        return logits

    return body


def decode_step(model, params: dict, cache: dict, *, warmup: bool = True) -> CapturedStep:
    """A ``CapturedStep`` of ``decode_body`` over ``cache`` (its static cache:
    the step advances it in place) and a zero token buffer (B, 1) int64."""
    tok = torch.zeros((cache["lengths"].shape[0], 1), dtype=torch.long, device=model.device)
    return CapturedStep(decode_body(model, params), {"cache": cache, "tok": tok},
                        route=step_route(model, params), warmup=warmup)


def train_body(step_fn: Callable) -> Callable:
    """The body of one train step over buffers {"state", "batch"}:
    ``step_fn(state, batch)`` (``make_train_step(donate=True)``, which writes
    the new params and moments into the state's tensors), then whatever it
    returned out of place (the step counter ``state["step"] + 1``) copied
    into the state's buffers. Returns the metrics. One call is one step of
    the reference's jitted, donated ``step_fn``."""

    def body(bufs):
        state = bufs["state"]
        new, metrics = step_fn(state, bufs["batch"])
        write_back(state, new)
        return metrics

    return body


def train_step(model, step_fn: Callable, state: dict, batch: dict) -> CapturedStep:
    """A ``CapturedStep`` of ``train_body(step_fn)`` over ``state`` (its
    static state: each call advances it in place) and a copy of ``batch``
    (its static batch: copy each step's batch into ``buffers["batch"]``).
    The caller has run ``step_fn`` once eagerly on this state and a batch
    of this shape (the run's first step): no warm-up. What that step left
    in the allocator's cache (its activations) is returned to the device
    before the capture, so the graph's pool does not sit beside it."""
    route = step_route(model, state["params"])
    if route == "graph":
        torch.cuda.empty_cache()
    return CapturedStep(train_body(step_fn), {"state": state, "batch": clone_tree(batch)},
                        route=route, warmup=False)


class ProgramCall:
    """``jax.jit(fn, donate_argnums=...)`` of a cell program
    (``launch/programs.py::CellProgram.jitted``): the first call of each
    input shape runs ``fn`` eagerly (its warm-up, on the real inputs), the
    second captures it and every call from then on replays it, where
    ``step_route`` captures (else every call runs ``fn``). Output ``i`` of
    ``fn`` is the new value of donated argument ``i`` (train: the state;
    decode: the cache): the capture call's donated arguments become the
    graph's buffers and are advanced in place, and are what the call
    returns there. The arguments of ``hold_argnums`` (the params of a
    serving program) are read where they lie: another tree is another
    shape, captured anew. The other arguments are copied into the graph's
    buffers, as is a donated argument that is not its buffers. The outputs
    live in the graph's pool, rewritten by the next call of the shape:
    clone what must outlive it."""

    def __init__(self, fn: Callable, model, *, donate_argnums: tuple, hold_argnums: tuple,
                 params_of: Callable):
        self.fn, self.model, self.params_of = fn, model, params_of
        self.donate, self.hold = tuple(donate_argnums), tuple(hold_argnums)
        #: {input shape: CapturedStep}, and the shapes run once eagerly
        self.steps: dict = {}
        self._warm: set = set()

    def route(self, *args) -> str:
        return step_route(self.model, self.params_of(args))

    def _key(self, args) -> tuple:
        return tuple(id(a) if i in self.hold else tuple(
            (tuple(t.shape), t.dtype) for t in tree_leaves({"a": a}))
            for i, a in enumerate(args))

    def __call__(self, *args):
        if self.route(*args) != "graph":
            return self.fn(*args)
        key = self._key(args)
        step = self.steps.get(key)
        if step is None:
            if key not in self._warm:
                self._warm.add(key)
                return self.fn(*args)
            step = self.steps[key] = self._capture(args)
        else:
            for i, a in enumerate(args):
                if i not in self.hold and a is not step.buffers[str(i)]:
                    copy_tree({"a": step.buffers[str(i)]}, {"a": a})
        return step()

    def _capture(self, args) -> CapturedStep:
        held = {i: args[i] for i in self.hold}
        bufs = {str(i): a if i in self.donate else tree_map(torch.clone, {"a": a})["a"]
                for i, a in enumerate(args) if i not in held}
        fn, donate, n = self.fn, self.donate, len(args)

        def body(b):
            out = list(fn(*(held[i] if i in held else b[str(i)] for i in range(n))))
            for i in donate:
                write_back({"a": b[str(i)]}, {"a": out[i]})
                out[i] = b[str(i)]
            return tuple(out)

        torch.cuda.empty_cache()
        return CapturedStep(body, bufs, route="graph", warmup=False)
