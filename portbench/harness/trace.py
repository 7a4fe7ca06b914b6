"""The traced run: ``torch.profiler`` (CUPTI, device activity only) over a
part of the window, and the calls made inside it.

The profiler starts and stops with every stage held at its boundary
(``Recorder.paused``): no worker launches while CUPTI is switched, and the
traced interval holds whole stages only, so the kernels in the trace are
exactly those of the calls recorded in it. Each prefill or decode call in the
interval is timed on the device by a pair of CUDA events around its replay,
queued with no other thread's work between them (``Recorder._timed``); the
kernels give each class's device time and the busy union; the host's
runtime calls label the idle gaps.
"""
from __future__ import annotations

import json
import statistics
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType

from counts.kernels import FIRST_KERNEL, kernel_class

ACTIVITIES = [torch.profiler.ProfilerActivity.CUDA]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: list  # (kind, qid, step, rows, device seconds) of each call traced
    class_s: dict  # kernel class -> device seconds
    class_n: dict  # kernel class -> launches
    device_ops: list  # [name, seconds], most time first
    idle_gaps: list  # [label, seconds], longest first
    n_events: int = 0
    names: dict = field(default_factory=dict)  # kernel name -> class, as matched

    def call_ms(self, kind: str):
        t = [c[4] for c in self.calls if c[0] == kind]
        return 1e3 * statistics.median(t) if t else None


class Tracer:
    """Start the profiler ``start_s`` into the window and stop it
    ``seconds`` later (within the window), from the calling thread. Made in
    set-up, it runs one short session first, so the profiler's own start-up
    falls outside the window."""

    def __init__(self, eng, recorder, start_s: float, seconds: float):
        self.eng, self.recorder = eng, recorder
        self.start_s, self.seconds = float(start_s), float(seconds)
        self.prof = None
        self.span = (0.0, 0.0)
        self.calls = []
        recorder.gated = True
        self.cuda = eng.models.device.type == "cuda"
        if self.cuda:
            with torch.profiler.profile(activities=ACTIVITIES):
                torch.ones(1, device=eng.models.device).add_(1)
                torch.cuda.synchronize()

    def during(self, win) -> None:
        t_a = win.start + min(self.start_s, max(0.0, win.seconds - self.seconds))
        while self.eng.now() < t_a:
            time.sleep(0.005)
        rec = self.recorder
        win.traced_from = self.eng.now()
        with rec.paused():
            if self.cuda:
                self.prof = torch.profiler.profile(activities=ACTIVITIES)
                self.prof.start()
                rec.calls = self.calls
            t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.seconds:
            time.sleep(0.005)
        with rec.paused():
            t1 = time.perf_counter()
            rec.calls = None
            if self.cuda:
                torch.cuda.synchronize()
                self.prof.stop()
        self.span = (t0, t1)


def _label(name: str) -> str:
    if name.startswith("cudaGraphLaunch"):
        return "graph launch"
    if "Synchronize" in name:
        return "event sync"
    if name.startswith("cudaMemcpy"):
        return "checkpoint clone and token copy"
    return name


def read(tracer: Tracer, diag_path=None) -> Trace:
    """Reduce a stopped tracer: its profiler's events and its calls."""
    window_s = tracer.span[1] - tracer.span[0]
    calls = [(k, qid, step, rows, 1e-3 * a.elapsed_time(b))
             for k, qid, step, rows, a, b in tracer.calls]
    if tracer.prof is None:
        return Trace(window_s, 0.0, calls, {}, {}, [], [])
    events = tracer.prof.profiler.kineto_results.events()
    host = []  # (start_ns, end_ns, label) of the host's runtime calls
    device = []  # (start_ns, end_ns, name)
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name().startswith("cuda"):
            host.append((e.start_ns(), e.end_ns(), _label(e.name())))
    ops: dict = defaultdict(float)
    class_s: dict = defaultdict(float)
    class_n: dict = defaultdict(int)
    names = {}
    for s, t, name in device:
        dur = (t - s) * 1e-9
        ops[_short(name)] += dur
        cls = kernel_class(name)
        if cls is not None:
            class_s[cls] += dur
            class_n[cls] += cls not in FIRST_KERNEL or FIRST_KERNEL[cls] in name
            names[_short(name)] = cls
    busy, gaps = _busy_and_gaps(device)
    host.sort()
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        cover = defaultdict(int)
        for s, t, lab in host:
            if s >= g1:
                break
            if t > g0:
                cover[lab] += min(t, g1) - max(s, g0)
        lab = max(cover, key=cover.get) if cover else "no host call: no query's work queued"
        labelled.append([lab, (g1 - g0) * 1e-9])
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    tr = Trace(window_s=window_s, busy_s=busy, calls=calls, class_s=dict(class_s),
               class_n=dict(class_n), device_ops=[[n, s] for n, s in top], idle_gaps=labelled,
               n_events=len(events), names=names)
    if diag_path is not None:
        with open(diag_path, "w") as f:
            json.dump({"events": len(events), "device": len(device), "host": len(host),
                       "calls": len(calls), "class_s": tr.class_s, "class_n": tr.class_n,
                       "names": names, "device_ops": tr.device_ops,
                       "idle_gaps": tr.idle_gaps}, f, indent=1)
    return tr


def _busy_and_gaps(device):
    spans = sorted((s, t) for s, t, _ in device)
    busy = 0
    gaps = []
    cur_s = cur_t = None
    for s, t in spans:
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    return busy * 1e-9, gaps


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 96 characters."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    depth = 0
    for i, ch in enumerate(base):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            base = base[:i]
            break
    return base[:96]
