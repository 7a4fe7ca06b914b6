"""The measured window: the load generator sends the plan's queries through
``LiveEngine.submit`` (a Poisson stream on its schedule, an open loop: a
send never waits for an earlier query; a backlog each time one of its
outstanding queries is done), then every submitted query is drained.

Times are the engine's clock (``eng.now()``). A scheduled query's lateness
is how far its send fell behind its due time; its latency for the tails
runs from its due time, so a stall of the generator or of the engine
counts. A backlog query is due when it is submitted.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.query import Query, QueryWork
from repro_torch.core.sla import ServiceLevel

from .traffic import STREAM_BITS, Arrival, Plan

#: how often the generator looks at a backlog's outstanding queries (s)
POLL_S = 0.005


@dataclass
class Window:
    """One window's queries and times, everything the metrics read."""

    start: float  # engine seconds
    seconds: float
    queries: list = field(default_factory=list)  # the Query objects, in send order
    due: dict = field(default_factory=dict)  # qid -> due time (engine seconds)
    late: dict = field(default_factory=dict)  # qid -> send time - due time (s)
    drained_at: float = 0.0
    batch_of: dict = field(default_factory=dict)  # qid -> batch rows
    #: engine seconds at which a traced run's profiler started (its pauses
    #: and its stop hold the workers and the generator back after it)
    traced_from: float = float("inf")

    @property
    def end(self) -> float:
        return self.start + self.seconds


def qid_base(seed: int) -> int:
    """Query ids of a seed's window: the port draws each query's prompt from
    its id, so the ids, and with them the prompts, follow the seed."""
    return (int(seed) % (1 << 40)) << 20


def qid_of(seed: int, a: Arrival) -> int:
    return qid_base(seed) + (a.stream << STREAM_BITS) + a.index


def make_query(a: Arrival, arch: str, seed: int, source: str) -> Query:
    return Query(work=QueryWork(arch=arch, batch=a.batch), sla=ServiceLevel[a.level],
                 submit_time=0.0, source=source, qid=qid_of(seed, a))


def _sleep_until(eng, t: float, step: float = 0.05) -> None:
    while True:
        left = t - eng.now()
        if left <= 0:
            return
        time.sleep(min(left, step) if left > 0.002 else 0)


def run_window(eng, plan: Plan, arch: str, seed: int, source: str, seconds: float,
               drain_timeout_s: float, during=None) -> Window:
    """Send ``plan``'s queries from a generator thread; ``during(win)`` runs
    on the calling thread while the window is open (the tracer), then the
    window is drained: every submitted query done or failed, or
    ``drain_timeout_s`` past the window's end."""
    win = Window(start=eng.now(), seconds=float(seconds))
    scheduled = [(a, make_query(a, arch, seed, source)) for a in plan.scheduled]
    for a, q in scheduled:
        win.due[q.qid] = win.start + a.due_s
        win.batch_of[q.qid] = a.batch
    outstanding = {b.stream: [] for b in plan.backlogs}
    sent = {b.stream: 0 for b in plan.backlogs}

    def send(q: Query, due: float) -> None:
        eng.submit(q)
        win.late[q.qid] = q.submit_time - due
        win.queries.append(q)

    def refill() -> None:
        for b in plan.backlogs:
            live = [q for q in outstanding[b.stream] if q.state not in ("done", "failed")]
            while len(live) < b.depth:
                a = b.arrival(sent[b.stream], eng.now() - win.start)
                q = make_query(a, arch, seed, source)
                win.due[q.qid] = win.start + a.due_s
                win.batch_of[q.qid] = a.batch
                send(q, win.due[q.qid])
                live.append(q)
                sent[b.stream] += 1
            outstanding[b.stream] = live

    def generate():
        step = POLL_S if plan.backlogs else 0.05
        for a, q in scheduled:
            due = win.due[q.qid]
            while plan.backlogs and eng.now() < due:
                refill()
                _sleep_until(eng, min(due, eng.now() + POLL_S), step)
            _sleep_until(eng, due, step)
            send(q, due)
        while plan.backlogs and eng.now() < win.end:
            refill()
            _sleep_until(eng, min(win.end, eng.now() + POLL_S), step)

    gen = threading.Thread(target=generate, name="portbench-load", daemon=True)
    gen.start()
    if during is not None:
        during(win)
    _sleep_until(eng, win.end)
    gen.join(drain_timeout_s)
    deadline = win.end + drain_timeout_s
    while eng.now() < deadline and any(q.state not in ("done", "failed")
                                       for q in win.queries):
        time.sleep(0.02)
    win.drained_at = eng.now()
    return win
