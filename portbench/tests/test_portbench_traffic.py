"""The one traffic generator: a seed repeats its plan, another seed offers
the same gaps and levels in another order; bursts, merged streams, and a
backlog that keeps its depth outstanding through the window."""
import threading
import time

import numpy as np
import pytest

from conftest import find_cell
from harness.traffic import exp_gaps, on_seconds, plan, split_levels
from harness.window import qid_base, run_window


def _cell_traffic(name):
    return find_cell(name).traffic


def _poisson(rate=2.0, **kw):
    return {"kind": "poisson", "rate_per_s": rate, "levels": {"IMMEDIATE": 3, "RELAXED": 1},
            "batch": 1, **kw}


def test_arrivals_repeat_for_a_seed():
    t = _cell_traffic("internlm2-1.8b.adhoc")
    a, b = plan(t, 3_000_000_019, 45), plan(t, 3_000_000_019, 45)
    assert a == b and a.scheduled


def test_another_seed_reorders_the_same_load():
    t = {"streams": [_poisson()]}
    a, b = plan(t, 11, 45).scheduled, plan(t, 12, 45).scheduled
    assert [x.due_s for x in a] != [x.due_s for x in b]
    gaps = lambda xs: sorted(np.round(np.diff([x.due_s for x in xs]), 9))  # noqa: E731
    assert len(a) == len(b) == round(2.0 * 45)
    assert sorted(x.level for x in a) == sorted(x.level for x in b)
    # the same set of gaps less the one that opens the window
    ga, gb = set(gaps(a)), set(gaps(b))
    assert len(ga ^ gb) <= 2
    assert all(0 <= x.due_s < 45 for x in a)


def test_levels_follow_the_ratio():
    levels = split_levels({"IMMEDIATE": 3, "RELAXED": 1}, 10)
    assert levels.count("IMMEDIATE") == 8 and levels.count("RELAXED") == 2
    with pytest.raises(ValueError):
        split_levels({"URGENT": 1}, 4)


def test_gaps_are_exponential_quantiles_filling_the_window():
    g = exp_gaps(1000, 2.5, 400.0)
    assert g.sum() == pytest.approx(400.0)
    assert np.median(g) == pytest.approx(np.log(2) / 2.5, rel=0.02)


def test_bursts_send_only_while_on():
    s = _poisson(rate=4.0, on_s=5.0, off_s=15.0)
    assert on_seconds(s, 45) == 5 + 5 + 5
    a = plan({"streams": [s]}, 7, 45).scheduled
    assert len(a) == 4 * 15
    assert all(x.due_s % 20 < 5 for x in a)
    assert max(x.due_s for x in a) > 40


def test_streams_merge_by_due_time_with_ids_of_their_own():
    t = {"streams": [_poisson(rate=1.0), _poisson(rate=3.0, batch=2),
                     {"kind": "backlog", "depth": 3, "levels": {"BEST_EFFORT": 1},
                      "batch": 4}]}
    p = plan(t, 5, 30)
    due = [x.due_s for x in p.scheduled]
    assert due == sorted(due) and len(p.scheduled) == 30 + 90
    assert {(x.stream, x.index) for x in p.scheduled} == \
        {(0, i) for i in range(30)} | {(1, i) for i in range(90)}
    assert p.batches == [1, 2, 4]
    assert len(p.backlogs) == 1 and p.backlogs[0].depth == 3
    with pytest.raises(ValueError):
        plan({"streams": [{"kind": "burst", "levels": {}, "batch": 1}]}, 5, 30)


class _FakeEngine:
    """Submits into a worker that finishes each query ``service_s`` after it
    starts, one at a time."""

    def __init__(self, service_s):
        self.t0, self.service_s = time.monotonic(), service_s
        self.queue, self.started = [], []
        self._stop = threading.Event()
        threading.Thread(target=self._work, daemon=True).start()

    def now(self):
        return time.monotonic() - self.t0

    def submit(self, q):
        q.submit_time = self.now()
        self.queue.append(q)

    def _work(self):
        while not self._stop.is_set():
            if self.queue:
                q = self.queue.pop(0)
                start = self.now()
                time.sleep(self.service_s)
                q.finish_time, q.state = self.now(), "done"
                self.started.append((start, q.finish_time))
            else:
                time.sleep(0.001)


def test_backlog_is_queued_at_the_start_and_outlasts_the_window():
    """A backlog never runs dry: its depth is outstanding from the window's
    start, each query done is replaced, and sends stop when it closes."""
    t = _cell_traffic("mixtral-8x7b-d8.offpeak")
    (stream,) = t["streams"]
    p = plan(t, 5, 1.0)
    assert not p.scheduled and p.backlogs[0].depth == stream["depth"] >= 2
    eng = _FakeEngine(0.05)
    win = run_window(eng, p, "arch", 5, "test", 1.0, 2.0)
    eng._stop.set()
    qs = win.queries
    assert all(q.state == "done" and q.sla.name == "BEST_EFFORT" for q in qs)
    assert all(q.work.batch == 4 for q in qs)
    # the worker never waited for work: each query started as the last ended
    assert len(qs) >= 1.0 / 0.05 - 2
    runs = eng.started
    assert all(b[0] - a[1] < 0.003 for a, b in zip(runs, runs[1:]))
    assert all(q.submit_time <= win.end + 0.01 for q in qs)
    assert [q.qid - qid_base(5) for q in qs] == list(range(len(qs)))
