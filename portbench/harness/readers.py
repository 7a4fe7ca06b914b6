"""The metrics' arithmetic over one run (``cell.Run``): the end-to-end
metrics, and the helpers that the per-layer readers (``metrics/<base>.py``)
share. A reader that finds nothing to read returns None, and the metric is
left out of the result line."""
from __future__ import annotations

import numpy as np


def steps(stage: str) -> int:
    """Decode steps of a stage named "decode[a:b]" (0 for the prefill)."""
    if not stage.startswith("decode["):
        return 0
    a, b = stage[len("decode["):-1].split(":")
    return int(b) - int(a)


def _decode_share_in_window(run):
    """(query, decode stage, share of it inside the window): a stage's steps
    taken as even over its wall, so one that straddles an edge of the window
    counts by the share of its wall inside."""
    win = run.win
    for q in win.queries:
        for e in q.stage_trace:
            if not steps(e.stage) or e.finish <= win.start or e.start >= win.end:
                continue
            wall = e.finish - e.start
            inside = min(e.finish, win.end) - max(e.start, win.start)
            yield q, e, (inside / wall if wall > 0 else 1.0)


def _stages_in_window(run):
    win = run.win
    for q in win.queries:
        for e in q.stage_trace:
            if win.start <= e.start and e.finish <= win.end:
                yield q, e


def _finished_in_window(run):
    win = run.win
    return [q for q in win.queries
            if q.state == "done" and q.finish_time is not None and q.finish_time <= win.end]


# --- end to end ---------------------------------------------------------

def tokens_per_s(run):
    """Output tokens (rows x steps) decoded inside the window, over the
    window's seconds: every decode stage inside it, and the share inside of
    one that straddles an edge (a count of whole stages moves in steps of a
    stage's tokens, half a percent of the off-peak cell's rate)."""
    toks = sum(run.win.batch_of[q.qid] * steps(e.stage) * share
               for q, e, share in _decode_share_in_window(run))
    return toks / run.win.seconds if toks else None


def imm_latency_s(run, pct: float, queries=None):
    """The ``pct``-th percentile of finish - due over every IMMEDIATE query
    sent in the window (or of ``queries``), drained ones included; one that
    never finished counts at the drain's end."""
    lat = [(q.finish_time if q.finish_time is not None else run.win.drained_at)
           - run.win.due[q.qid]
           for q in (run.win.queries if queries is None else queries)
           if q.sla.name == "IMMEDIATE"]
    return float(np.percentile(lat, pct)) if lat else None


def imm_latency_p50_s(run):
    """The median latency of the window's IMMEDIATE queries: at the ad-hoc
    cell's ~19 IMMEDIATE queries a window, the highest percentile with ten
    queries beyond it."""
    return imm_latency_s(run, 50)


def cost_per_ktok(run, queries=None):
    """Billed cost of the queries finished in the window (of ``queries``)
    per 1000 of their output tokens (rows x decode tokens)."""
    qs = _finished_in_window(run)
    if queries is not None:
        qs = [q for q in qs if q in set(queries)]
    toks = sum(run.win.batch_of[q.qid] * run.decode_tokens for q in qs)
    return 1000.0 * sum(q.cost for q in qs) / toks if toks else None


END_TO_END = {
    "tokens_per_s": tokens_per_s,
    "imm_latency_p50_s": imm_latency_p50_s,
    "cost_per_ktok": cost_per_ktok,
}


# --- shared by the per-layer readers --------------------------------------
# The host-side readers take the window up to the profiler's start: its
# pauses and its stop hold the workers and the generator back after it.

def untraced(run):
    """The window's queries due before the trace started."""
    return [q for q in run.win.queries if run.win.due[q.qid] < run.win.traced_from]


def untraced_stages(run):
    """(query, stage) of the stages completed in the window before the trace."""
    for q, e in _stages_in_window(run):
        if e.finish <= run.win.traced_from:
            yield q, e


def calls(run, kind):
    """The traced calls of ``kind``: (kind, qid, step, rows, device ms)."""
    if run.trace is None:
        return []
    return [c for c in run.trace.calls if c[0] == kind]


def roofline_share(run, cls, least_per_launch):
    """A kernel class's roofline share: the mean least time of one of its
    launches over the traced calls, times its launches in the trace, over
    their device time, in %."""
    t = run.trace
    if t is None or not least_per_launch or not t.class_s.get(cls):
        return None
    mean = sum(least_per_launch) / len(least_per_launch)
    return 100.0 * mean * t.class_n[cls] / t.class_s[cls]
