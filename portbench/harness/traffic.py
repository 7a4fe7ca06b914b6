"""The one traffic generator: a traffic file's streams and a seed in, the
window's plan out.

A traffic file lists ``streams``, each with its ``levels`` (a ratio of
service levels) and its ``batch`` (rows a query), and one of two kinds:

* ``poisson``: independent users at ``rate_per_s``. ``n = round(rate_per_s
  * on-seconds)`` queries; the gaps between sends are the n midpoint
  quantiles of an exponential distribution of mean ``1 / rate_per_s``,
  scaled to fill the stream's on-time, and the levels are split by the
  ratio (largest remainders). The seed shuffles both: every seed offers the
  same gaps and the same levels, in another order, so the load does not
  change with it. With ``on_s`` and ``off_s`` the stream sends in bursts:
  ``on_s`` seconds at the rate, then ``off_s`` seconds of silence, from the
  window's start; on-seconds are the window's seconds spent on.
* ``backlog``: a queue that never runs dry. ``depth`` queries are
  outstanding (submitted, not yet done) from the window's start; each time
  one is done the next is submitted, until the window closes. Its levels
  cycle through a seeded order of the ratio.

The Poisson streams' sends are merged by due time. Prompt, decode and
chunk sizes are the engine's (the traffic file's ``engine`` settings).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

LEVELS = ("IMMEDIATE", "RELAXED", "BEST_EFFORT")
KINDS = ("poisson", "backlog")
#: a query id is the seed's base + (stream << STREAM_BITS) + its index in the stream
STREAM_BITS = 16


@dataclass(frozen=True)
class Arrival:
    stream: int  # the stream's place in the traffic file
    index: int  # the query's place in its stream
    due_s: float  # seconds after the window's start (a backlog's: when submitted)
    level: str  # a ServiceLevel name
    batch: int


@dataclass(frozen=True)
class Backlog:
    stream: int
    depth: int
    levels: tuple  # cycled: the k-th query of the stream has levels[k % len]
    batch: int

    def arrival(self, k: int, due_s: float) -> Arrival:
        return Arrival(self.stream, k, due_s, self.levels[k % len(self.levels)], self.batch)


@dataclass(frozen=True)
class Plan:
    scheduled: list  # Arrivals of the Poisson streams, in due order
    backlogs: list = field(default_factory=list)  # Backlog streams

    @property
    def batches(self) -> list[int]:
        return sorted({a.batch for a in self.scheduled} | {b.batch for b in self.backlogs})


def split_levels(levels: dict, n: int) -> list[str]:
    """n level names in ``levels``' ratio, largest remainders first (ties
    in ``LEVELS`` order), unshuffled."""
    unknown = set(levels) - set(LEVELS)
    if unknown:
        raise ValueError(f"unknown levels {sorted(unknown)}; known {LEVELS}")
    names = [lv for lv in LEVELS if levels.get(lv, 0) > 0]
    total = sum(levels[lv] for lv in names)
    exact = {lv: n * levels[lv] / total for lv in names}
    counts = {lv: int(math.floor(exact[lv])) for lv in names}
    by_rem = sorted(names, key=lambda lv: (-(exact[lv] - counts[lv]), LEVELS.index(lv)))
    for lv in by_rem[: n - sum(counts.values())]:
        counts[lv] += 1
    return [lv for lv in names for _ in range(counts[lv])]


def exp_gaps(n: int, rate: float, seconds: float) -> np.ndarray:
    """The n midpoint quantiles of Exp(rate), scaled so they sum to ``seconds``
    (the last send falls at the window's end)."""
    u = (np.arange(n) + 0.5) / n
    g = -np.log1p(-u) / rate
    return g * (seconds / g.sum()) if n else g


def on_seconds(stream: dict, seconds: float) -> float:
    """The seconds of the window in which the stream sends."""
    on, off = float(stream.get("on_s", seconds)), float(stream.get("off_s", 0.0))
    full, rest = divmod(seconds, on + off)
    return full * on + min(rest, on)


def to_wall(t: np.ndarray, stream: dict, seconds: float) -> np.ndarray:
    """On-time offsets to the window's seconds, skipping the off periods."""
    on, off = float(stream.get("on_s", seconds)), float(stream.get("off_s", 0.0))
    return np.floor(t / on) * (on + off) + np.mod(t, on)


def _poisson(s: int, stream: dict, rng, seconds: float) -> list[Arrival]:
    rate = float(stream["rate_per_s"])
    t_on = on_seconds(stream, seconds)
    n = max(1, int(round(rate * t_on)))
    gaps = rng.permutation(exp_gaps(n, rate, t_on))
    levels = [str(x) for x in rng.permutation(split_levels(stream["levels"], n))]
    due = to_wall(np.cumsum(gaps) - gaps[0], stream, seconds)  # the first send opens it
    batch = int(stream["batch"])
    return [Arrival(s, i, float(due[i]), levels[i], batch) for i in range(n)]


def _backlog(s: int, stream: dict, rng) -> Backlog:
    ratio = stream["levels"]
    cycle = split_levels(ratio, 8 * sum(int(v) for v in ratio.values()))
    return Backlog(s, int(stream["depth"]), tuple(str(x) for x in rng.permutation(cycle)),
                   int(stream["batch"]))


def plan(traffic: dict, seed: int, seconds: float) -> Plan:
    """The window's sends: the same seed, the same plan."""
    streams = traffic["streams"]
    if not 1 <= len(streams) <= 1 << (20 - STREAM_BITS):
        raise ValueError(f"{len(streams)} streams: 1 to {1 << (20 - STREAM_BITS)}")
    scheduled, backlogs = [], []
    for s, stream in enumerate(streams):
        rng = np.random.default_rng([int(seed) % (1 << 63), s])
        kind = stream["kind"]
        if kind == "poisson":
            scheduled += _poisson(s, stream, rng, seconds)
        elif kind == "backlog":
            backlogs.append(_backlog(s, stream, rng))
        else:
            raise ValueError(f"stream kind {kind!r}: one of {KINDS}")
    scheduled.sort(key=lambda a: (a.due_s, a.stream, a.index))
    return Plan(scheduled, backlogs)
