"""CAB-like workload generation (paper §5.1, Table 1, Fig. 5).

Five patterns merged on one timeline simulate an organization's cloud
data warehouse. The paper's SQL-over-GB datasets map to ML-query work
sizes (DESIGN.md §2): dataset GB -> tokens scanned, per-pattern model
architecture. Counts, dataset sizes, and SLA mixes follow Table 1:

  db   size  pattern          #q   SLA mix
  db1  10GB  dashboard        720  Rel:Imm = 3:1
  db2  30GB  manual ad-hoc     34  Imm
  db3  30GB  manual daily      87  Imm:Rel = 2:1
  db4 100GB  off-peak          22  BoE
  db5 100GB  regular report    48  Rel
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from .query import Query, QueryWork
from .sla import ServiceLevel

#: tokens an ML query "scans" per GB of the paper's dataset scale
TOKENS_PER_GB = 98_304


@dataclass(frozen=True)
class PatternSpec:
    name: str
    db_gb: int
    count: int
    sla_cycle: tuple[ServiceLevel, ...]  # applied round-robin (Table 1 ratios)
    arch: str
    timing: str  # periodic | work_hours | daily_batch | off_peak | spread
    batch: int = 1
    output_tokens: int = 32


TABLE1: tuple[PatternSpec, ...] = (
    PatternSpec(
        "dashboard", 10, 720,
        (ServiceLevel.RELAXED,) * 3 + (ServiceLevel.IMMEDIATE,),
        arch="qwen2-0.5b", timing="periodic", output_tokens=16,
    ),
    PatternSpec(
        "manual_adhoc", 30, 34,
        (ServiceLevel.IMMEDIATE,),
        arch="internlm2-1.8b", timing="work_hours", output_tokens=64,
    ),
    PatternSpec(
        "manual_daily", 30, 87,
        (ServiceLevel.IMMEDIATE,) * 2 + (ServiceLevel.RELAXED,),
        arch="granite-8b", timing="work_hours", output_tokens=64,
    ),
    PatternSpec(
        "off_peak", 100, 22,
        (ServiceLevel.BEST_EFFORT,),
        arch="mixtral-8x7b", timing="off_peak", batch=4, output_tokens=128,
    ),
    PatternSpec(
        "regular_report", 100, 48,
        (ServiceLevel.RELAXED,),
        arch="phi3.5-moe-42b-a6.6b", timing="spread", batch=2, output_tokens=128,
    ),
)


def scaled_patterns(
    factor: float, patterns: tuple[PatternSpec, ...] = TABLE1
) -> tuple[PatternSpec, ...]:
    """Table 1 with query counts scaled by `factor` (SLA mixes and timing
    shapes preserved) — the organization-of-N-users knob for scale runs."""
    return tuple(
        replace(p, count=max(1, int(round(p.count * factor)))) for p in patterns
    )


def _arrival_times(
    spec: PatternSpec, horizon: float, rng: np.random.Generator
) -> np.ndarray:
    n = spec.count
    if spec.timing == "periodic":
        # dashboards refresh in synchronized rounds -> bursty spikes
        rounds = max(1, n // 12)
        starts = np.linspace(0, horizon, rounds, endpoint=False)
        per = int(math.ceil(n / rounds))
        times = (starts[:, None] + rng.uniform(0, 5.0, (rounds, per))).ravel()[:n]
        return times
    if spec.timing == "work_hours":  # two Gaussian bursts (morning/afternoon)
        centers = rng.choice([0.35, 0.65], size=n)
        return np.clip(rng.normal(centers, 0.08) * horizon, 0, horizon * 0.999)
    if spec.timing == "off_peak":  # night window
        return rng.uniform(0.82, 0.98, n) * horizon
    if spec.timing == "daily_batch":
        return np.full(n, 0.30 * horizon) + rng.uniform(0, 60, n)
    # spread: low-rate Poisson across the day
    return np.sort(rng.uniform(0, horizon, n))


def generate(
    horizon_s: float = 14_400.0,  # a compressed "day" (4h), configurable
    seed: int = 0,
    patterns: tuple[PatternSpec, ...] = TABLE1,
    tokens_per_gb: int = TOKENS_PER_GB,
) -> list[Query]:
    """The merged query stream (Fig. 5).

    Generation is vectorized per pattern: one rng draw per pattern
    (`_arrival_times`), one shared `QueryWork` per pattern (works are
    value-compared and never mutated, so every query of a pattern can
    reference the same instance — on a 1M-query day this removes a
    million identical dataclass constructions), and the SLA round-robin
    is materialized as one repeated list instead of an i%k per query.
    Query objects (identity-keyed, mutated by the run) are still built
    one per query, in the same order as the original per-query loop, so
    qids and float submit times are bit-identical."""
    rng = np.random.default_rng(seed)
    queries: list[Query] = []
    for spec in patterns:
        times = np.sort(_arrival_times(spec, horizon_s, rng)).tolist()
        prompt = spec.db_gb * tokens_per_gb // max(spec.batch, 1)
        work = QueryWork(
            arch=spec.arch,
            kind="serve",
            batch=spec.batch,
            prompt_tokens=int(prompt),
            output_tokens=spec.output_tokens,
        )
        n = len(times)
        cycle = list(spec.sla_cycle)
        slas = cycle * (n // len(cycle) + 1)  # == sla_cycle[i % k] per i
        name = spec.name
        queries.extend(
            Query(work=work, sla=sla, submit_time=t, source=name)
            for t, sla in zip(times, slas)
        )
    queries.sort(key=lambda q: q.submit_time)
    return queries


def stream_histogram(queries: list[Query], horizon_s: float, bins: int = 48):
    """Fig 5-style arrival histogram per pattern."""
    edges = np.linspace(0, horizon_s, bins + 1)
    out = {}
    for name in sorted({q.source for q in queries}):
        ts = [q.submit_time for q in queries if q.source == name]
        hist, _ = np.histogram(ts, bins=edges)
        out[name] = hist.tolist()
    return out, edges.tolist()
