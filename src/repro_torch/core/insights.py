"""Cost visibility + price estimation — the user-facing features the
paper's user study ranked alongside flexible SLAs (Q6: absolute
performance-price estimates, 67.9% would use; Q7: historical cost
analysis, 69.7% — §3.2/Fig 1) and the PixelsDB Web UI exposes via
brushing-and-linking. Programmatic equivalents over Query traces.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np

from .cost_model import CostModel
from .query import Query, QueryWork
from .sla import ServiceLevel


# ---------------------------------------------------------------------------
# Q6: absolute performance-price menu per service level
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Quote:
    sla: str
    est_pending_s: float  # worst-case pending under the level's guarantee
    est_exec_s: float
    est_cost: float
    pool: str = ""  # registry pool backing the estimate

    def as_dict(self) -> dict:
        return {
            "sla": self.sla,
            "est_pending_s": round(self.est_pending_s, 2),
            "est_exec_s": round(self.est_exec_s, 2),
            "est_cost": round(self.est_cost, 4),
            "pool": self.pool,
        }


@dataclass(frozen=True)
class _PoolRow:
    """One pool's (exec time, cost) for the work — the raw frontier."""

    name: str
    kind: str  # reserved | elastic
    exec_s: float
    cost: float


def _menu_from_rows(rows: list[_PoolRow], relaxed_deadline_s: float) -> list[Quote]:
    """Fold per-pool rows into the three-level menu. Immediate may land
    on the burst tier under load, so it is priced at the WORST elastic
    cost while quoting the fastest execution anywhere; relaxed/BoE run
    on the cheapest cost-efficient pool."""
    elastic = [r for r in rows if r.kind == "elastic"] or rows
    reserved = [r for r in rows if r.kind == "reserved"] or rows
    imm_price = max(elastic, key=lambda r: r.cost)
    imm_exec = min(rows, key=lambda r: r.exec_s)
    cheap = min(reserved, key=lambda r: r.cost)
    return [
        Quote("immediate", 0.0, imm_exec.exec_s, imm_price.cost,
              pool=imm_price.name),
        Quote("relaxed", relaxed_deadline_s, cheap.exec_s, cheap.cost,
              pool=cheap.name),
        Quote("best_effort", float("inf"), cheap.exec_s, cheap.cost,
              pool=cheap.name),
    ]


def price_menu(
    work: QueryWork,
    *,
    pools: Optional[Iterable] = None,
    cost_model: Optional[CostModel] = None,
    calibration=None,
    vm_chips: int = 4,
    cf_chips: int = 32,
    vm_price_per_chip_s: float = 1.2 / 3600,
    cf_multiplier: float = 10.0,
    relaxed_deadline_s: float = 300.0,
) -> list[Quote]:
    """The menu a user sees before choosing a service level: each level's
    worst-case pending time, estimated execution time, and price. Made
    possible by the deterministic SOS cost model (paper §3.3 vision 1).

    With ``pools`` — any executor registry, simulated (build_pool) or
    live (LiveEngine.pools) — the frontier is quoted per pool: each
    pool's own cost model, slice sizing (``effective_chips``) and unit
    price produce one row, and ``Quote.pool`` names the pool backing
    each level's PRICE (the immediate row's exec time is the fastest
    pool's, which may be a different pool). Without it, the legacy
    vm/cf knob pair prices the same rows as before — identical
    estimates whenever the elastic pool is the faster one (true for the
    default knobs: cf_chips > vm_chips)."""
    if calibration is not None and (pools is not None or cost_model is not None):
        raise ValueError(
            "calibration only corrects the legacy knob pair — registry "
            "pools (and explicit cost models) carry their own calibrated "
            "models; a silently-ignored calibration would quote "
            "uncorrected prices"
        )
    if pools is not None:
        pools = list(pools)
        if not pools:
            raise ValueError("price_menu needs at least one pool")

        def rows_at(level: ServiceLevel) -> list[_PoolRow]:
            probe = Query(work=work, sla=level, submit_time=0.0)
            rows = []
            for p in pools:
                chips = p.effective_chips(probe)
                plan = p.cost_model.plan(work, chips)
                rows.append(_PoolRow(
                    name=p.name,
                    kind=p.pool_kind,
                    exec_s=plan.exec_time,
                    cost=plan.chip_seconds * p.price_per_chip_s,
                ))
            return rows

        if not any(getattr(p, "allocator", None) is not None for p in pools):
            # fixed-knob registry: one probe prices every level —
            # byte-identical to the pre-allocator menu
            return _menu_from_rows(
                rows_at(ServiceLevel.BEST_EFFORT), relaxed_deadline_s
            )
        # per-query allocation: each level's row set is priced at the
        # width the allocator would actually buy for THAT level, so the
        # menu can no longer disagree with execution (the old single
        # BEST_EFFORT probe quoted every level at the cost-optimal width)
        imm = _menu_from_rows(
            rows_at(ServiceLevel.IMMEDIATE), relaxed_deadline_s
        )[0]
        rel = _menu_from_rows(
            rows_at(ServiceLevel.RELAXED), relaxed_deadline_s
        )[1]
        boe = _menu_from_rows(
            rows_at(ServiceLevel.BEST_EFFORT), relaxed_deadline_s
        )[2]
        return [imm, rel, boe]
    # legacy knob pair: an explicit CalibrationTable corrects both rows
    # (registry pools carry their own calibrated models instead)
    cm = cost_model or CostModel(calibration=calibration)
    rows = [
        _PoolRow("vm", "reserved", cm.exec_time(work, vm_chips),
                 cm.chip_seconds(work, vm_chips) * vm_price_per_chip_s),
        _PoolRow("cf", "elastic", cm.exec_time(work, cf_chips),
                 cm.chip_seconds(work, cf_chips) * vm_price_per_chip_s * cf_multiplier),
    ]
    return _menu_from_rows(rows, relaxed_deadline_s)


# ---------------------------------------------------------------------------
# Q7: historical cost visibility (brushing-and-linking equivalent)
# ---------------------------------------------------------------------------

def cluster_shares(
    queries: Iterable[Query], ndigits: Optional[int] = None
) -> dict[str, float]:
    """Per-pool placement shares over ``q.cluster`` (unplaced -> "?") —
    the registry-shaped replacement for the hardcoded ``q.cluster ==
    "vm"`` share, shared by CostExplorer.aggregate and
    SimResult.summary."""
    qs = list(queries)
    counts: dict[str, int] = {}
    for q in qs:
        counts[q.cluster or "?"] = counts.get(q.cluster or "?", 0) + 1
    n = max(1, len(qs))
    return {
        name: (round(c / n, ndigits) if ndigits is not None else c / n)
        for name, c in sorted(counts.items())
    }

class CostExplorer:
    """Filter/aggregate finished queries the way the Web UI's linked
    views do: brush on any dimension, read the aggregates."""

    def __init__(self, queries: Iterable[Query]):
        self.queries = [q for q in queries if q.finish_time is not None]

    def brush(self, **filters) -> "CostExplorer":
        """Filter by exact attribute values (sla, cluster, source) or
        callable predicates, e.g. brush(cluster="cf", source="dashboard")
        or brush(cost=lambda c: c > 1.0)."""
        out = self.queries
        for key, want in filters.items():
            if callable(want):
                out = [q for q in out if want(getattr(q, key))]
            elif key == "sla":
                want_lvl = (
                    want if isinstance(want, ServiceLevel)
                    else ServiceLevel[want.upper()]
                    if isinstance(want, str) and want.upper() in ServiceLevel.__members__
                    else want
                )
                out = [
                    q for q in out
                    if q.sla is want_lvl or q.sla.short == str(want)
                ]
            else:
                out = [q for q in out if getattr(q, key) == want]
        e = CostExplorer([])
        e.queries = list(out)
        return e

    def aggregate(self) -> dict:
        qs = self.queries
        if not qs:
            return {"n": 0, "total_cost": 0.0}
        costs = np.array([q.cost for q in qs])
        execs = np.array([q.exec_time or 0.0 for q in qs])
        pend = np.array([q.pending_time or 0.0 for q in qs])
        # per-pool placement shares: an N-pool registry has no special
        # "vm" — the old hardcoded `q.cluster == "vm"` share read 0 for
        # any registry without that name
        cluster_share = cluster_shares(qs, ndigits=3)
        out = {
            "n": len(qs),
            "total_cost": round(float(costs.sum()), 4),
            "mean_cost": round(float(costs.mean()), 4),
            "p95_cost": round(float(np.percentile(costs, 95)), 4),
            "total_exec_s": round(float(execs.sum()), 1),
            "p95_exec_s": round(float(np.percentile(execs, 95)), 2),
            "p95_pending_s": round(float(np.percentile(pend, 95)), 2),
            "cluster_share": cluster_share,
        }
        if "vm" in cluster_share:  # legacy key, derived, only when real
            out["vm_share"] = cluster_share["vm"]
        return out

    def by(self, attr: str) -> dict[str, dict]:
        """Group-by + aggregate (the "linking" half)."""
        groups: dict[str, list[Query]] = {}
        for q in self.queries:
            val = getattr(q, attr)
            key = val.short if isinstance(val, ServiceLevel) else str(val)
            groups.setdefault(key, []).append(q)
        return {k: CostExplorer(v).aggregate() for k, v in sorted(groups.items())}

    def top(self, n: int = 10, key: str = "cost") -> list[Query]:
        return sorted(self.queries, key=lambda q: -getattr(q, key))[:n]


# ---------------------------------------------------------------------------
# Observability: structured trace export
# ---------------------------------------------------------------------------

def export_trace(queries: Iterable[Query], path: str) -> int:
    """JSONL query trace (one record per query) for offline analysis."""
    n = 0
    with open(path, "w") as f:
        for q in queries:
            f.write(json.dumps({
                "qid": q.qid,
                "source": q.source,
                "arch": q.work.arch,
                "sla": q.sla.short,
                "effective_sla": q.effective_sla.short if q.effective_sla else None,
                "submit": q.submit_time,
                "dequeue": q.dequeue_time,
                "start": q.start_time,
                "finish": q.finish_time,
                "cluster": q.cluster,
                "chip_seconds": round(q.chip_seconds, 4),
                "cost": round(q.cost, 6),
                "retries": q.retries,
                "stages": len(q.stage_trace),
                "preemptions": q.preemptions,
                "spilled": q.spilled,
                "spill_backs": q.spill_backs,
            }) + "\n")
            n += 1
    return n
