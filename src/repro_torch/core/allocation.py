"""Per-query chips-per-stage allocation from the calibrated cost model.

Kassing et al. ("Resource Allocation in Serverless Query Processing")
show per-query resource allocation is where a serverless engine wins or
loses money, and the paper's flexible-SLA menu only prices honestly when
each service level is quoted at *its own* cheapest allocation that still
meets the level's guarantee. This module makes slice width a per-query
decision instead of a per-pool constant:

``Allocator`` sweeps the latency/cost frontier of one (work shape, pool)
pair over a ``min_chips..max_chips`` grid of slice widths, planning each
width through the pool's own calibrated ``CostModel``, and picks per
service level:

  IMMEDIATE   — the cheapest width whose full-plan execution time meets
                ``imm_exec_target_s``; with no target (or none meets
                it), the latency-optimal point: IMMEDIATE buys wider
                slices than BEST_EFFORT for identical work.
  RELAXED     — the cheapest width meeting ``rel_exec_target_s``;
                otherwise it degrades to the cost-optimal point (the
                pending queue, not the slice, absorbs its deadline).
  BEST_EFFORT — the cost-optimal point, always.

The sweep is only meaningful on a cost model with a nonzero
``parallel_overhead``: the pure roofline is exactly linear in chips, so
chip-seconds — and therefore cost — are width-independent and every
width ties (the choice then falls to the deterministic tie-break: equal
cost resolves to the faster, then narrower width, so the degenerate
frontier collapses to "always widest" — wider is free).

Choices are memoized per (work shape, service level) and validated
against ``CalibrationTable.version`` exactly like the plan cache they
sit on, so a calibration hot swap re-runs the sweep on the very next
query. Pool-load dependence enters one layer up: the executors' static
quotes cache the chosen width's plan keyed by (version, load_epoch,
level) — see ``engine.ClusterExecutor._static_quote``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from .sla import ServiceLevel

if TYPE_CHECKING:  # pragma: no cover — import cycle guard
    from .cost_model import CostModel
    from .query import QueryWork


@dataclass(frozen=True)
class AllocationPoint:
    """One point on a (work shape, pool) latency/cost frontier."""

    chips: int
    exec_s: float  # full-plan execution time at this width
    chip_seconds: float  # billed chip-seconds (∝ cost at the pool price)


@dataclass(frozen=True)
class AllocationConfig:
    """Per-pool allocation bounds: the width grid the frontier sweep
    covers, plus optional per-level execution-time targets the chosen
    width must meet (``PoolSpec.allocation`` carries one of these)."""

    min_chips: int = 4
    max_chips: int = 64
    step_chips: int = 4
    #: cheapest width whose exec time meets this, else latency-optimal
    imm_exec_target_s: Optional[float] = None
    #: cheapest width meeting this, else the cost-optimal point
    rel_exec_target_s: Optional[float] = None

    def __post_init__(self):
        if self.min_chips < 1:
            raise ValueError(f"min_chips must be >= 1, got {self.min_chips}")
        if self.max_chips < self.min_chips:
            raise ValueError(
                f"max_chips ({self.max_chips}) < min_chips ({self.min_chips})"
            )
        if self.step_chips < 1:
            raise ValueError(f"step_chips must be >= 1, got {self.step_chips}")

    def widths(self) -> tuple[int, ...]:
        """The sweep grid: min..max by step, with max always included
        (a ragged last step must not silently drop the widest point —
        the latency-optimal pick usually lives there)."""
        ws = list(range(self.min_chips, self.max_chips + 1, self.step_chips))
        if ws[-1] != self.max_chips:
            ws.append(self.max_chips)
        return tuple(ws)


class Allocator:
    """Frontier sweep + per-level width choice for one pool's cost model.

    Attached to an executor as ``pool.allocator`` (build_pool does this
    when ``PoolSpec.allocation`` is set); the executor's ``_plan_chips``
    consults it, so quotes, spill thresholds, and execution all plan at
    the same chosen width through the one ``effective_chips`` accessor.
    """

    #: memo guard against unbounded work-shape variety (same discipline
    #: as the executors' static-quote cache)
    MEMO_MAX = 4096

    def __init__(self, cost_model: "CostModel", config: AllocationConfig):
        self.cost_model = cost_model
        self.config = config
        # (work shape, level) -> (plan version, chosen width)
        self._memo: dict[tuple, tuple[int, int]] = {}
        self.choose_hits = 0
        self.choose_misses = 0

    def frontier(self, work: "QueryWork") -> list[AllocationPoint]:
        """Plan the work at every grid width. Each width's plan lands in
        the cost model's LRU plan cache, so repeated sweeps over the
        same work shapes stay cached."""
        pts = []
        for w in self.config.widths():
            plan = self.cost_model.plan(work, w)
            pts.append(AllocationPoint(w, plan.exec_time, plan.chip_seconds))
        return pts

    def stats(self) -> dict:
        return {
            "hits": self.choose_hits,
            "misses": self.choose_misses,
            "size": len(self._memo),
        }

    def choose(self, work: "QueryWork", level: ServiceLevel) -> int:
        """The chosen width for (work, level) — memoized per work shape
        and validated against the calibration version, so a hot swap
        re-sweeps on the next call. Width is chosen from the FULL plan's
        execution time (cursor-independent): a preempted or spilled-back
        query resumes at the same width it started at."""
        key = (work.arch, work.kind, work.batch, work.prompt_tokens,
               work.output_tokens, work.train_steps, work.seq_len,
               int(level))
        ver = self.cost_model.plan_version()
        hit = self._memo.get(key)
        if hit is not None and hit[0] == ver:
            self.choose_hits += 1
            return hit[1]
        self.choose_misses += 1
        chips = self._pick(self.frontier(work), ServiceLevel(int(level)))
        if len(self._memo) > self.MEMO_MAX:
            self._memo.clear()
        self._memo[key] = (ver, chips)
        return chips

    def _pick(self, pts: list[AllocationPoint], level: ServiceLevel) -> int:
        # deterministic tie-breaks: cost picks prefer the narrower
        # width, latency picks the cheaper one, then narrower
        cheapest = min(pts, key=lambda p: (p.chip_seconds, p.exec_s, p.chips))
        if level is ServiceLevel.BEST_EFFORT:
            return cheapest.chips
        target = (
            self.config.imm_exec_target_s
            if level is ServiceLevel.IMMEDIATE
            else self.config.rel_exec_target_s
        )
        if target is not None:
            ok = [p for p in pts if p.exec_s <= target]
            if ok:
                return min(
                    ok, key=lambda p: (p.chip_seconds, p.exec_s, p.chips)
                ).chips
        if level is ServiceLevel.RELAXED:
            # no target, or none meets it: the relaxed pending queue
            # absorbs the deadline — degrade to the cost-optimal point
            return cheapest.chips
        # IMMEDIATE with no feasible target: latency-optimal
        return min(pts, key=lambda p: (p.exec_s, p.chip_seconds, p.chips)).chips
