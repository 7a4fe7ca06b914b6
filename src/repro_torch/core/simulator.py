"""Discrete-event simulation of the full serverless query service.

Events: query arrivals, scheduler polls, and STAGE completions. Both
clusters are ClusterExecutors (core/engine.py): each keeps one heap of
predicted per-stage finish times, and the simulator simply wakes at the
earliest predicted stage event — no per-cluster completion dedupe is
needed because stale heap entries are epoch-invalidated inside the
executors and `advance_to` is idempotent.

Query execution times come from the deterministic stage cost model: the
analytic roofline of the pool's hardware (the H100 by default), fitted to
the card's own measured step times where a pool names its dry-run records
(``PoolSpec.dryrun_dir``; launch/dryrun.py writes them), so the simulation
and the measured hardware share one source of truth.
"""
from __future__ import annotations

import heapq
import itertools
import math
import os
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from . import sanitize
from .chaos import ChaosConfig, wire_sim_chaos
from .clusters import AutoscaleConfig, FaultModel
from .engine import StageEvent
from .events import EventFeed
from .insights import cluster_shares
from .pools import PoolSpec, build_pool, default_pool_specs
from .query import Query
from .scheduler import QueryCoordinator, ServiceLayer, unpack_fused
from .sla import Policy, ServiceLevel, SLAConfig


@dataclass
class SimConfig:
    policy: Policy = Policy.AUTO
    sla_enabled: bool = True
    sla: SLAConfig = field(default_factory=SLAConfig)
    vm_chips: int = 4  # small reserved slice (paper: one m5.8xlarge)
    vm_mode: str = "pos"  # paper's current impl: POS (Trino) in the VM
    interference_alpha: float = 0.5
    sos_slice_chips: int = 32
    cf_startup_s: float = 2.0
    elastic_price_multiplier: float = 10.0  # paper: CF is 9-24x spot VM
    seed: int = 0
    use_calibration: bool = True
    fault: FaultModel = field(default_factory=FaultModel)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    fuse_queries: bool = False  # beyond-paper: multi-query batch fusion
    #: placement-time fusion ACROSS pools (docs/fusion.md): the
    #: coordinator indexes every pool's waiting queue and merges
    #: compatible waiters into each newly placed query. Only meaningful
    #: with fuse_queries=True; off, runs are bit-identical to within-
    #: pool (pending-queue) fusion alone.
    cross_pool_fusion: bool = False
    fuse_max: int = 8  # max queries per fused batch (both fusion layers)
    horizon_s: Optional[float] = None  # stop collecting after this time
    #: decode stages are chunked to at most this many tokens, making long
    #: generations preemptible/retryable at chunk granularity (0 = off)
    decode_chunk_tokens: int = 32
    #: executor registry: a list of PoolSpecs, one pool each. None builds
    #: the paper's vm/cf pair from the legacy knobs above — bit-for-bit
    #: the two-cluster simulator.
    pools: Optional[list[PoolSpec]] = None
    #: per-pool fitted CalibrationTables keyed by pool name, injected
    #: into each pool's CostModel (core/calibration.py). Pools absent
    #: from the dict fall back to PoolSpec.dryrun_dir (fitted at build
    #: time) or the declared constants.
    calibrations: Optional[dict] = None
    #: disable the batched event drain and run the original one-event-
    #: per-heap-pop loop — the equivalence oracle tests/test_vectorized.py
    #: locks the drain against (also: REPRO_SCALAR_CORE=1)
    scalar_core: bool = False
    #: one-switch runtime sanitizer (core/sanitize.py): per-advance
    #: backlog/heap invariant checks plus post-run chip-second
    #: conservation and trace-stitching asserts. None defers to the
    #: REPRO_SANITIZE=1 environment switch; results are bit-identical
    #: with the sanitizer on or off.
    sanitize: Optional[bool] = None
    #: fault-injection harness (core/chaos.py): seeded worker deaths,
    #: provisioning stalls, persistent slow hosts. Implies an event
    #: feed — the chaos replay gate compares feed fingerprints.
    chaos: Optional[ChaosConfig] = None
    #: record every control-plane action into an EventFeed
    #: (core/events.py), returned on SimResult.events
    events: bool = False
    #: extra convergence policies per pool name (core/convergence.py
    #: SchedulePolicy / HookPolicy), appended after the reactive
    #: trigger — the pool needs autoscale.enabled for them to tick
    convergence_policies: Optional[dict] = None


@dataclass
class SimResult:
    queries: list[Query]
    cfg: SimConfig
    #: calibrated admission-control interventions (QueryCoordinator):
    #: quotes repriced at measured speed / pools routed around because
    #: their drift gate tripped — 0 when no pool armed a drift bound
    drift_reprices: int = 0
    drift_rejects: int = 0
    #: the run's audit feed (core/events.py) when SimConfig.events or
    #: chaos was on — replay gate: same cfg+seed => same fingerprint()
    events: Optional[EventFeed] = None

    def by_sla(self) -> dict[str, list[Query]]:
        out: dict[str, list[Query]] = {"imm": [], "rel": [], "boe": []}
        for q in self.queries:
            out[q.sla.short].append(q)
        return out

    def total_cost(self) -> float:
        return sum(q.cost for q in self.queries)

    def cost_by_sla(self) -> dict[str, float]:
        return {k: sum(q.cost for q in v) for k, v in self.by_sla().items()}

    def exec_time_by_sla(self) -> dict[str, float]:
        return {
            k: sum(q.exec_time or 0.0 for q in v) for k, v in self.by_sla().items()
        }

    def pending_violations(self, deadline_s: float) -> list[Query]:
        return [
            q
            for q in self.queries
            if q.effective_sla is ServiceLevel.RELAXED
            and q.pending_time is not None
            and q.pending_time > deadline_s + 1e-6
        ]

    def stage_events(self) -> list[StageEvent]:
        """The per-stage execution trace, ordered by completion time."""
        evs = [e for q in self.queries for e in q.stage_trace]
        evs.sort(key=lambda e: (e.finish, e.qid, e.index))
        return evs

    def cumulative(self, attr: str = "cost") -> dict[str, tuple[list, list]]:
        """Per-SLA (times, cumulative-values) for Fig 6/7-style curves."""
        out = {}
        for k, qs in self.by_sla().items():
            qs = [q for q in qs if q.finish_time is not None]
            qs.sort(key=lambda q: q.finish_time)
            ts, acc, tot = [], [], 0.0
            for q in qs:
                tot += getattr(q, attr) if attr == "cost" else (q.exec_time or 0.0)
                ts.append(q.finish_time)
                acc.append(tot)
            out[k] = (ts, acc)
        return out

    def summary(self) -> dict:
        by = self.by_sla()
        deadline = self.cfg.sla.relaxed_deadline_s
        cluster_share = cluster_shares(self.queries)
        out = {
            "n": len(self.queries),
            "finished": sum(q.finish_time is not None for q in self.queries),
            "total_cost": round(self.total_cost(), 2),
            "cost_by_sla": {k: round(v, 2) for k, v in self.cost_by_sla().items()},
            "exec_by_sla": {
                k: round(v, 1) for k, v in self.exec_time_by_sla().items()
            },
            "cluster_share": cluster_share,
            "violations": len(self.pending_violations(deadline)),
            "max_rel_pending": max(
                (q.pending_time or 0.0 for q in by["rel"]), default=0.0
            ),
            "mean_imm_pending": float(
                np.mean([q.pending_time or 0.0 for q in by["imm"]])
            )
            if by["imm"]
            else 0.0,
            "stages": sum(len(q.stage_trace) for q in self.queries),
            "fused_queries": sum(q.fused_with > 1 for q in self.queries),
            "preemptions": sum(q.preemptions for q in self.queries),
            "spilled": sum(q.spilled for q in self.queries),
            "spill_backs": sum(q.spill_backs for q in self.queries),
            "retries": sum(q.retries for q in self.queries),
            "drift_reprices": self.drift_reprices,
            "drift_rejects": self.drift_rejects,
        }
        if "vm" in cluster_share:  # legacy key, derived, only when real
            out["vm_share"] = cluster_share["vm"]
        return out


class Simulation:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        specs = cfg.pools
        if specs is None:
            specs = default_pool_specs(
                vm_chips=cfg.vm_chips,
                vm_mode=cfg.vm_mode,
                interference_alpha=cfg.interference_alpha,
                sos_slice_chips=cfg.sos_slice_chips,
                cf_startup_s=cfg.cf_startup_s,
                elastic_price_multiplier=cfg.elastic_price_multiplier,
                autoscale=cfg.autoscale,
            )
        # all pools share one rng: fault sampling depends only on the
        # seed and the stage execution order, not on pool membership
        self.pools = [
            build_pool(
                spec,
                use_calibration=cfg.use_calibration,
                decode_chunk_tokens=cfg.decode_chunk_tokens,
                fault=cfg.fault,
                rng=rng,
                sla=cfg.sla,
                calibration=(cfg.calibrations or {}).get(spec.name),
            )
            for spec in specs
        ]
        # explicit SimConfig.sanitize overrides the env snapshot the
        # executors were built with; None keeps REPRO_SANITIZE's word
        if cfg.sanitize is not None:
            for pool in self.pools:
                pool.sanitize = cfg.sanitize
        self.coordinator = QueryCoordinator(
            self.pools, policy=cfg.policy, cfg=cfg.sla,
            cross_pool_fusion=cfg.fuse_queries and cfg.cross_pool_fusion,
            fuse_max=cfg.fuse_max,
        )
        self.coordinator.wire_rehoming()
        # drift-gated pools feed their own measured stage walls into the
        # table's admission-control EWMA (the sim-side counterpart of
        # LiveCalibrator.observe); a pool with an observer already set
        # keeps it — external calibration loops read the same hook
        for pool in self.pools:
            table = pool.cost_model.calibration
            if (
                table is not None
                and table.drift_bound is not None
                and pool.stage_observer is None
            ):
                def _observe_drift(q, stage, ev, _table=table):
                    _table.observe_drift(stage.time_s, ev.finish - ev.start)

                pool.stage_observer = _observe_drift
        # --- convergence / chaos / audit wiring (ROADMAP item 3) ------
        self.feed: Optional[EventFeed] = None
        if cfg.events or cfg.chaos is not None:
            self.feed = EventFeed()
            for pool in self.pools:
                pool.events = self.feed
            self.coordinator.events = self.feed
        if cfg.convergence_policies:
            for name, policies in sorted(cfg.convergence_policies.items()):
                pool = next(
                    (p for p in self.pools if p.name == name), None
                )
                if pool is None:
                    raise ValueError(
                        f"convergence_policies names unknown pool {name!r}"
                    )
                if not hasattr(pool, "converger"):
                    raise ValueError(
                        f"pool {name!r} ({pool.pool_kind}) has no "
                        "convergence plane — policies drive reserved "
                        "capacity only"
                    )
                for pol in policies:
                    pool.converger.add_policy(pol)
        if cfg.chaos is not None:
            # per-pool seeded death/stall schedules + slow-host faults;
            # must precede run(): needs_tick is snapshotted there
            wire_sim_chaos(self.pools, cfg.chaos)
        self.vm = self.coordinator.vm
        self.cf = self.coordinator.cf
        self.service = ServiceLayer(
            self.coordinator, cfg.sla, cfg.sla_enabled,
            fuse=cfg.fuse_queries, fuse_max=cfg.fuse_max,
        )

    def _poll_fast_forward(self, now: float, period: float,
                           pool_bound: float, arrivals: list[Query],
                           ai: int, tick_pools: list) -> float:
        """Next poll time after a NO-OP poll: a poll that moved nothing
        stays a no-op until something observable changes — the next
        arrival, the relaxed head entering its deadline window, any
        pool's next scheduled stage completion (`pool_bound`), or a due
        autoscale action. Skip the chain to the first grid point that
        could act, stepping by repeated addition so the grid times are
        float-identical to the un-skipped 1-per-period chain."""
        t_next = now + period
        t_act = pool_bound
        if ai < len(arrivals) and arrivals[ai].submit_time < t_act:
            t_act = arrivals[ai].submit_time
        rq = self.service.relaxed.q
        if rq:
            sla = self.cfg.sla
            t_dl = (rq.head().submit_time
                    + sla.relaxed_deadline_s * sla.deadline_slack)
            if t_dl < t_act:
                t_act = t_dl
        for p in tick_pools:
            # pending scale / backlog re-eval / scheduled policy firing
            # / chaos death — the pool knows its own earliest action
            t_tick = p.next_tick_time()
            if t_tick < t_act:
                t_act = t_tick
        if t_act is math.inf:
            return t_next
        limit = t_act - 1e-9
        while t_next < limit:
            t_next += period
        return t_next

    def run(self, queries: Iterable[Query]) -> SimResult:
        cfg = self.cfg
        arrivals = sorted(queries, key=lambda q: q.submit_time)
        finished: list[Query] = []
        counter = itertools.count()
        events: list[tuple[float, int, str]] = []
        # the event loop runs millions of iterations on a 1M-query day:
        # bind the hot names locally and peek pool heaps inline (the
        # equivalent of next_event_time without two function calls per
        # pool per event)
        heappush, heappop = heapq.heappush, heapq.heappop
        pools = self.pools
        # pools with time-driven policy work between their own events
        # (autoscale is fixed at construction time)
        tick_pools = [p for p in pools if p.needs_tick]
        submit, poll = self.service.submit, self.service.poll
        poll_period = cfg.sla.poll_period_s
        n_arrivals = len(arrivals)
        scalar_core = (cfg.scalar_core
                       or os.environ.get("REPRO_SCALAR_CORE", "") == "1")

        def push(t: float, kind: str) -> None:
            heappush(events, (t, next(counter), kind))

        for q in arrivals:
            push(q.submit_time, "arrival")
        if arrivals:
            push(arrivals[0].submit_time, "poll")
        ai = 0
        # earliest scheduled stage wake-up; a new push happens only when a
        # strictly earlier stage completion appears, so the heap never
        # floods with duplicates (this replaces the old per-cluster
        # last_completion_push dedupe).
        stage_wake = math.inf

        while events:
            now, _, kind = heappop(events)
            moved = True
            reschedule_poll = False
            if kind == "stage" and now >= stage_wake - 1e-12:
                stage_wake = math.inf
            elif kind == "arrival":
                moved = False
                while ai < n_arrivals and arrivals[ai].submit_time <= now + 1e-9:
                    submit(arrivals[ai], now)
                    ai += 1
                    moved = True
            elif kind == "poll":
                moved = poll(now) > 0
                # keep polling only while something could still enter a
                # pending queue: polls act on the SLA queues alone, so
                # once they are empty and no arrival remains, no future
                # poll can ever do anything (pools drain on stage wakes)
                reschedule_poll = ai < n_arrivals or self.service.pending
            if not moved:
                # nothing entered the system this event: pool heaps are
                # exactly as the previous event left them, so the wake
                # already scheduled still stands. Only a pool with a due
                # time-driven policy action (pending capacity change,
                # backlog-trigger crossing) still needs its tick pass.
                tick_hit = False
                for p in tick_pools:
                    if p.tick_due(now):
                        tick_hit = True
                        break
                if not tick_hit:
                    if reschedule_poll:
                        push(self._poll_fast_forward(
                            now, poll_period, stage_wake, arrivals, ai,
                            tick_pools), "poll")
                    continue
            # drain every stage completion due by now (exact per-stage
            # finish times are stamped inside the executors); a pool's
            # advance may re-home a query onto ANY pool (spill /
            # spill-back), so the next-wake minimum is re-read from every
            # heap after the advances. Pools with nothing due get the
            # O(1) `tick` (apply a due capacity change, re-evaluate the
            # decaying backlog trigger) — state that admits work only
            # changes at a pool's own events, so skipping the full
            # advance is behavior-preserving.
            #
            # BATCHED DRAIN: after the advance pass, the next stage wake
            # `t` is often provably the very next event the outer heap
            # would deliver — no arrival, poll, or earlier stage event
            # can land before it (`t` is strictly below every entry in
            # `events`, and a push here would only be popped right back).
            # In that case the push+pop round trip through the event
            # heap is elided and the advance pass reruns directly at
            # `t`, so a run of pure stage-completion clusters is
            # processed in one batched inner loop. Entries in `events`
            # are totally ordered by (time, counter), so eliding an
            # entry that would be the heap minimum — and would be popped
            # before any later push — cannot reorder anything else: the
            # event sequence, and therefore every float, is bit-identical
            # to the scalar loop (cfg.scalar_core, the oracle
            # tests/test_vectorized.py asserts against).
            while True:
                due = now + 1e-9
                advanced = False
                nxt = math.inf
                for pool in pools:
                    h = pool._heap
                    while h:  # inline prune + peek
                        e = h[0]
                        if e[2].active and e[3] == e[2].epoch:
                            break
                        heappop(h)
                    if h and h[0][0] <= due:
                        finished.extend(pool.advance_to(now))
                        advanced = True
                    else:
                        if pool.needs_tick:
                            pool.tick(now)
                            while h:  # a tick may admit (pending scale)
                                e = h[0]
                                if e[2].active and e[3] == e[2].epoch:
                                    break
                                heappop(h)
                        if h and h[0][0] < nxt:
                            nxt = h[0][0]
                if advanced:
                    # an advance may have re-homed work onto ANY pool
                    # (and changed its own heap): re-read every head
                    nxt = math.inf
                    for pool in pools:
                        h = pool._heap
                        while h:
                            e = h[0]
                            if e[2].active and e[3] == e[2].epoch:
                                break
                            heappop(h)
                        if h and h[0][0] < nxt:
                            nxt = h[0][0]
                if scalar_core or reschedule_poll or nxt is math.inf:
                    # a pending poll push would change events[0] (and the
                    # poll fast-forward reads the stage_wake set below),
                    # so poll iterations always go through the heap
                    break
                t = nxt if nxt > now else now
                if t >= stage_wake - 1e-12 or (events and t >= events[0][0]):
                    # an earlier-or-equal event is already scheduled:
                    # the outer loop must deliver it first
                    break
                # elide the (t, "stage") push + its immediate pop:
                # mirrors `stage_wake = t` at push then the reset to inf
                # when the event fires
                stage_wake = math.inf
                now = t
            if nxt is not math.inf:
                t = nxt if nxt > now else now
                if t < stage_wake - 1e-12:
                    heappush(events, (t, next(counter), "stage"))
                    stage_wake = t
            if reschedule_poll:
                if moved:
                    push(now + poll_period, "poll")
                else:
                    push(self._poll_fast_forward(
                        now, poll_period, stage_wake, arrivals, ai,
                        tick_pools), "poll")

        if cfg.chaos is not None:
            # convergence epilogue: a death near the end of the day can
            # leave waiters behind capacity whose replacement lands
            # after the last heap event — keep ticking (heal, apply
            # pending scale) and draining until every pool is empty, so
            # the chaos acceptance bar ("every query terminal") holds.
            guard = 0
            while True:
                nxt = math.inf
                for pool in pools:
                    h = pool._heap
                    while h:
                        e = h[0]
                        if e[2].active and e[3] == e[2].epoch:
                            break
                        heappop(h)
                    if h and h[0][0] < nxt:
                        nxt = h[0][0]
                    if pool.run_queue_len:
                        t_tick = pool.next_tick_time()
                        if t_tick < nxt:
                            nxt = t_tick
                if nxt is math.inf:
                    break
                now = nxt if nxt > now else now
                for pool in pools:
                    if pool.tick_due(now):
                        pool.tick(now)
                    finished.extend(pool.advance_to(now))
                guard += 1
                if guard > 10_000_000:
                    raise RuntimeError(
                        "chaos epilogue made no progress — a pool is "
                        "wedged below its admission width"
                    )

        # unpack fused queries: members share times; cost splits by
        # tokens with an exact-sum repair (scheduler.unpack_fused)
        expanded: list[Query] = []
        for q in finished:
            expanded.extend(unpack_fused(q))
        if cfg.sanitize or (cfg.sanitize is None and sanitize.enabled()):
            # post-run conservation + trace-stitching asserts over the
            # unpacked population (fused members share one trace object;
            # check_result dedups by identity)
            sanitize.check_result(expanded)
        return SimResult(
            expanded, cfg,
            drift_reprices=self.coordinator.drift_reprices,
            drift_rejects=self.coordinator.drift_rejects,
            events=self.feed,
        )


def run_sim(queries: list[Query], **kw) -> SimResult:
    cfg = SimConfig(**kw)
    return Simulation(cfg).run(queries)
