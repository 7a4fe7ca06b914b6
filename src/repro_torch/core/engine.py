"""Stage-level execution engine: StagePlan is the unit of scheduling.

The paper's SOS argument (§4.3/§5.3) is that each query *stage* runs on an
isolated slice with a deterministic cost — that property is what makes
pending-time SLAs and admission-time price quotes tractable. This module
makes the runtime honor it: a running query is a cursor over its
``StagePlan`` (``Query.stage_cursor``), and both clusters drive execution
through one ``ClusterExecutor`` base whose core is a heap of predicted
per-stage completion times.

Heap discipline: every running stage has exactly one *valid* heap entry;
entries are lazily invalidated by bumping ``_Run.epoch`` whenever a
prediction changes (processor-sharing rate changes, preemption, spill),
so reschedules are O(log n) pushes and stale entries are skipped on pop.
This replaces the O(n) list scans the clusters used to do per event and
the ``last_completion_push`` dedupe hack the simulator needed on top.

Hot-path complexity (the 1M-query-day requirement, benchmarks/scale.py):
every per-event query is O(1) —

  * ``predicted_backlog_cs`` is an incrementally maintained counter, not
    an O(running + waiting) scan. Each run's current-stage prediction is
    stored as the pair ``(t_finish * burn, burn)`` so the remaining
    chip-seconds at time ``now`` are ``sum(t_finish*burn) - now *
    sum(burn)`` — time-parametric, no decay bookkeeping to settle, and
    each retired run removes exactly the terms it added. Waiting queries
    and unstarted stages contribute version-tracked static sums. The
    old scan survives as ``predicted_backlog_scan_cs`` and a debug mode
    (``DEBUG_BACKLOG`` / ``check_backlog_invariant``) asserts the two
    agree after every advance — the hypothesis suite runs with it on.
  * quotes read a per-pool static cache (remaining exec time +
    chip-seconds at the pool's slice) keyed by the work shape and stage
    cursor, invalidated off ``CalibrationTable.version`` and the pool's
    ``load_epoch`` (bumped when capacity changes), so the coordinator's
    all-pools quote loop re-plans only when planning inputs change.
  * ``waiting`` is a ``WaitingQueue``: still a list (external code may
    append to it directly), but every mutation keeps per-service-level
    FIFO lanes and counts in sync, so the SOS priority pop selects its
    candidate in O(1) (the dense-list removal is a C memmove) and the
    displacing-waiter check is O(1) instead of an O(waiting) scan.

Stage boundaries are where policy acts:
  * preemption — a BEST_EFFORT query marked ``preempt_requested`` stops
    at its next boundary and re-enters the waiting queue with its cursor
    (and billed chip-seconds) intact;
  * cross-cluster spill — the coordinator may hand the remaining stages
    of a VM query to the elastic cluster (re-planned for the elastic
    slice size, billed at the elastic rate from that stage on);
  * fault recovery — the fault model is sampled per stage, so a retry
    re-runs (and re-bills) only the failed stage.
"""
from __future__ import annotations

import heapq
import itertools
import math
import os
from collections import deque
from typing import Callable, NamedTuple, Optional

import numpy as np

from . import sanitize
from .cost_model import CostModel, Stage, StagePlan
from .query import Query
from .sla import ServiceLevel

#: when true, every ``advance_to`` re-derives the backlog with the full
#: O(running + waiting) scan and asserts it matches the incremental
#: counter — the equivalence lock the hypothesis suite runs under.
#: ``REPRO_SANITIZE=1`` (core/sanitize.py) implies it per-pool via the
#: executor's ``sanitize`` flag without flipping this global.
DEBUG_BACKLOG = os.environ.get("REPRO_DEBUG_BACKLOG", "") == "1"

_BOE = int(ServiceLevel.BEST_EFFORT)


class StageEvent(NamedTuple):
    """One completed stage execution — the per-stage trace record.
    A NamedTuple, not a dataclass: a 1M-query day creates millions of
    these and tuple construction is several times cheaper."""

    qid: int
    stage: str
    index: int  # position in the query's StagePlan
    cluster: str
    start: float
    finish: float
    chips: int
    chip_seconds: float  # billed (includes retry re-runs / speculation)
    cost: float
    retries: int


def account_stage(
    q: Query,
    stage: str,
    cluster: str,
    start: float,
    finish: float,
    chips: int,
    billed_cs: float,
    price_per_chip_s: float,
    retries: int = 0,
) -> StageEvent:
    """Record one completed stage on the query: bill the chip-seconds,
    add the cost, append the trace event, advance the cursor. Both the
    simulated executors and the live engine (core/live.py) account
    through this one helper, so live billing is the same per-stage
    arithmetic the simulator's conservation tests lock down."""
    cost = billed_cs * price_per_chip_s
    q.chip_seconds += billed_cs
    q.cost += cost
    ev = StageEvent(q.qid, stage, q.stage_cursor, cluster, start, finish,
                    chips, billed_cs, cost, retries)
    q.stage_trace.append(ev)
    q.stage_cursor += 1
    return ev


class _Run:
    """Execution state of the CURRENT stage of one admitted query."""

    __slots__ = (
        "query", "plan", "chips", "remaining", "rate", "last_update",
        "epoch", "active", "stage_start", "billed_cs", "stage_retries",
        "preempt_requested",
        # incremental-backlog terms this run currently contributes
        # (engine-private; see ClusterExecutor._bl_* helpers)
        "bl_state", "bl_cur", "bl_tf_burn", "bl_burn", "bl_unstarted",
        "bl_token", "plan_ver",
    )

    def __init__(self, query: Query, plan: StagePlan, chips: int):
        self.query = query
        self.plan = plan
        self.chips = chips
        self.remaining = 0.0  # work left in this stage (units set by rate)
        self.rate = 1.0  # work units consumed per second
        self.last_update = 0.0
        self.epoch = 0  # bumped on every (re)prediction
        self.active = True
        self.stage_start = 0.0
        self.billed_cs = 0.0
        self.stage_retries = 0
        self.preempt_requested = False
        self.bl_state = 0  # 0 = no terms, 1 = future (unstarted), 2 = active
        self.bl_cur = 0.0
        self.bl_tf_burn = 0.0
        self.bl_burn = 0.0
        self.bl_unstarted = 0.0
        self.bl_token = 0
        self.plan_ver = -1


class WaitingQueue(list):
    """``pool.waiting``: still a list — external code (tests, policy
    snapshots) may read or append to it directly — but every mutation
    also maintains per-service-level FIFO lanes and counts, and fires
    the owner's hooks (incremental backlog, cross-pool fusion index).
    ``pop_best`` replaces the SOS slice-handoff's O(n) min scan."""

    __slots__ = ("_owner", "_seq", "_lanes", "_live", "_by_seq", "counts")

    def __init__(self, owner: "ClusterExecutor"):
        super().__init__()
        self._owner = owner
        self._seq = itertools.count()
        # lanes hold seqs, resolved through _by_seq at pop time: the
        # indirection is what lets `replace` keep a lane slot while
        # swapping the query occupying it
        self._lanes: tuple[deque, ...] = (deque(), deque(), deque())
        self._live: dict[Query, int] = {}  # query -> its live lane seq
        self._by_seq: dict[int, Query] = {}  # lane seq -> current query
        self.counts = [0, 0, 0]  # waiting queries per service level

    # --- internal bookkeeping ----------------------------------------
    def _track(self, q: Query) -> None:
        seq = next(self._seq)
        self._live[q] = seq
        self._by_seq[seq] = q
        lvl = q.current_sla  # IntEnum: indexes lanes/counts directly
        self._lanes[lvl].append(seq)
        self.counts[lvl] += 1
        self._owner._wait_added(q)

    def _untrack(self, q: Query) -> None:
        seq = self._live.pop(q)
        del self._by_seq[seq]
        lvl = q.current_sla
        self.counts[lvl] -= 1
        # reclaim dead entries at the lane head: FIFO pools (elastic,
        # POS) drain via pop(0) and never visit pop_best's lazy cleanup,
        # so without this sweep their lanes would grow one dead cell per
        # query forever. Amortized O(1): each entry is swept once.
        lane = self._lanes[lvl]
        by_seq = self._by_seq
        while lane and lane[0] not in by_seq:
            lane.popleft()
        self._owner._wait_removed(q)

    # --- list mutators, kept in sync ---------------------------------
    def append(self, q: Query) -> None:
        super().append(q)
        self._track(q)

    def extend(self, qs) -> None:
        for q in qs:
            self.append(q)

    def insert(self, i: int, q: Query) -> None:
        super().insert(i, q)
        self._track(q)

    def remove(self, q: Query) -> None:
        super().remove(q)
        self._untrack(q)

    def pop(self, i: int = -1) -> Query:
        q = super().pop(i)
        self._untrack(q)
        return q

    def clear(self) -> None:
        while self:
            self.pop()

    def peek_best(self) -> Query:
        """The query ``pop_best`` would return, without removing it —
        variable-width admission must price the head's slice before
        committing to start it."""
        by_seq = self._by_seq
        for lane in self._lanes:
            while lane:
                q = by_seq.get(lane[0])
                if q is None:
                    lane.popleft()  # stale: removed through another path
                    continue
                return q
        raise IndexError("peek_best from an empty waiting queue")

    # --- priority pop (SOS slice handoff) ----------------------------
    def pop_best(self) -> Query:
        """Earliest-enqueued query of the most urgent waiting level —
        exactly ``min(waiting, key=(sla, insertion index))``. Candidate
        selection is O(1) from the lanes; the dense-list removal below
        is an O(queue) C-level memmove (kept: the list API is what
        external code and the scan paths read)."""
        by_seq = self._by_seq
        for lane in self._lanes:
            while lane:
                q = by_seq.get(lane[0])
                if q is None:
                    lane.popleft()  # stale: removed through another path
                    continue
                lane.popleft()
                list.remove(self, q)
                self._untrack(q)
                return q
        raise IndexError("pop_best from an empty waiting queue")


class ClusterExecutor:
    """Base for both clusters: admission + per-stage completion queue.

    Subclasses implement ``_admit`` (capacity policy), ``_plan_chips``
    (slice sizing) and may override ``_stage_work`` (fault sampling),
    ``_run_rate``/``_rates_changed`` (processor sharing) and
    ``_continue_run`` (stage-boundary preemption/spill policy).

    As a POOL in the coordinator's registry, an executor also answers
    placement questions: ``quote(q)`` prices the query's remaining
    stages at the pool's current load, ``predicted_backlog_cs`` is the
    incrementally-maintained chip-seconds committed to the pool (the
    backlog-driven autoscale signal), and ``rehome`` — wired by the
    coordinator — may move a query to another pool at any stage
    boundary (spill, spill-back).
    """

    name = "?"
    #: "reserved" pools are bounded and cheap (the cost-efficient tier);
    #: "elastic" pools are unbounded burst capacity at a premium price.
    pool_kind = "reserved"
    #: whether the simulator must `tick` this pool on events that are
    #: not its own (only pools with time-decaying policy signals —
    #: backlog-triggered autoscale, injected chaos — need it)
    needs_tick = False
    #: audit event feed (core/events.py), attached by the simulation /
    #: live engine when event recording is on; None costs nothing
    events = None
    #: injected fault schedule (core/chaos.py PoolChaos) and its next
    #: due death — wired by chaos.wire_sim_chaos on reserved pools
    _chaos = None
    _chaos_next = math.inf

    def __init__(
        self,
        cost_model: Optional[CostModel] = None,
        fault=None,
        rng: Optional[np.random.Generator] = None,
        price_per_chip_s: float = 0.0,
    ):
        self.cost_model = cost_model or CostModel()
        self.fault = fault
        self.rng = rng or np.random.default_rng(0)
        self.price_per_chip_s = price_per_chip_s
        #: one-switch runtime sanitizer (core/sanitize.py): when set,
        #: every advance_to re-checks the backlog and heap invariants,
        #: exactly as DEBUG_BACKLOG does globally. Observers only —
        #: results are bit-identical either way.
        self.sanitize = sanitize.enabled()
        # insertion-ordered for deterministic iteration, O(1) removal
        self.running: dict[_Run, None] = {}
        self.waiting: list[Query] = WaitingQueue(self)
        self._heap: list[tuple[float, int, _Run, int]] = []
        self._seq = itertools.count()
        self.stages_completed = 0
        #: bumped whenever the pool's planning inputs change (capacity /
        #: slice size); static-quote cache entries are validated against
        #: it together with the calibration version
        self.load_epoch = 0
        self._quote_cache: dict[tuple, tuple] = {}
        #: per-query width chooser (core/allocation.py), attached by
        #: build_pool when the pool's spec carries AllocationConfig;
        #: None keeps the pool's fixed slice sizing
        self.allocator = None
        #: runs currently flagged for stage-boundary preemption — lets
        #: the per-admission preempt bookkeeping skip its O(running)
        #: scan whenever flags already match the waiting IMMEDIATEs
        self._flagged: set[_Run] = set()
        #: cross-pool fusion index hook (scheduler.CrossPoolFusionIndex),
        #: wired by the coordinator when placement-time fusion is on;
        #: told about every waiting-queue add/remove
        self.wait_observer = None
        #: stage-boundary re-placement hook, wired by the coordinator:
        #: (query, now) -> target pool, or None to keep the query here
        self.rehome: Optional[Callable[[Query, float], Optional["ClusterExecutor"]]] = None
        #: observation hook called after every completed stage with
        #: (query, planned_stage, event) — how a calibration loop reads
        #: this pool's predicted-vs-actual stage walls without touching
        #: the accounting path (core/calibration.py, benchmarks)
        self.stage_observer: Optional[Callable[[Query, Stage, StageEvent], None]] = None
        # --- incremental backlog counter (predicted_backlog_cs) -------
        self._bl_wait_map: dict[int, float] = {}  # qid -> remaining cs
        self._bl_wait_cs = 0.0
        self._bl_unstarted_cs = 0.0
        self._bl_tf_burn = 0.0  # sum over started runs: t_finish * burn
        self._bl_burn = 0.0  # sum over started runs: burn (cs per second)
        self._bl_future: list[tuple[float, int, _Run]] = []  # startup leads
        self._bl_future_cs = 0.0
        self._bl_now = 0.0  # latest time this pool has observed
        self._bl_ver = -1  # calibration version the wait sums were built at
        #: earliest time a backlog-triggered autoscale verdict can change
        #: passively (clusters.CostEfficientCluster.tick); any backlog
        #: mutation resets it to 0 = "re-evaluate at the next event"
        self._as_next_eval = 0.0

    # --- queue state the coordinator watches -------------------------
    @property
    def run_queue_len(self) -> int:
        return len(self.running) + len(self.waiting)

    @property
    def idle(self) -> bool:
        return self.run_queue_len == 0

    def has_displacing_waiter(self, q: Query) -> bool:
        """Whether a waiting non-BEST_EFFORT query at least as urgent as
        `q` has no slice (the spill trigger) — O(1) from the waiting
        queue's per-level counts instead of an O(waiting) scan."""
        counts = self.waiting.counts
        lvl = int(q.current_sla)
        return any(counts[l] for l in range(lvl + 1) if l != _BOE)

    # --- placement interface (the coordinator's registry view) -------
    def effective_chips(self, q: Query) -> int:
        """The slice size EVERY planning path uses for this query on this
        pool — quotes, spill thresholds, and execution must all plan with
        the same chips, so they share this one accessor."""
        return self._plan_chips(q)

    def has_capacity(self) -> bool:
        """Whether a newly submitted query would start immediately."""
        return True

    def _queue_delay_estimate(self, q: Query, now: Optional[float]) -> float:
        """Estimated wait before the query's first remaining stage runs."""
        return 0.0

    def _static_quote(self, q: Query) -> tuple[float, float, float]:
        """(remaining exec seconds, remaining chip-seconds, cost) of the
        query's remaining stages on this pool's slice — the load-free
        half of a quote, cached per (work shape, stage cursor) and
        invalidated off the calibration version + the pool's load epoch.
        The coordinator's per-query all-pools quote loop reads this, so
        routing re-plans only when a planning input actually changed."""
        w = q.work
        # the service level is a planning input once an allocator sizes
        # slices per level; without one it only widens cache granularity
        key = (w.arch, w.kind, w.batch, w.prompt_tokens, w.output_tokens,
               w.train_steps, w.seq_len, q.stage_cursor, q.current_sla)
        ver = (self.cost_model.plan_version(), self.load_epoch)
        hit = self._quote_cache.get(key)
        if hit is not None and hit[0] == ver:
            return hit[1]
        plan = self.cost_model.plan(w, self.effective_chips(q))
        cs = plan.remaining_chip_seconds(q.stage_cursor)
        out = (plan.remaining_time(q.stage_cursor), cs,
               cs * self.price_per_chip_s)
        if len(self._quote_cache) > 4096:  # unbounded work variety guard
            self._quote_cache.clear()
        self._quote_cache[key] = (ver, out)
        return out

    def remaining_exec_s(self, q: Query) -> float:
        """Remaining execution seconds on this pool's slice (cached) —
        what the spill/spill-back worth-the-hop thresholds compare."""
        return self._static_quote(q)[0]

    def quote_cost(self, q: Query) -> float:
        """The cost half of `quote` alone — O(1), no queue-state walk.
        Placement paths that only compare prices use this so a saturated
        pool's backlog walk is never computed just to be discarded."""
        return self._static_quote(q)[2]

    def quote(self, q: Query, now: Optional[float] = None) -> dict:
        """Latency/cost quote for the query's REMAINING stages
        (q.stage_cursor onward) at the pool's current load. A preempted
        or spill-candidate query is priced for what's left, never for
        work it already ran."""
        exec_s, _, cost = self._static_quote(q)
        return {
            "latency_s": self._queue_delay_estimate(q, now) + exec_s,
            "cost": cost,
        }

    def _run_cs_factor(self, run: _Run) -> float:  # mode-dependent dimension: chip_s per work unit, where a work unit is wall-seconds (SOS) or chip-seconds (POS)
        """Chip-seconds per work unit of this run (base: work is
        wall-seconds on an isolated slice of `run.chips`)."""
        return float(run.chips)

    def _run_remaining_cs(self, run: _Run, now: Optional[float]) -> float:
        """Chip-seconds left in the run's CURRENT stage (scan path)."""
        elapsed = 0.0 if now is None else max(now - run.last_update, 0.0)
        return max(run.remaining - elapsed * run.rate, 0.0) * run.chips

    # --- incremental backlog maintenance ------------------------------
    def _wait_added(self, q: Query) -> None:
        cs = self._static_quote(q)[1]
        self._bl_wait_map[q.qid] = cs
        self._bl_wait_cs += cs
        self._as_next_eval = 0.0
        if self.wait_observer is not None:
            self.wait_observer.add(self, q)

    def _wait_removed(self, q: Query) -> None:
        self._as_next_eval = 0.0
        self._bl_wait_cs -= self._bl_wait_map.pop(q.qid, 0.0)
        if not self._bl_wait_map:
            self._bl_wait_cs = 0.0  # pin float drift to zero when empty
        if self.wait_observer is not None:
            self.wait_observer.discard(q)

    def _bl_rebuild_wait(self) -> None:
        """Re-derive the waiting sums (calibration version bumped, or a
        POS pool's plan chips changed) — amortized O(1): only runs when
        a planning input changes, never per event."""
        self._as_next_eval = 0.0
        self._bl_wait_map.clear()
        self._bl_wait_cs = 0.0
        for q in self.waiting:
            cs = self._static_quote(q)[1]
            self._bl_wait_map[q.qid] = cs
            self._bl_wait_cs += cs

    def _bl_retract_run(self, run: _Run) -> None:
        if run.bl_state == 2:
            self._bl_tf_burn -= run.bl_tf_burn
            self._bl_burn -= run.bl_burn
        elif run.bl_state == 1:
            self._bl_future_cs -= run.bl_cur
        run.bl_state = 0

    def _bl_retire_run(self, run: _Run) -> None:
        self._as_next_eval = 0.0
        self._bl_retract_run(run)
        self._bl_unstarted_cs -= run.bl_unstarted
        run.bl_unstarted = 0.0
        self._flagged.discard(run)
        if not self.running:
            # no runs left: pin the run-side aggregates to exactly zero
            # so float drift can never accumulate across a long day
            self._bl_tf_burn = 0.0
            self._bl_burn = 0.0
            self._bl_unstarted_cs = 0.0
            self._bl_future_cs = 0.0
            self._bl_future.clear()

    def _bl_sync(self, now: Optional[float]) -> None:
        ver = self.cost_model.plan_version()
        if ver != self._bl_ver:
            self._bl_ver = ver
            self._bl_rebuild_wait()
        if now is not None and now > self._bl_now:
            self._bl_now = now
        fut = self._bl_future
        while fut and fut[0][0] <= self._bl_now + 1e-9:
            _, _, token, run = heapq.heappop(fut)
            if run.bl_state == 1 and run.bl_token == token:
                # the startup lead has elapsed: the run's current stage
                # now decays like any started run
                self._bl_future_cs -= run.bl_cur
                self._bl_tf_burn += run.bl_tf_burn
                self._bl_burn += run.bl_burn
                run.bl_state = 2

    def predicted_backlog_cs(self, now: Optional[float] = None) -> float:
        """Predicted chip-seconds committed to this pool: the running
        stages' remaining work (the same predictions the stage heap
        holds), every running query's unstarted stages, and every
        waiting query's remaining plan — the backlog-driven autoscale
        signal. O(1): maintained incrementally at submit / admit /
        stage-begin / finish / preempt / spill / rehome, with the old
        full scan kept as ``predicted_backlog_scan_cs`` and asserted
        equivalent in debug mode (``check_backlog_invariant``)."""
        self._bl_sync(now)
        t = self._bl_now if now is None else now
        run_cs = self._bl_tf_burn - t * self._bl_burn
        if run_cs < 0.0:
            run_cs = 0.0
        return run_cs + self._bl_future_cs + self._bl_unstarted_cs + self._bl_wait_cs

    def predicted_backlog_scan_cs(self, now: Optional[float] = None) -> float:
        """The original O(running + waiting) backlog recompute — the
        debug-mode reference the incremental counter is locked against."""
        total = 0.0
        for run in self.running:
            total += self._run_remaining_cs(run, now)
            total += run.plan.remaining_chip_seconds(run.query.stage_cursor + 1)
        for q in self.waiting:
            plan = self.cost_model.plan(q.work, self._plan_chips(q))
            total += plan.remaining_chip_seconds(q.stage_cursor)
        return total

    def check_backlog_invariant(self, now: Optional[float] = None) -> None:
        """Assert incremental backlog == full scan (debug/test hook)."""
        inc = self.predicted_backlog_cs(now)
        scan = self.predicted_backlog_scan_cs(now)
        assert math.isclose(inc, scan, rel_tol=1e-9, abs_tol=1e-6), (
            f"{self.name}: incremental backlog {inc!r} != scan {scan!r} "
            f"at now={now!r}"
        )

    def drain_time_s(self, now: Optional[float] = None) -> float:
        """Seconds to drain the predicted backlog at current capacity
        (elastic pools drain in parallel: effectively zero)."""
        return 0.0

    def tick(self, now: float) -> None:
        """Cheap per-event bookkeeping for a pool with NO completions due
        at `now`. Base pools have no time-driven policy between their own
        events; autoscaled reserved pools re-evaluate the backlog trigger
        (its drain-time signal decays continuously) — see
        CostEfficientCluster.tick."""

    def tick_due(self, now: float) -> bool:
        """Whether `tick` would act at `now` (the simulator's idle-event
        fast path skips the pool pass when no tick is due anywhere)."""
        return False

    def next_tick_time(self) -> float:
        """Earliest future time `tick` could act — lets the simulator's
        poll fast-forward skip straight past an idle pool (inf = this
        pool never acts between its own events)."""
        return math.inf

    def check_heap_invariant(self) -> None:
        """Test/debug hook: every running stage has exactly one VALID
        heap entry, and no valid entry refers to a retired run."""
        valid: dict[int, int] = {}
        for _, _, run, epoch in self._heap:
            if run.active and epoch == run.epoch:
                valid[id(run)] = valid.get(id(run), 0) + 1
        running_ids = {id(r) for r in self.running}
        assert set(valid) == running_ids, (
            f"{self.name}: valid heap entries {len(valid)} != "
            f"running {len(running_ids)}"
        )
        assert all(v == 1 for v in valid.values()), (
            f"{self.name}: duplicate valid heap entries: {valid}"
        )

    # --- subclass hooks ----------------------------------------------
    def _admit(self, now: float) -> None:
        raise NotImplementedError

    def _plan_chips(self, q: Query) -> int:
        raise NotImplementedError

    def _stage_work(self, stage: Stage, q: Query) -> tuple[float, float, int]:
        """(work units, billed chip-seconds, retries) for one stage run.
        Default: wall-seconds at rate 1, fault model sampled per stage."""
        if self.fault is None:
            return stage.time_s, stage.chip_seconds, 0
        return self.fault.stage_execution(
            stage.time_s, stage.chips, self.rng, q
        )

    def _run_rate(self, run: _Run) -> float:
        return 1.0

    def _rates_changed(self, now: float) -> None:
        """Concurrency changed — subclasses with shared rates reschedule."""

    def _sync(self, now: float) -> None:
        """Advance run bookkeeping to `now` (shared-rate subclasses)."""

    def _continue_run(self, run: _Run, now: float) -> bool:
        """Stage-boundary policy: return False to withhold the next stage
        (the run is retired; the query was re-routed or re-queued).
        Base behavior: ask the coordinator's `rehome` hook whether the
        query should continue on another pool — a reserved pool spills
        to an elastic one under overload, an elastic pool hands a
        spilled query back once the reserved backlog clears."""
        if self.rehome is None:
            return True
        target = self.rehome(run.query, now)
        if target is None or target is self:
            return True
        self._handoff(run.query, target, now)
        return False

    def _handoff(self, q: Query, target: "ClusterExecutor", now: float) -> None:
        """Move a query to another pool at a stage boundary. The stage
        cursor stays valid because plan STRUCTURE is pool-independent;
        remaining stages are re-planned (and re-priced) on the target."""
        if target.pool_kind == "elastic" and self.pool_kind == "reserved":
            q.spilled = True
            q.state = "spilled"
            kind = "spill"
        else:
            q.spill_backs += 1
            q.state = "spilled-back"
            kind = "spill_back"
        if self.events is not None:
            self.events.emit(
                kind, now, qid=q.qid, src=self.name, dst=target.name,
                cursor=q.stage_cursor,
            )
        target.submit(q, now)

    def withdraw(self, q: Query) -> bool:
        """Remove a WAITING query from this pool (placement-time fusion
        pulls compatible waiters out of their pools before merging).
        Returns False when the query is no longer waiting here."""
        try:
            self.waiting.remove(q)
        except ValueError:
            return False
        self._waiter_withdrawn(q)
        return True

    def _waiter_withdrawn(self, q: Query) -> None:
        """Hook after a waiter is pulled by fusion: subclasses whose
        policy state derives from the waiting queue (stage-boundary
        preemption flags) re-derive it here — the old per-event
        rederivation would otherwise leave a stale flag that preempts a
        run nobody is waiting for."""

    # --- heap machinery ----------------------------------------------
    def _push(self, run: _Run, now: float) -> None:
        run.epoch += 1
        t = now + max(run.remaining, 0.0) / run.rate
        heapq.heappush(self._heap, (t, next(self._seq), run, run.epoch))
        # incremental backlog: replace this run's prediction terms with
        # the ones implied by the entry just pushed (identical floats);
        # the retract is inlined — this runs once per stage begin/re-rate
        self._as_next_eval = 0.0
        st = run.bl_state
        if st == 2:
            self._bl_tf_burn -= run.bl_tf_burn
            self._bl_burn -= run.bl_burn
        elif st == 1:
            self._bl_future_cs -= run.bl_cur
        run.bl_state = 0
        burn = run.rate * self._run_cs_factor(run)
        run.bl_tf_burn = t * burn
        run.bl_burn = burn
        if run.last_update > self._bl_now + 1e-9:
            # not started yet (elastic startup lead): the scan counts the
            # full stage work until `now` reaches the start time
            run.bl_state = 1
            run.bl_cur = max(run.remaining, 0.0) * self._run_cs_factor(run)
            run.bl_token = run.epoch
            self._bl_future_cs += run.bl_cur
            heapq.heappush(
                self._bl_future,
                (run.last_update, next(self._seq), run.bl_token, run),
            )
        else:
            run.bl_state = 2
            self._bl_tf_burn += run.bl_tf_burn
            self._bl_burn += run.bl_burn

    def _prune(self) -> None:
        h = self._heap
        while h and (not h[0][2].active or h[0][3] != h[0][2].epoch):
            heapq.heappop(h)

    def next_event_time(self) -> Optional[float]:
        """Earliest valid predicted stage completion (absolute time)."""
        self._prune()
        return self._heap[0][0] if self._heap else None

    # --- lifecycle ----------------------------------------------------
    def submit(self, q: Query, now: float) -> None:
        q.cluster = self.name
        self.waiting.append(q)
        self._admit(now)

    def _start_run(self, q: Query, now: float) -> _Run:
        chips = self._plan_chips(q)
        plan = self.cost_model.plan(q.work, chips)
        run = _Run(q, plan, chips)
        run.plan_ver = self.cost_model.plan_version()
        if q.start_time is None:
            q.start_time = now
        q.state = "running"
        self.running[run] = None
        self._begin_stage(run, now)
        return run

    def _begin_stage(self, run: _Run, now: float) -> None:
        # re-read the plan at every stage boundary: a calibration hot
        # swap (versioned CostModel cache) must flow into the stages not
        # yet begun. Structure is calibration-invariant, so the cursor
        # stays valid; the version check makes the no-update case a
        # single integer compare instead of a plan-cache lookup.
        ver = self.cost_model.plan_version()
        if ver != run.plan_ver:
            run.plan = self.cost_model.plan(run.query.work, run.chips)
            run.plan_ver = ver
        stage = run.plan.stages[run.query.stage_cursor]
        work, billed, retries = self._stage_work(stage, run.query)
        run.stage_start = now
        run.remaining = work
        run.last_update = now
        run.rate = self._run_rate(run)
        run.billed_cs = billed
        run.stage_retries = retries
        unstarted = run.plan._suffix_cs[run.query.stage_cursor + 1]
        self._bl_unstarted_cs += unstarted - run.bl_unstarted
        run.bl_unstarted = unstarted
        self._push(run, now)

    def advance_to(self, now: float) -> list[Query]:
        """Process every stage completion due by `now`; returns queries
        that finished their final stage (stamped with the exact per-stage
        completion time, not the event-processing time)."""
        finished: list[Query] = []
        h = self._heap
        due = now + 1e-9
        pop = heapq.heappop
        finish = self._finish_stage  # bound once: this loop is the
        while h:                     # single hottest line in a 1M-day
            e = h[0]
            run = e[2]
            if not run.active or e[3] != run.epoch:
                pop(h)  # stale entry (epoch invalidation)
                continue
            if e[0] > due:
                break
            pop(h)
            finish(run, e[0], finished)
        # completion branches admit at their exact finish times; a
        # trailing pass only matters for pools with time-driven policy
        # (autoscale trigger re-evaluation at this event's `now`)
        if self.needs_tick:
            self._admit(now)
        if DEBUG_BACKLOG or self.sanitize:
            self.check_backlog_invariant(now)
            if self.sanitize:
                self.check_heap_invariant()
        return finished

    #: subclasses with shared-rate dynamics (POS) set this so the hot
    #: SOS/elastic path skips the no-op _sync/_rates_changed dispatches
    _shared_rates = False

    def _finish_stage(self, run: _Run, t: float, finished: list[Query]) -> None:
        if self._shared_rates:
            self._sync(t)
        q = run.query
        stage = run.plan.stages[q.stage_cursor]
        ev = account_stage(
            q, stage.name, self.name, run.stage_start, t, run.chips,
            run.billed_cs, self.price_per_chip_s, run.stage_retries,
        )
        self.stages_completed += 1
        if self.stage_observer is not None:
            self.stage_observer(q, stage, ev)
        if q.stage_cursor >= len(run.plan.stages):
            run.active = False
            del self.running[run]
            self._bl_retire_run(run)
            q.finish_time = t
            q.state = "done"
            finished.append(q)
            if self._shared_rates:
                self._rates_changed(t)
            self._admit(t)
        elif not self._continue_run(run, t):
            run.active = False
            del self.running[run]
            self._bl_retire_run(run)
            if self._shared_rates:
                self._rates_changed(t)
            self._admit(t)
        else:
            self._begin_stage(run, t)
