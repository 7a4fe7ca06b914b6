"""Cluster models: cost-efficient (reserved pod slice) vs high-elastic
(on-demand burst slices) — paper §4.3's spot-VM vs cloud-function pair,
instantiated for TPU (DESIGN.md §2).

Both clusters are ClusterExecutors (core/engine.py): a running query is a
cursor over its StagePlan, and completions come from one heap of
predicted per-stage finish times.

The cost-efficient cluster supports two execution modes:
  POS  — plan-oriented scaling (paper's Trino VM cluster): admitted
         queries share the whole slice under processor sharing with a
         concurrency interference penalty. Per-query times depend on what
         else is running — the nondeterminism the paper's §5.3 "lessons
         learned" complains about.
  SOS  — stage-oriented scaling: each query's stages run on an isolated
         fixed-size sub-slice with deterministic roofline times; queries
         wait when no slice is free. SOS is where stage boundaries become
         policy points: BEST_EFFORT runs can be preempted for a waiting
         IMMEDIATE query, and the coordinator may spill the remaining
         stages of a query to the elastic cluster under overload.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..perf.hw import H100, HwSpec
from .convergence import PoolConverger
from .cost_model import CostModel, Stage
from .engine import ClusterExecutor, _Run
from .query import Query
from .sla import ServiceLevel


@dataclass
class AutoscaleConfig:
    """Elastic scaling of the reserved slice (the paper notes spot VMs
    scale in minutes — modeled as a provisioning delay).

    Two triggers:
      run_queue — legacy policy: scale-out when the running queue
                  stays above the high watermark, in below the low one.
      backlog   — scale from the stage heap's PREDICTED remaining
                  chip-seconds (ClusterExecutor.predicted_backlog_cs)
                  normalized to a drain time at current capacity. One
                  huge waiting query is a large backlog long before it
                  is a long run queue, so scale-out fires earlier and
                  provisioning latency overlaps the work that needs it.
    """

    enabled: bool = False
    min_chips: int = 4
    max_chips: int = 64
    step_chips: int = 4
    scale_delay_s: float = 180.0  # minutes-scale provisioning (paper §4.3)
    #: releasing capacity is fast even when acquiring it is slow; None
    #: falls back to scale_delay_s (the legacy symmetric behavior)
    scale_in_delay_s: Optional[float] = None
    trigger: str = "run_queue"  # run_queue | backlog
    high_watermark: int = 8  # run-queue length triggering scale-out
    low_watermark: int = 1
    backlog_high_s: float = 120.0  # predicted drain time triggering scale-out
    backlog_low_s: float = 10.0

    def __post_init__(self):
        if self.trigger not in ("run_queue", "backlog"):
            raise ValueError(
                f"unknown autoscale trigger {self.trigger!r} "
                "(expected 'run_queue' or 'backlog')"
            )


@dataclass
class FaultModel:
    """Stage-level failures and stragglers (simulated; SOS executors
    retry failed stages and speculatively duplicate stragglers). The
    engine samples outcomes PER STAGE, so a retry re-runs — and re-bills
    — only the failed stage, never the whole query."""

    failure_prob: float = 0.0  # per stage
    straggler_prob: float = 0.0  # per stage
    straggler_scale: float = 1.0  # Expo mean of extra relative time
    speculation: bool = True  # duplicate stragglers (cap the tail)
    speculation_cap: float = 0.3  # dup launched after 30% over estimate

    def stage_execution(
        self, base: float, chips: int, rng: np.random.Generator, q: Query
    ) -> tuple[float, float, int]:
        """Sample one stage run: (wall seconds, billed chip-seconds,
        retries). A failed stage is re-run once and the re-run is billed;
        a speculated straggler bills the duplicate's resources."""
        t = base
        billed = base * chips
        retries = 0
        if self.failure_prob and rng.random() < self.failure_prob:
            q.retries += 1
            retries = 1
            t += base  # re-run only this stage
            billed += base * chips  # the re-run is billed
        if self.straggler_prob and rng.random() < self.straggler_prob:
            tail = base * rng.exponential(self.straggler_scale)
            if self.speculation:
                tail = min(tail, base * self.speculation_cap)
                billed += base * chips  # the duplicate's resources
            t += tail
        return t, billed, retries

class CostEfficientCluster(ClusterExecutor):
    """Reserved slice: `chips` chips at reserved unit price."""

    name = "vm"

    def __init__(
        self,
        chips: int = 256,
        mode: str = "pos",  # pos | sos
        max_concurrent: int = 8,  # POS admission cap (Trino-style)
        interference_alpha: float = 0.3,
        sos_slice_chips: int = 32,
        cost_model: Optional[CostModel] = None,
        hw: HwSpec = H100,
        fault: Optional[FaultModel] = None,
        rng: Optional[np.random.Generator] = None,
        autoscale: Optional[AutoscaleConfig] = None,
        preempt_best_effort: bool = False,
    ):
        super().__init__(
            cost_model=cost_model,
            fault=fault or FaultModel(),
            rng=rng,
            price_per_chip_s=hw.reserved_price / 3600.0,
        )
        self.chips = chips
        self.mode = mode
        self.max_concurrent = max_concurrent
        self.alpha = interference_alpha
        self.autoscale = autoscale or AutoscaleConfig()
        self._pending_scale: list[tuple[float, int]] = []  # (effective_at, chips)
        #: convergence plane (core/convergence.py): policies mutate the
        #: DESIRED capacity, the converger drives observed toward it —
        #: scale triggers, cron schedules, and death healing all flow
        #: through one `evaluate`/`heal` pair
        self.desired_chips = chips
        self.converger = PoolConverger()
        self.chip_seconds_provisioned = 0.0  # reserved-capacity accounting
        self._last_prov_t = 0.0
        self.slice_chips = sos_slice_chips
        #: SOS chips currently held by running queries — an integer
        #: counter (== len(running) * slice_chips for fixed slices,
        #: exactly), which is what lets admission price variable-width
        #: slices without an O(running) sum
        self._used_chips = 0
        self.hw = hw
        self.preempt_best_effort = preempt_best_effort
        self._shared_rates = mode == "pos"  # POS: processor sharing

    @property
    def chips(self) -> int:
        return self._chips

    @chips.setter
    def chips(self, value: int) -> None:
        """Capacity is a planning input: changing it invalidates the
        static-quote cache (load_epoch) and, for POS pools — which plan
        waiting queries at the full slice — the incremental backlog's
        waiting sums."""
        self._chips = value
        self.load_epoch += 1
        if getattr(self, "mode", "") == "pos" and self.waiting:
            self._bl_rebuild_wait()

    # --- POS processor-sharing dynamics ---
    def _eff_rate_per_query(self) -> float:
        """Aggregate chips each running query receives under PS with an
        interference penalty 1/(1 + alpha*(k-1))."""
        k = len(self.running)
        if k == 0:
            return float(self.chips)
        return (self.chips / k) / (1.0 + self.alpha * (k - 1))

    def accrue_provisioned(self, now: float) -> None:
        """Reserved-capacity accounting: chip-seconds the slice held
        provisioned up to `now`, whether used or idle ("idle capacity is
        paid for too"). Accrual is LAZY — capacity is piecewise-constant
        so the sum telescopes: `_apply_pending_scale` closes the open
        interval before every capacity change, and anything reading
        `chip_seconds_provisioned` (the benchmark report) must call this
        once more at its horizon end to close the tail interval."""
        if now > self._last_prov_t:
            self.chip_seconds_provisioned += self.chips * (now - self._last_prov_t)
            self._last_prov_t = now

    def _apply_pending_scale(self, now: float) -> bool:
        """Apply due capacity changes BEFORE admission (new capacity can
        admit this event's waiters); returns True when chips changed.
        Pending entries come from the converger only (autoscale policies
        or death healing), so no enabled-gate is needed here."""
        if not self._pending_scale:
            return False
        due = [c for t, c in self._pending_scale if t <= now]
        if not due:
            return False
        self.accrue_provisioned(now)  # close the interval at OLD chips
        changed = due[-1] != self.chips
        self.chips = due[-1]
        self._pending_scale = [
            (t, c) for t, c in self._pending_scale if t > now
        ]
        return changed

    def _schedule_autoscale(self, now: float) -> None:
        """Evaluate the scale policies AFTER admission, so `waiting`
        holds only queries that genuinely found no slice this event — an
        arriving query that a free slice admits immediately must not
        read as backlog pressure. The policy pass itself lives on the
        converger (core/convergence.py): the reactive watermark trigger
        is its default ``BacklogTriggerPolicy`` with float-identical
        math, and schedule/hook policies ride the same evaluation."""
        a = self.autoscale
        if not a.enabled:
            return
        target = self.converger.evaluate(self, now)
        if a.trigger == "backlog":
            self._as_next_eval = self._next_backlog_eval(now, a, target)

    def _next_backlog_eval(self, now: float, a: AutoscaleConfig,
                           target) -> float:
        """Earliest future time the backlog trigger's verdict can change
        WITHOUT a state change (every state change resets the cache to
        0): between events the drain signal only decays linearly, so the
        only passive transition is cold turning on when the running
        work's decay brings the backlog down to the low watermark."""
        if target is not None or self._pending_scale:
            return 0.0  # a scale is in flight: tick handles pending
        if self.waiting or self.chips <= a.min_chips or self._bl_future:
            return math.inf  # cold can't act; flips only at own events
        floor = self._bl_future_cs + self._bl_unstarted_cs + self._bl_wait_cs
        want = a.backlog_low_s * self.chips
        if floor >= want or self._bl_burn <= 0.0:
            return math.inf  # decay alone can never reach the watermark
        # max(tf_burn - t*burn, 0) + floor == want, solved for t (a hair
        # early: an early re-eval is harmless, a late one skips an event)
        return (self._bl_tf_burn - (want - floor)) / self._bl_burn - 1e-6

    # --- engine hooks -------------------------------------------------
    def _plan_chips(self, q: Query) -> int:
        if self.mode == "pos":
            return self.chips
        if self.allocator is not None:
            w = self.allocator.choose(q.work, q.current_sla)
            return max(1, min(w, self.chips))
        return self.slice_chips

    def _start_run(self, q: Query, now: float) -> _Run:
        run = super()._start_run(q, now)
        if self.mode == "sos":
            self._used_chips += run.chips
        return run

    def _bl_retire_run(self, run: _Run) -> None:
        if self.mode == "sos":
            self._used_chips -= run.chips
        super()._bl_retire_run(run)

    # --- placement interface ------------------------------------------
    def effective_capacity(self) -> int:
        """The chips a query admitted NOW can count on: current capacity
        capped by any already-scheduled scale-in. Admitting against the
        raw current chips in the window before a scale-in takes effect
        overcommits the post-scale slice — the run keeps its chips when
        the capacity change lands, so the pool would be over its new
        budget for the run's whole residence."""
        cap = self._chips
        for _, target in self._pending_scale:
            if target < cap:
                cap = target
        return cap

    def _admit_width(self) -> int:
        """The narrowest slice the next admission could need — what
        ``has_capacity`` (no concrete query in hand yet) prices."""
        if self.allocator is not None:
            return max(1, min(self.allocator.config.min_chips, self._chips))
        return self.slice_chips

    def has_capacity(self) -> bool:
        if self.waiting:
            return False
        if self.mode == "pos":
            return len(self.running) < self.max_concurrent
        return self._used_chips + self._admit_width() <= self.effective_capacity()

    def _run_remaining_cs(self, run: _Run, now) -> float:
        elapsed = 0.0 if now is None else max(now - run.last_update, 0.0)
        left = max(run.remaining - elapsed * run.rate, 0.0)
        if self.mode == "pos":
            return left  # POS work units ARE chip-seconds
        return left * run.chips  # SOS: wall-seconds on an isolated slice

    def _run_cs_factor(self, run: _Run) -> float:  # mode-dependent dimension: dimensionless in POS (work units ARE chip-seconds), chips in SOS (work units are wall-seconds)
        return 1.0 if self.mode == "pos" else float(run.chips)

    def drain_time_s(self, now=None) -> float:
        return self.predicted_backlog_cs(now) / max(self.chips, 1)

    @property
    def needs_tick(self) -> bool:
        return self.autoscale.enabled or self._chaos is not None

    def _chaos_step(self, now: float) -> None:
        """Apply every due injected worker death (core/chaos.py): close
        the provisioned-capacity interval, drop the dead chips — never
        below one admission slice, or a fixed-width waiter could never
        be admitted again — and let the converger schedule replacement
        capacity back to ``desired_chips`` through the normal
        provisioning delay (+ seeded backoff)."""
        ch = self._chaos
        while ch.next_death_s() <= now:
            t_death_s = ch.pop_death()
            # a POS pool shares all chips (no slice concept): one death
            # is one chip, floored at 1. An SOS pool loses a slice,
            # floored at one admission slice — below that a fixed-width
            # waiter could never be admitted again.
            unit = self.slice_chips if self.mode == "sos" else 1
            floor = min(unit, self.chips)
            loss = ch.death_chips or unit
            loss = min(loss, self.chips - floor)
            if loss > 0:
                self.accrue_provisioned(now)
                self.chips = self.chips - loss
                if self.events is not None:
                    self.events.emit(
                        "death", now, pool=self.name, chips_lost=loss,
                        at_s=t_death_s,
                    )
                self.converger.heal(self, now)
        self._chaos_next = ch.next_death_s()

    def tick(self, now: float) -> None:
        """Per-event bookkeeping when this pool has no completion due:
        apply due injected deaths, apply a due capacity change (it may
        admit waiters — full admission pass), heal death-induced
        capacity divergence, and re-evaluate the scale policies — the
        backlog trigger's drain-time signal decays continuously between
        this pool's own events, and schedule policies fire on their own
        clock. Run-queue state only changes at own events, so the
        run_queue trigger needs no tick. Amortized O(1): the trigger is
        only re-evaluated once `now` reaches ``_as_next_eval``, the
        pre-computed earliest time the linearly-decaying drain signal
        can change the verdict (any state change recomputes it)."""
        if self._chaos_next <= now:
            self._chaos_step(now)
        if self._pending_scale:
            if self._pending_scale[0][0] <= now:
                self._admit(now)
            return
        if self._chaos is not None and self.chips < self.desired_chips:
            self.converger.heal(self, now)
        a = self.autoscale
        if not a.enabled:
            return
        if (
            self.converger.next_fire_s <= now + 1e-9
            or (a.trigger == "backlog" and now + 1e-9 >= self._as_next_eval)
        ):
            self._schedule_autoscale(now)

    def tick_due(self, now: float) -> bool:
        if self._chaos_next <= now:
            return True
        if self._pending_scale:
            return self._pending_scale[0][0] <= now
        if self._chaos is not None and self.chips < self.desired_chips:
            return True
        a = self.autoscale
        if not a.enabled:
            return False
        if self.converger.next_fire_s <= now + 1e-9:
            return True
        return a.trigger == "backlog" and now + 1e-9 >= self._as_next_eval

    def next_tick_time(self) -> float:
        """Earliest future time `tick` could act — what the simulator's
        poll fast-forward skips to (engine.ClusterExecutor returns inf)."""
        if self._pending_scale:
            return self._pending_scale[0][0]
        if self._chaos is not None and self.chips < self.desired_chips:
            return 0.0  # un-healed death: act at the very next poll
        t_s = self._chaos_next
        a = self.autoscale
        if a.enabled:
            if self.converger.next_fire_s < t_s:
                t_s = self.converger.next_fire_s
            if a.trigger == "backlog" and self._as_next_eval < t_s:
                t_s = self._as_next_eval
        return t_s

    def quote(self, q: Query, now=None) -> dict:
        exec_s, _, cost = self._static_quote(q)
        if self.mode == "pos":
            # PS: joining k runners divides the slice and adds the
            # concurrency interference penalty
            k = self.run_queue_len + 1
            latency = exec_s * k * (1.0 + self.alpha * (k - 1))
        else:
            # SOS: deterministic slice time + predicted wait for a slice
            wait = 0.0 if self.has_capacity() else self.drain_time_s(now)
            latency = wait + exec_s
        return {"latency_s": latency, "cost": cost}

    def _run_rate(self, run: _Run) -> float:
        if self.mode == "pos":
            return self._eff_rate_per_query()
        return 1.0

    def _stage_work(self, stage: Stage, q: Query) -> tuple[float, float, int]:
        if self.mode == "pos":
            # PS tracks remaining WORK (chip-seconds); no fault sampling
            # in the interference model (matches the paper's Trino VM).
            return stage.chip_seconds, stage.chip_seconds, 0
        return self.fault.stage_execution(stage.time_s, stage.chips, self.rng, q)

    def _sync(self, now: float) -> None:
        if self.mode != "pos":
            return
        for run in self.running:
            run.remaining = max(
                run.remaining - run.rate * (now - run.last_update), 0.0
            )
            run.last_update = now

    def _rates_changed(self, now: float) -> None:
        if self.mode != "pos":
            return
        self._sync(now)
        rate = self._eff_rate_per_query()
        for run in self.running:
            run.rate = rate
            self._push(run, now)

    def _pop_waiting(self) -> Query:
        # SOS slice handoff: IMMEDIATE first, FIFO within a level (POS
        # admission pops FIFO directly in _admit) — O(1) from the
        # waiting queue's per-level lanes
        return self.waiting.pop_best()

    def _admit(self, now: float) -> None:
        # provisioned-capacity accrual is lazy (piecewise-constant chips
        # telescope): _apply_pending_scale closes intervals before any
        # capacity change, report paths close the tail — no need to
        # accrue on every admission
        scaling = self.autoscale.enabled
        # pending entries exist only when the converger scheduled one
        # (autoscale target or death healing) — apply either kind
        if self._pending_scale and self._apply_pending_scale(now):
            self._rates_changed(now)
        if self.mode == "pos":
            admitted = False
            while self.waiting and len(self.running) < self.max_concurrent:
                self._start_run(self.waiting.pop(0), now)
                admitted = True
            if admitted:
                self._rates_changed(now)
            if scaling:
                self._schedule_autoscale(now)
            return
        # SOS: isolated slices (fixed-size, or allocator-chosen width).
        # Admission prices the HEAD's slice against the effective
        # capacity — current chips capped by any pending scale-in — so a
        # query admitted just before a scale-in lands can no longer
        # overcommit the post-scale budget.
        if self.waiting:
            cap = self.effective_capacity()
            while self.waiting:
                width = self._plan_chips(self.waiting.peek_best())
                if self._used_chips + width > cap:
                    break
                self._start_run(self._pop_waiting(), now)
        if scaling:
            self._schedule_autoscale(now)
        # stage-boundary preemption: a waiting IMMEDIATE query may bump a
        # running BEST_EFFORT query at its next stage boundary; requests
        # are re-derived from the CURRENT waiting queue each admission so
        # a flag goes away when its IMMEDIATE found a slice elsewhere.
        if self.preempt_best_effort:
            self._rederive_preempt_flags()

    def _rederive_preempt_flags(self) -> None:
        """Match preempt flags to the IMMEDIATE waiter count. The
        O(running) re-derivation only runs when flags could change
        (IMMEDIATE waiter count != currently flagged runs) — the common
        no-preemption event is O(1). Called at every admission AND when
        fusion withdraws a waiter (the withdrawn IMMEDIATE must take
        its preempt request with it)."""
        n_imm = self.waiting.counts[int(ServiceLevel.IMMEDIATE)]
        if n_imm != len(self._flagged):
            flagged = [r for r in self.running if r.preempt_requested]
            for run in flagged[n_imm:]:  # stale: nobody waits for it
                run.preempt_requested = False
                self._flagged.discard(run)
            need = n_imm - min(len(flagged), n_imm)
            for run in self.running:
                if need <= 0:
                    break
                if (
                    not run.preempt_requested
                    and run.query.current_sla is ServiceLevel.BEST_EFFORT
                ):
                    run.preempt_requested = True
                    self._flagged.add(run)
                    need -= 1

    def _waiter_withdrawn(self, q: Query) -> None:
        if self.preempt_best_effort and self.mode == "sos":
            self._rederive_preempt_flags()

    def _continue_run(self, run: _Run, now: float) -> bool:
        if self.mode != "sos":
            return True
        q = run.query
        if run.preempt_requested:
            # stop at this boundary; chip-seconds already billed are kept
            run.preempt_requested = False
            q.preemptions += 1
            q.state = "preempted"
            self.waiting.append(q)  # resumes at stage_cursor on a free slice
            if self.events is not None:
                self.events.emit(
                    "preempt", now, qid=q.qid, pool=self.name,
                    cursor=q.stage_cursor,
                )
            return False
        # coordinator-owned re-placement (spill to an elastic pool)
        return super()._continue_run(run, now)


class HighElasticCluster(ClusterExecutor):
    """On-demand burst slices: unbounded, seconds-level provisioning,
    `elastic_price_multiplier`x unit price (paper's CF: 9-24x)."""

    name = "cf"
    pool_kind = "elastic"

    def __init__(
        self,
        cost_model: Optional[CostModel] = None,
        hw: HwSpec = H100,
        startup_s: float = 2.0,
        min_chips: int = 4,
        max_chips: int = 64,
        tokens_per_chip: int = 262_144,
        fault: Optional[FaultModel] = None,
        rng: Optional[np.random.Generator] = None,
        price_multiplier: Optional[float] = None,
    ):
        mult = (
            price_multiplier
            if price_multiplier is not None
            else hw.elastic_price_multiplier
        )
        super().__init__(
            cost_model=cost_model,
            fault=fault or FaultModel(),
            rng=rng or np.random.default_rng(1),
            price_per_chip_s=hw.reserved_price * mult / 3600.0,
        )
        self.hw = hw
        self.startup_s = startup_s
        self.min_chips = min_chips
        self.max_chips = max_chips
        self.tokens_per_chip = tokens_per_chip

    def slice_for(self, q: Query) -> int:
        """Bigger queries get bigger slices (paper §5.2: CF dynamically
        allocates more resources to big queries)."""
        want = math.ceil(q.work.total_tokens / self.tokens_per_chip)
        return int(min(self.max_chips, max(self.min_chips, want)))

    def _plan_chips(self, q: Query) -> int:
        if self.allocator is not None:
            w = self.allocator.choose(q.work, q.current_sla)
            return int(min(self.max_chips, max(self.min_chips, w)))
        return self.slice_for(q)

    def _queue_delay_estimate(self, q: Query, now) -> float:
        return self.startup_s

    def _admit(self, now: float) -> None:
        # unbounded burst capacity: everything starts after provisioning
        while self.waiting:
            q = self.waiting.pop(0)
            self._start_run(q, now + self.startup_s)
