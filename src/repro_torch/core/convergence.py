"""Convergence control plane for the pool registry (otter-style,
ROADMAP item 3).

The shape is inverted from the old reactive autoscale: every pool
carries a ``desired_chips`` that POLICIES mutate — the backlog/run-queue
trigger (refactored out of ``clusters.CostEfficientCluster`` with
bit-identical watermark math), cron-style schedules, and external hooks
— and a CONVERGENCE step drives observed capacity toward desired:

  * simulated pools: worker deaths (core/chaos.py) drop ``chips`` below
    ``desired_chips``; ``PoolConverger.heal`` schedules the replacement
    through the pool's normal provisioning delay, with deterministic
    seeded exponential backoff when provisioning itself stalls.
  * live pools: ``ConvergencePlane.step_live`` (scheduler thread)
    respawns dead ``LiveReservedPool`` worker threads, decays the
    pool's calibration confidence so the replacement re-learns in a few
    stages (core/calibration.py ``LiveCalibrator.decay``), and resumes
    a lost in-flight query from its ``DecodeCheckpoint`` on a healthy
    slice — only the lost stage is re-run and re-billed.

Every action lands in the audit feed (core/events.py) when one is
attached. Policies are evaluated in list order and the LAST non-None
target wins, so appended schedule/hook policies override the reactive
trigger for the ticks they fire on.

This module holds no locks of its own: simulated pools are
single-threaded, and the live plane runs only on the engine's scheduler
thread.

See docs/convergence.md for the policy surface and replay recipe.
"""
from __future__ import annotations

import math
from typing import Callable, Optional


class ConvergencePolicy:
    """One desired-capacity input. ``desired(pool, now)`` returns a chip
    target or None (no opinion this tick); ``next_fire_s(now)`` is the
    next time the policy needs an evaluation regardless of traffic
    (``inf`` = purely event/load-driven)."""

    __slots__ = ()

    def desired(self, pool, now: float) -> Optional[int]:
        raise NotImplementedError

    def next_fire_s(self, now: float) -> float:
        return math.inf


class BacklogTriggerPolicy(ConvergencePolicy):
    """The reactive trigger, lifted verbatim from the old
    ``CostEfficientCluster._schedule_autoscale``: hot/cold watermarks on
    either the predicted backlog drain time or the run-queue length
    (``AutoscaleConfig.trigger``). The float math is IDENTICAL, so
    legacy autoscale configs replay bit-for-bit through the plane."""

    __slots__ = ()

    def desired(self, pool, now: float) -> Optional[int]:
        a = pool.autoscale
        if a.trigger == "backlog":
            drain_s = pool.drain_time_s(now)
            # scale out only when queued work exists — a long RUNNING
            # stage inflates the backlog but new slices can't help it —
            # and never scale IN over the head of a queue
            hot = drain_s >= a.backlog_high_s and bool(pool.waiting)
            cold = drain_s <= a.backlog_low_s and not pool.waiting
        else:
            hot = pool.run_queue_len >= a.high_watermark
            cold = pool.run_queue_len <= a.low_watermark
        if hot and pool.chips < a.max_chips:
            return min(a.max_chips, pool.chips + a.step_chips)
        if cold and pool.chips > a.min_chips:
            return max(a.min_chips, pool.chips - a.step_chips)
        return None


class SchedulePolicy(ConvergencePolicy):
    """Cron-style scheduled capacity (otter's scheduled scaling
    policies): fire ``chips`` at ``offset_s + k * period_s`` for
    ``k = 0.. while t <= horizon_s``, or at an explicit firing list.
    When several firings are due at one evaluation, the latest wins.

    Rides the pool's autoscale tick: the owning pool needs
    ``autoscale.enabled=True`` (neutralize the reactive trigger with
    out-of-reach watermarks if pure scheduling is wanted)."""

    __slots__ = ("entries", "_idx")

    def __init__(
        self,
        entries: Optional[list] = None,
        *,
        period_s: Optional[float] = None,
        offset_s: float = 0.0,
        chips: Optional[int] = None,
        horizon_s: float = 86_400.0,
    ):
        if entries is None:
            if period_s is None or chips is None:
                raise ValueError(
                    "SchedulePolicy needs either explicit entries or "
                    "(period_s, chips)"
                )
            if period_s <= 0:
                raise ValueError(f"period_s must be > 0, got {period_s}")
            entries = []
            t_s = offset_s
            while t_s <= horizon_s:
                entries.append((t_s, chips))
                t_s += period_s
        #: one-shot firings [(fire time s, chips)], consumed in order
        self.entries: list = sorted(entries)
        self._idx = 0

    def next_fire_s(self, now: float) -> float:
        if self._idx < len(self.entries):
            return self.entries[self._idx][0]
        return math.inf

    def desired(self, pool, now: float) -> Optional[int]:
        target = None
        while (
            self._idx < len(self.entries)
            and self.entries[self._idx][0] <= now + 1e-9
        ):
            target = self.entries[self._idx][1]
            self._idx += 1
        return target


class HookPolicy(ConvergencePolicy):
    """External scale hook (otter's webhook policy idiom): an injected
    ``fn(pool, now) -> Optional[int]`` — an operator override, an
    experiment harness, a remote controller. Purely opinion: the
    convergence step still owns delays, backoff, and events."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable):
        self.fn = fn

    def desired(self, pool, now: float) -> Optional[int]:
        return self.fn(pool, now)


class PoolConverger:
    """Per-pool convergence state for SIMULATED executors: evaluates the
    policy list into ``pool.desired_chips``, schedules the capacity
    change through the pool's provisioning delay (with seeded
    exponential backoff on injected provisioning failures), and heals
    death-induced divergence back to desired."""

    __slots__ = ("policies", "next_fire_s")

    def __init__(self, policies: Optional[list] = None):
        self.policies: list = (
            policies if policies is not None else [BacklogTriggerPolicy()]
        )
        #: earliest scheduled (traffic-independent) policy firing —
        #: drives the pool's tick_due / next_tick_time
        self.next_fire_s = math.inf

    def add_policy(self, policy: ConvergencePolicy) -> None:
        self.policies.append(policy)
        self.next_fire_s = min(self.next_fire_s, policy.next_fire_s(0.0))

    def evaluate(self, pool, now: float) -> Optional[int]:
        """One policy pass (the old ``_schedule_autoscale`` body):
        last non-None target wins, ``desired_chips`` records it, and —
        exactly like the legacy trigger — a pending capacity change
        blocks scheduling another until it lands."""
        target = None
        for pol in self.policies:
            t = pol.desired(pool, now)
            if t is not None:
                target = t
        nxt = math.inf
        for pol in self.policies:
            t_s = pol.next_fire_s(now)
            if t_s < nxt:
                nxt = t_s
        self.next_fire_s = nxt
        if target is not None:
            pool.desired_chips = target
        if target is not None and not pool._pending_scale:
            self._schedule_change(pool, now, target)
        return target

    def heal(self, pool, now: float) -> bool:
        """Drive observed capacity back to desired after a worker death
        (core/chaos.py dropped ``pool.chips``). Replacement capacity
        goes through the same provisioning delay (+ backoff) a scale-out
        would — dead capacity is not free to restore."""
        if pool._pending_scale or pool.chips >= pool.desired_chips:
            return False
        self._schedule_change(pool, now, pool.desired_chips, kind="replace")
        return True

    def _schedule_change(
        self, pool, now: float, target: int, kind: str = "scale"
    ) -> None:
        a = pool.autoscale
        base_s = (
            a.scale_delay_s
            if target > pool.chips
            else (
                a.scale_in_delay_s
                if a.scale_in_delay_s is not None
                else a.scale_delay_s
            )
        )
        delay_s = self._provision_delay_s(pool, now, base_s)
        pool._pending_scale.append((now + delay_s, target))
        if pool.events is not None:
            pool.events.emit(
                kind, now, pool=pool.name, from_chips=pool.chips,
                to_chips=target, at_s=now + delay_s,
            )

    def _provision_delay_s(self, pool, now: float, base_s: float) -> float:
        """Provisioning latency with injected stalls: each seeded failed
        attempt (pool's chaos schedule, core/chaos.py) adds a retry wait
        of ``min(cap_s, backoff_base_s * 2**k)`` — deterministic
        exponential backoff, every retry audited."""
        ch = getattr(pool, "_chaos", None)
        if ch is None:
            return base_s
        total_s = base_s
        for k in range(ch.draw_provision_failures()):
            b_s = ch.backoff_s(k)
            total_s += b_s
            if pool.events is not None:
                pool.events.emit(
                    "provision_retry", now, pool=pool.name,
                    attempt=k + 1, backoff_s=b_s,
                )
        return total_s


class ConvergencePlane:
    """LIVE-side convergence (runs ONLY on the engine's scheduler
    thread — it holds no locks; everything it calls takes its own):

      * respawn dead ``LiveReservedPool`` worker threads back to the
        pool's desired worker count;
      * decay the pool's calibration confidence so the replacement
        re-learns the pool speed in a few stages instead of from
        scratch;
      * resume a reaped in-flight query from its ``DecodeCheckpoint``
        on a healthy slice (``max_resumes`` per query), re-billing only
        the lost stage.
    """

    __slots__ = ("engine", "_resumes", "deaths", "replacements", "resumes")

    def __init__(self, engine):
        self.engine = engine
        self._resumes: dict = {}  # qid -> resume count
        self.deaths = 0
        self.replacements = 0
        self.resumes = 0

    def step_live(self, now_s: float) -> None:
        """One convergence pass: detect and replace dead workers."""
        eng = self.engine
        for pool in eng.pools:
            respawn = getattr(pool, "respawn_workers", None)
            if respawn is None:
                continue
            n = respawn()
            if not n:
                continue
            self.deaths += n
            self.replacements += n
            if eng.events is not None:
                eng.events.emit("death", now_s, pool=pool.name, workers=n)
                eng.events.emit("replace", now_s, pool=pool.name, workers=n)
            if eng.calibrator is not None:
                # the replacement host inherits the pool EWMA at reduced
                # confidence and re-learns in a few stages (see
                # docs/calibration.md)
                eng.calibrator.decay(pool.name)

    def try_resume(self, q, now_s: float) -> bool:
        """Resume a stale RUNNING query on a healthy slice. The stage
        cursor and billing already accrued live on the Query; decode
        state comes from the engine's checkpoint store — so the re-run
        re-bills ONLY the stage the dead worker lost. False when the
        resume budget is spent or mid-decode state is missing (the
        caller fails the query instead)."""
        eng = self.engine
        if self._resumes.get(q.qid, 0) >= eng.cfg.max_resumes:
            return False
        if q.stage_cursor > 0 and not eng._has_ckpt(q.qid):
            return False
        # the dead worker's placement will never release itself: force
        # every pool to forget the qid (token-gated, so if the worker
        # is merely wedged — not dead — its eventual release is a no-op
        # and its stage loop stops at the ownership check)
        for pool in eng.pools:
            pool.force_release(q.qid)
        self._resumes[q.qid] = self._resumes.get(q.qid, 0) + 1
        self.resumes += 1
        q.state = "preempted"  # re-enters a waiting queue at its cursor
        with eng._lock:
            eng.coordinator.route(q, now_s)
        if eng.events is not None:
            eng.events.emit(
                "resume", now_s, qid=q.qid, cursor=q.stage_cursor
            )
        return True
