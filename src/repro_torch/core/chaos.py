"""Fault-injection harness: worker deaths, provisioning stalls, and
persistent slow hosts — seeded, deterministic, usable in both the
simulator and the live engine: the convergence plane is only credible
if a 10%-death day degrades gracefully instead of stranding queries.

Three layers, all derived from one ``ChaosConfig`` seed:

  * ``ChaosFaultModel`` extends ``clusters.FaultModel`` from per-stage
    faults to PERSISTENT slow hosts: a seeded subset of virtual host
    slots runs every stage ``slow_factor`` slower. Wall time and billed
    chip-seconds scale together, so chip-second conservation holds
    under ``REPRO_SANITIZE=1`` by construction.
  * ``PoolChaos`` is a pool's death/stall schedule for the SIMULATOR:
    pre-drawn death times knock ``death_chips`` off the pool's capacity
    (``CostEfficientCluster._chaos_step``), and seeded provisioning
    failures stretch every scheduled capacity change through the
    converger's exponential backoff (core/convergence.py).
  * ``LiveChaos`` injects worker deaths into the LIVE engine by raising
    ``WorkerDeath`` (a BaseException — it sails past the stage loop's
    ``except Exception`` barrier exactly like a real thread death) from
    a seeded (qid, stage) hash, each site at most once so a resumed
    stage isn't re-killed forever.

Replay contract: same config + same seed => same deaths, same stalls,
same slow hosts, bit-for-bit — the chaos-day tests run the day twice and
compare event-feed fingerprints (core/events.py).
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field, replace

import numpy as np

from .clusters import FaultModel


def _pool_seed(seed: int, name: str) -> np.random.SeedSequence:
    """Stable per-pool seeding: the pool NAME is folded in through a
    sha256 (never ``hash()`` — it is salted per process), so a pool's
    chaos schedule survives registry reordering and process restarts."""
    digest = hashlib.sha256(name.encode()).digest()
    return np.random.SeedSequence(
        [seed, int.from_bytes(digest[:8], "big")]
    )


@dataclass
class ChaosConfig:
    """One knob set for a fault-injected day. All draws derive from
    ``seed`` — two runs with equal configs are bit-identical."""

    seed: int = 0
    #: worker deaths per TARGETED pool over the horizon (uniform times)
    n_deaths: int = 0
    #: chips lost per death; 0 = the pool's slice size
    death_chips: int = 0
    #: pools that see deaths; empty = every reserved pool
    death_pools: tuple = ()
    horizon_s: float = 86_400.0
    #: per-attempt probability that provisioning a capacity change
    #: stalls and must be retried (geometric, capped at max_stalls)
    stall_prob: float = 0.0
    max_stalls: int = 4
    backoff_base_s: float = 30.0
    backoff_cap_s: float = 600.0
    #: persistent slow hosts: this fraction of n_hosts virtual host
    #: slots runs every stage slow_factor x slower
    slow_host_frac: float = 0.0
    slow_factor: float = 1.0
    n_hosts: int = 16
    #: LIVE engine only: per-(qid, stage) probability a worker thread
    #: dies mid-stage (raised as WorkerDeath, once per site)
    live_death_prob: float = 0.0


@dataclass
class ChaosFaultModel(FaultModel):
    """FaultModel + persistent slow hosts. A query lands on virtual
    host slot ``qid % n_hosts``; slow slots stretch the base stage time
    BEFORE the inherited fault/straggler sampling, so retries and
    speculation price the slow host's reality, and billed chip-seconds
    stay proportional to wall time (conservation-exact)."""

    slow_hosts: frozenset = field(default_factory=frozenset)
    slow_factor: float = 1.0
    n_hosts: int = 16

    def stage_execution(self, base, chips, rng, q):
        if self.slow_hosts and (q.qid % self.n_hosts) in self.slow_hosts:
            base = base * self.slow_factor
        return super().stage_execution(base, chips, rng, q)


class PoolChaos:
    """One pool's pre-drawn death/stall schedule (simulator side).
    Single-threaded like the pool it belongs to — no lock."""

    __slots__ = (
        "death_times_s", "_di", "death_chips", "stall_prob", "max_stalls",
        "backoff_base_s", "backoff_cap_s", "_rng",
    )

    def __init__(self, cfg: ChaosConfig, name: str):
        rng = np.random.default_rng(_pool_seed(cfg.seed, name))
        self.death_times_s = sorted(
            float(t_s)
            for t_s in rng.uniform(0.0, cfg.horizon_s, size=cfg.n_deaths)
        )
        self._di = 0
        self.death_chips = cfg.death_chips
        self.stall_prob = cfg.stall_prob
        self.max_stalls = cfg.max_stalls
        self.backoff_base_s = cfg.backoff_base_s
        self.backoff_cap_s = cfg.backoff_cap_s
        self._rng = rng

    def next_death_s(self) -> float:
        if self._di < len(self.death_times_s):
            return self.death_times_s[self._di]
        return float("inf")

    def pop_death(self) -> float:
        t_s = self.death_times_s[self._di]
        self._di += 1
        return t_s

    def draw_provision_failures(self) -> int:
        """Seeded stall count for ONE provisioning attempt chain."""
        k = 0
        while k < self.max_stalls and self._rng.random() < self.stall_prob:
            k += 1
        return k

    def backoff_s(self, k: int) -> float:
        return min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** k))


def wire_sim_chaos(pools, cfg: ChaosConfig) -> None:
    """Attach the harness to a simulator pool registry: a ``PoolChaos``
    schedule on every targeted reserved pool, and the slow-host fault
    wrapper on every pool (slow hosts are a fleet property). Must run
    before the simulation loop starts — ``needs_tick`` is read once."""
    slow_hosts = frozenset()
    if cfg.slow_host_frac > 0.0 and cfg.slow_factor != 1.0:
        rng = np.random.default_rng(_pool_seed(cfg.seed, "__slow_hosts__"))
        n_slow = int(round(cfg.slow_host_frac * cfg.n_hosts))
        slow_hosts = frozenset(
            int(i) for i in rng.choice(cfg.n_hosts, size=n_slow,
                                       replace=False)
        )
    for pool in pools:
        base = pool.fault or FaultModel()
        if slow_hosts:
            pool.fault = ChaosFaultModel(
                failure_prob=base.failure_prob,
                straggler_prob=base.straggler_prob,
                straggler_scale=base.straggler_scale,
                speculation=base.speculation,
                speculation_cap=base.speculation_cap,
                slow_hosts=slow_hosts,
                slow_factor=cfg.slow_factor,
                n_hosts=cfg.n_hosts,
            )
        if pool.pool_kind != "reserved" or not hasattr(pool, "_chaos"):
            continue
        if cfg.death_pools and pool.name not in cfg.death_pools:
            # stalls still apply wherever provisioning happens
            pool._chaos = PoolChaos(replace(cfg, n_deaths=0), pool.name)
        else:
            pool._chaos = PoolChaos(cfg, pool.name)
        pool._chaos_next = pool._chaos.next_death_s()


# ---------------------------------------------------------------------------
# live-engine fault injection
# ---------------------------------------------------------------------------

class WorkerDeath(BaseException):
    """Injected live worker death. A BaseException ON PURPOSE: it must
    blow through ``LiveExecutor._execute``'s ``except Exception`` fault
    barrier and kill the worker thread the way a real host loss would —
    the convergence plane's heartbeat reaper and thread respawn are the
    only things allowed to recover from it."""


class LiveChaos:
    """Seeded mid-stage worker deaths for the LIVE engine. The kill
    decision hashes (seed, qid, stage) so concurrent workers agree with
    any interleaving; each site fires at most once so the plane's
    checkpoint resume of the same stage survives."""

    #: lock contract (read by core.sanitize): the fired-site registry
    #: is touched from every worker thread.
    _GUARDED_BY = {
        "_fired": "_mu",
    }

    __slots__ = ("cfg", "_mu", "_fired")

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._mu = threading.Lock()
        self._fired: dict = {}  # (qid, stage) -> True once killed

    def should_kill(self, qid: int, stage: int) -> bool:
        p = self.cfg.live_death_prob
        if p <= 0.0:
            return False
        digest = hashlib.sha256(
            f"{self.cfg.seed}:{qid}:{stage}".encode()
        ).digest()
        if int.from_bytes(digest[:8], "big") / 2.0 ** 64 >= p:
            return False
        key = (qid, stage)
        with self._mu:
            if key in self._fired:
                return False
            self._fired[key] = True
        return True


def install_live_chaos(engine, cfg: ChaosConfig) -> LiveChaos:
    """Wrap every live pool's ``_run_stage_work`` with seeded worker
    deaths. Returns the harness (its ``_fired`` map doubles as the
    injected-death ledger for assertions)."""
    chaos = LiveChaos(cfg)

    def _wrap(pool):
        orig = pool._run_stage_work

        def wrapped(lm, q, _orig=orig, _chaos=chaos):
            if _chaos.should_kill(q.qid, q.stage_cursor):
                raise WorkerDeath(
                    f"injected worker death: Q{q.qid} "
                    f"stage {q.stage_cursor}"
                )
            _orig(lm, q)

        pool._run_stage_work = wrapped

    for pool in engine.pools:
        _wrap(pool)
    return chaos
