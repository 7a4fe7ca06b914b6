"""Service levels and SLA configuration (paper §3.1, §4.2).

Three enumerable service levels over query PENDING time:
  IMMEDIATE — starts executing immediately;
  RELAXED   — starts within `relaxed_deadline_s` (default 5 min);
  BEST_EFFORT — no pending-time guarantee (drained when the cost-efficient
                cluster is idle).
Guarantees are RELATIVE (paper §3.1): a lower level must consume cheaper
resources; no absolute latency promise is made.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class ServiceLevel(enum.IntEnum):
    IMMEDIATE = 0
    RELAXED = 1
    BEST_EFFORT = 2

    @property
    def short(self) -> str:
        return {0: "imm", 1: "rel", 2: "boe"}[int(self)]


class Policy(enum.Enum):
    """Query-coordinator routing policy (paper §4.3 + beyond-paper)."""

    FORCE = "force"  # SLA directly decides the resource pool
    AUTO = "auto"  # spill to the elastic pool only on overload
    # beyond-paper (§4.2 "we plan to implement SLAs regarding query
    # execution time"): admission-time latency quotes from the
    # deterministic SOS cost model pick the cheapest pool that meets the
    # query's latency target
    LATENCY_AWARE = "latency_aware"


@dataclass(frozen=True)
class SLAConfig:
    relaxed_deadline_s: float = 300.0  # paper: 5 minutes, configurable
    #: pending fraction at which the relaxed scheduler force-submits
    deadline_slack: float = 0.85
    #: scheduler poll period (the paper's schedulers "keep polling")
    poll_period_s: float = 1.0
    #: VM running-queue length at which the coordinator calls "overloaded"
    vm_overload_threshold: int = 8
    #: BoE drains only when the cost-efficient cluster is idle (length 0)
    boe_idle_threshold: int = 0
    # --- stage-level engine policy (core/engine.py; SOS mode only) ----
    #: an arriving IMMEDIATE query may bump a running BEST_EFFORT query
    #: at its next stage boundary (preempted work resumes at the next
    #: unfinished stage; chip-seconds already spent are kept and billed)
    preempt_best_effort: bool = False
    #: the coordinator may route the REMAINING stages of a VM query to
    #: the elastic cluster when its slice pool is overloaded mid-query
    #: (a waiting query at least as urgent has no slice)
    spill_enabled: bool = False
    #: only spill queries whose remaining stages are worth the elastic
    #: premium (seconds of remaining work on the VM slice)
    spill_min_remaining_s: float = 5.0
    #: symmetric spill: a spilled query returns to a reserved pool at its
    #: next stage boundary once that pool has a free slice and its
    #: predicted backlog drain time falls below this low watermark
    #: (seconds) — remaining stages bill at the reserved rate again
    spill_back_enabled: bool = False
    spill_back_low_backlog_s: float = 30.0
