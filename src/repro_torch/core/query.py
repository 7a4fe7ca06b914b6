"""Queries: the unit of work of the serverless ML-query service.

In PixelsDB a query is SQL over object storage; in this TPU adaptation a
query is an analytical ML job against one of the registered architectures
(DESIGN.md §2): a batched inference request (prefill + N decode tokens)
or a fixed number of training steps.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from .sla import ServiceLevel

_qid = itertools.count()


def reset_qids() -> None:
    """Restart qid assignment from 0. Qids come from a process-global
    counter, so two identical simulated days in one process get
    different qids; a harness that fingerprints per-query results
    across process shards (benchmarks/sweep.py) resets the counter at
    each cell start so qids — and therefore the fingerprints — depend
    only on the cell, not on what ran before it in the same process."""
    global _qid
    _qid = itertools.count()


@dataclass(slots=True)
class QueryWork:
    """Work descriptor, independent of where it runs."""

    arch: str = "paper-default"
    kind: str = "serve"  # serve | train
    batch: int = 1
    prompt_tokens: int = 1024
    output_tokens: int = 64
    train_steps: int = 0
    seq_len: int = 4096  # train sequence length

    @property
    def total_tokens(self) -> int:
        if self.kind == "train":
            return self.train_steps * self.batch * self.seq_len
        return self.batch * (self.prompt_tokens + self.output_tokens)


@dataclass(eq=False, slots=True)
class Query:
    """eq=False: queries are identities, not values — two queries with
    the same work are still distinct units of billing, queue membership
    is an O(1) identity check, and a query can key the fusion index /
    waiting-lane maps directly. slots=True: a 1M-query day allocates a
    million of these; slotted instances are ~4x smaller and faster."""

    work: QueryWork
    sla: ServiceLevel
    submit_time: float
    source: str = ""  # workload pattern name (Table 1)
    latency_target_s: Optional[float] = None  # execution-time SLA (beyond-paper)
    qid: int = field(default_factory=lambda: next(_qid))

    # lifecycle (filled by the runtime)
    effective_sla: Optional[ServiceLevel] = None  # after w/o-SLA rewrite
    dequeue_time: Optional[float] = None
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    cluster: Optional[str] = None  # "vm" (cost-efficient) | "cf" (elastic)
    chip_seconds: float = 0.0
    cost: float = 0.0
    retries: int = 0
    #: live engine only: the error string when execution raised
    #: (state == "failed"); the simulator's fault model retries instead
    error: Optional[str] = None

    # stage-level engine state (core/engine.py): a running query is a
    # cursor over its StagePlan; the cursor survives preemption and
    # cross-cluster spill, so completed stages are never re-run.
    stage_cursor: int = 0  # next stage index to execute
    state: str = "pending"  # pending|running|preempted|spilled|spilled-back|done|failed
    preemptions: int = 0
    spilled: bool = False
    spill_backs: int = 0  # returns from an elastic pool to a reserved one
    stage_trace: list = field(default_factory=list)  # StageEvent records

    # multi-query fusion (scheduler.fuse_queries / cross-pool placement)
    #: on a MERGED query: the member queries it was fused from
    members: Optional[list] = None
    #: on a member after unpack: size of the fused group it ran in
    #: (0 = ran alone) — what benchmark fusion rates are computed from
    fused_with: int = 0

    @property
    def current_sla(self) -> ServiceLevel:
        """The level the runtime acts on: the w/o-SLA rewrite when one
        has been applied, the submitted level otherwise."""
        return self.effective_sla if self.effective_sla is not None else self.sla

    @property
    def pending_time(self) -> Optional[float]:
        """Time in the SLA pending queue (what the guarantee covers)."""
        if self.dequeue_time is None:
            return None
        return self.dequeue_time - self.submit_time

    @property
    def queue_wait(self) -> Optional[float]:
        """Cluster admission wait (after SLA dequeue, before execution)."""
        if self.start_time is None or self.dequeue_time is None:
            return None
        return self.start_time - self.dequeue_time

    @property
    def exec_time(self) -> Optional[float]:
        if self.finish_time is None or self.start_time is None:
            return None
        return self.finish_time - self.start_time

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.submit_time

    def __repr__(self) -> str:  # compact traces
        return (
            f"Q{self.qid}[{self.sla.short} {self.work.arch}"
            f" {self.work.kind} t={self.submit_time:.0f}]"
        )
