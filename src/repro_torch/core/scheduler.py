"""The paper's scheduling layer (§4.2 service levels, §4.3 coordinator).

Service layer -> {immediate path, relaxed pending queue, BoE pending queue}
-> schedulers poll -> query coordinator places each query on one pool of
an N-pool executor registry, by per-pool remaining-stage quotes under the
Force/Auto/latency-aware policy. The registry generalizes the paper's
hardcoded vm/cf pair: "reserved" pools form the cost-efficient tier,
"elastic" pools the premium burst tier, and every placement decision —
routing, spill, spill-back — is made from the same quotes.

Multi-query fusion (paper §3.3) happens in two places, both indexed so a
fusable group is an O(1) lookup instead of a queue scan:

  * pending-queue fusion — ``PendingQueue`` buckets waiting queries by
    their fusion key, so ``pop_fused`` takes the head's group straight
    from its bucket (FIFO within the bucket) instead of copying and
    re-scanning the deque per pop;
  * cross-pool placement-time fusion — ``CrossPoolFusionIndex`` tracks
    every eligible WAITING query across ALL pools; when the coordinator
    routes a new query it pulls compatible waiters out of their pools
    (``pool.withdraw``) and places one merged query, so queries queued
    on *different* pools still share one batched execution. Fused
    billing splits by tokens at unpack (``unpack_fused``) with an
    exact-sum repair, through the same ``engine.account_stage``
    arithmetic as everything else.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Iterable, Optional, Union

from . import sanitize
from .engine import ClusterExecutor
from .query import Query, QueryWork
from .sla import Policy, ServiceLevel, SLAConfig


def fusion_key(work: QueryWork) -> tuple:
    """Bucket key for fusion safety: identical (arch, kind, prompt,
    output) only — a train query must never fuse with a serve query, and
    mismatched decode lengths would mis-bill the shorter members."""
    return (work.arch, work.kind, work.prompt_tokens, work.output_tokens)


def fuse_queries(queries: list[Query], now: float) -> Query:
    """Merge same-(arch, prompt) queries into one batched query (the
    multi-query execution opportunity of paper §3.3). Weight streaming
    amortizes across the fused batch, so the fused plan's chip-seconds are
    strictly below the sum of the members' individual plans."""
    head = queries[0]
    if len(queries) == 1:
        return head
    merged = Query(
        work=QueryWork(
            arch=head.work.arch,
            kind=head.work.kind,
            batch=sum(q.work.batch for q in queries),
            prompt_tokens=head.work.prompt_tokens,
            output_tokens=max(q.work.output_tokens for q in queries),
        ),
        sla=head.sla,
        submit_time=min(q.submit_time for q in queries),
        source=head.source,
    )
    merged.members = queries
    merged.effective_sla = head.effective_sla
    # the batch must honor the most restrictive execution-time SLA of
    # its members (LATENCY_AWARE routing reads it)
    targets = [q.latency_target_s for q in queries
               if q.latency_target_s is not None]
    merged.latency_target_s = min(targets) if targets else None
    for q in queries:
        # members pulled out of a pool's waiting queue (cross-pool
        # fusion) already left the SLA pending queue — their pending
        # time is settled and must not be restamped
        if q.dequeue_time is None:
            q.dequeue_time = now
    return merged


def unpack_fused(q: Query) -> list[Query]:
    """Expand a finished fused query back into its members: times are
    shared, billed cost/chip-seconds split by each member's token share.
    The split is repaired to sum EXACTLY to the fused run's totals — the
    float residue of the share products is folded into the last member
    (explicitly, never silently left on member 0, which also carries
    the fused trace/counters) and the exact-sum invariant is asserted."""
    members = q.members
    if not members:
        return [q]
    tot = sum(m.work.total_tokens for m in members)
    for i, m in enumerate(members):
        share = m.work.total_tokens / max(tot, 1)
        m.start_time = q.start_time
        m.finish_time = q.finish_time
        m.cluster = q.cluster
        m.state = q.state
        m.error = q.error
        m.fused_with = len(members)
        m.chip_seconds = q.chip_seconds * share
        m.cost = q.cost * share
        if i == 0:  # the fused run's stage trace and engine counters
            m.stage_trace = q.stage_trace  # live on one member so
            m.retries = q.retries  # summaries stay exact
            m.preemptions = q.preemptions
            m.spilled = q.spilled
            m.spill_backs = q.spill_backs
    for attr, total in (("chip_seconds", q.chip_seconds), ("cost", q.cost)):
        _repair_exact_sum(members, attr, total)
        assert sum(getattr(m, attr) for m in members) == total, (
            f"fused {attr} split does not sum to the fused total "
            f"({total!r}) for Q{q.qid}"
        )
    return members


def _repair_exact_sum(members: list[Query], attr: str, total: float) -> None:
    """Adjust the LAST member so that ``sum()`` of the members' values —
    the builtin the caller's exactness assert uses, which on Python >=
    3.12 is a compensated sum, not a left-to-right chain of additions —
    equals `total` bit-for-bit. The algebraic solution ``total -
    sum(head)`` plus at most a few one-ulp nudges lands the exact hit,
    and every candidate is judged by that same ``sum()``. The residue is
    explicit, never silently parked on member 0 (with one member there
    is no residue)."""
    values = [getattr(m, attr) for m in members]
    if sum(values) == total:
        return
    # Parity trap: when the last member dominates, x lives in the
    # total's own binade (ulp(x) == ulp(total)) and a head sum that is
    # an ODD multiple of ulp(total)/2 makes EVERY candidate land exactly
    # on a round-to-even tie — no representable x can produce `total`.
    # Escape by adding one ulp of the head sum to the second-to-last
    # member, which flips that parity; the head sum is then recomputed.
    for _ in range(8):
        head = values[:-1]
        prefix = sum(head)
        x = total - prefix
        for _ in range(8):
            s = sum(head + [x])
            if s == total:
                setattr(members[-1], attr, x)
                return
            x = math.nextafter(x, math.inf if s < total else -math.inf)
        if len(members) < 2:
            break
        values[-2] += math.ulp(prefix)
        setattr(members[-2], attr, values[-2])


class PendingQueue:
    """A scheduler pending queue: FIFO overall, with waiting queries
    bucketed by fusion key so a fused pop takes its group in O(group)
    instead of copying and scanning the whole deque (the old
    ``pop_fused``). Entries removed through a bucket leave a stale main-
    deque copy (and vice versa) that is skipped lazily, so every
    operation is amortized O(1). With ``fuse=False`` the bucket/stale
    bookkeeping is skipped entirely — stale bucket copies would
    otherwise accumulate forever, since only ``take_fusable`` consumes
    them."""

    __slots__ = ("_q", "_buckets", "_stale", "_n", "_fuse")

    def __init__(self, fuse: bool = True):
        self._q: deque[Query] = deque()
        self._buckets: dict[tuple, deque[Query]] = {}
        self._stale: dict[Query, int] = {}  # query -> stale copies left
        self._n = 0
        self._fuse = fuse

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __iter__(self):
        return (q for q in self._q if q not in self._stale)

    def __getitem__(self, i: int) -> Query:
        if i != 0:
            raise IndexError("PendingQueue only exposes its head")
        return self.head()

    def _consume_stale(self, q: Query) -> bool:
        c = self._stale.get(q)
        if not c:
            return False
        if c == 1:
            del self._stale[q]
        else:
            self._stale[q] = c - 1
        return True

    def append(self, q: Query) -> None:
        self._q.append(q)
        self._n += 1
        if self._fuse and q.work.kind == "serve":
            self._buckets.setdefault(fusion_key(q.work), deque()).append(q)

    def head(self) -> Query:
        while self._q and self._q[0] in self._stale:
            self._consume_stale(self._q.popleft())
        return self._q[0]

    def popleft(self) -> Query:
        q = self.head()
        self._q.popleft()
        self._n -= 1
        if self._fuse and q.work.kind == "serve":
            self._stale[q] = self._stale.get(q, 0) + 1  # bucket copy
        return q

    def take_fusable(self, head: Query, limit: int) -> list[Query]:
        """Up to `limit` queries fusable with `head`, in FIFO order —
        straight off the head's bucket, no queue scan."""
        key = fusion_key(head.work)
        bucket = self._buckets.get(key)
        if bucket is None:
            return []
        out: list[Query] = []
        while bucket and len(out) < limit:
            q = bucket.popleft()
            if self._consume_stale(q):
                continue  # head itself, or already popped via the deque
            out.append(q)
            self._n -= 1
            self._stale[q] = self._stale.get(q, 0) + 1  # main-deque copy
        if not bucket:
            del self._buckets[key]
        return out


def pop_fused(queue: PendingQueue, now: float, fuse: bool, fuse_max: int) -> Query:
    """Pop the queue head, fusing compatible waiting queries behind it.
    Shared by the relaxed and BoE schedulers so both apply the same
    matching rules. Only serve queries fuse (train steps don't batch)."""
    head = queue.popleft()
    if not fuse or head.work.kind != "serve":
        return head
    same = queue.take_fusable(head, fuse_max - 1)
    if not same:
        return head
    return fuse_queries([head] + same, now)


class CrossPoolFusionIndex:
    """Registry-wide fusion index (the ROADMAP cross-pool item): every
    eligible WAITING query — fresh, serve, not yet started — is indexed
    by fusion key the moment it enters ANY pool's waiting queue, and
    dropped the moment it leaves. The coordinator consults it at
    placement time, so compatible queries queued on different pools fuse
    into one batched execution instead of running separately.

    Thread-safe: live pools (core/live.py) mutate their waiting queues
    from worker threads and share this index with the coordinator."""

    #: lock contract (read by core.sanitize).
    _GUARDED_BY = {"_buckets": "_lock"}

    def __init__(self):
        self._lock = sanitize.ordered_lock(
            "CrossPoolFusionIndex._lock", threading.Lock()
        )
        # key -> {query: pool}; dict preserves insertion order, so FIFO
        # within a bucket holds across pools
        self._buckets: dict[tuple, dict[Query, ClusterExecutor]] = {}

    @staticmethod
    def _eligible(q: Query) -> bool:
        return (
            q.work.kind == "serve"
            and q.stage_cursor == 0
            and q.state == "pending"
            and q.members is None
        )

    def add(self, pool: ClusterExecutor, q: Query) -> None:
        if not self._eligible(q):
            return
        with self._lock:
            self._buckets.setdefault(fusion_key(q.work), {})[q] = pool

    def discard(self, q: Query) -> None:
        key = fusion_key(q.work)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is not None and bucket.pop(q, None) is not None:
                if not bucket:
                    del self._buckets[key]

    def candidates(
        self, q: Query, limit: int
    ) -> list[tuple[Query, ClusterExecutor]]:
        """Fusable waiting mates for `q` (same key AND same service
        level — a BoE waiter must not ride an IMMEDIATE head's tier),
        FIFO, as (query, owning pool) snapshot pairs."""
        with self._lock:
            bucket = self._buckets.get(fusion_key(q.work))
            if not bucket:
                return []
            out = []
            for m, pool in bucket.items():
                if m is q or m.current_sla is not q.current_sla:
                    continue
                out.append((m, pool))
                if len(out) >= limit:
                    break
            return out


class QueryCoordinator:
    """Places a dequeued query on one pool of the registry (paper §4.3,
    generalized): every decision reads per-pool remaining-stage quotes,
    not a hardcoded vm/cf branch. Quotes are served from each pool's
    static-quote cache (engine.ClusterExecutor._static_quote), so the
    per-query all-pools loop re-plans only when a calibration version or
    pool load epoch changed.

    Accepts either a pool list or the legacy ``(vm, cf)`` pair. The
    first reserved pool is exposed as ``.vm`` and the first elastic pool
    as ``.cf`` for the two-pool system the paper describes.

    With ``cross_pool_fusion=True`` the coordinator maintains a
    ``CrossPoolFusionIndex`` over every pool's waiting queue and merges
    compatible waiters into each newly placed query (``fuse_max`` caps
    the batch, like the pending-queue fusion it extends).
    """

    def __init__(
        self,
        pools: Union[ClusterExecutor, Iterable[ClusterExecutor]],
        cf: Optional[ClusterExecutor] = None,
        policy: Policy = Policy.AUTO,
        cfg: Optional[SLAConfig] = None,
        cross_pool_fusion: bool = False,
        fuse_max: int = 8,
    ):
        if isinstance(pools, ClusterExecutor):
            pools = [pools] + ([cf] if cf is not None else [])
        elif cf is not None:
            raise TypeError("pass either a pool list or the (vm, cf) pair")
        self.pools: list[ClusterExecutor] = list(pools)
        if not self.pools:
            raise ValueError("registry needs at least one pool")
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool names: {names}")
        self.by_name = {p.name: p for p in self.pools}
        self.policy = policy
        self.cfg = cfg or SLAConfig()
        self.fuse_max = fuse_max
        #: service levels eligible for placement-time fusion (see the
        #: route() gate for why RELAXED is not in the default set)
        self.cross_fuse_levels: tuple = (
            ServiceLevel.IMMEDIATE,
            ServiceLevel.BEST_EFFORT,
        )
        self.fusion: Optional[CrossPoolFusionIndex] = None
        if cross_pool_fusion:
            self.fusion = CrossPoolFusionIndex()
            for p in self.pools:
                p.wait_observer = self.fusion
        #: calibrated admission control (docs/allocation.md): quotes
        #: from a pool whose drift EWMA exceeds its table's bound are
        #: repriced at the measured speed, or the pool is dropped from
        #: the candidate set ("reject") when alternatives remain. Every
        #: intervention is counted into the run summary.
        self.drift_reprices = 0
        self.drift_rejects = 0
        #: audit feed (core/events.py) — attached by the simulator or
        #: live engine when event recording is on; None costs nothing
        self.events = None
        self._drift_on = any(
            getattr(p.cost_model.calibration, "drift_bound", None) is not None
            for p in self.pools
        )
        self.reserved_pools = [
            p for p in self.pools if p.pool_kind == "reserved"
        ]
        self.elastic_pools = [p for p in self.pools if p.pool_kind == "elastic"]
        self.vm = self.reserved_pools[0] if self.reserved_pools else self.pools[0]
        self.cf = self.elastic_pools[0] if self.elastic_pools else None

    def pool_overloaded(self, pool: ClusterExecutor) -> bool:
        return pool.run_queue_len >= self.cfg.vm_overload_threshold

    # ------------------------------------------------------------------
    # Calibrated admission control: the drift gate over quotes.
    # A pool's CalibrationTable tracks a log-EWMA of measured/predicted
    # stage walls (fed by LiveCalibrator.observe live, or the drift
    # stage observer the simulator wires); once it strays past the
    # table's drift_bound, this pool's quotes are known-stale and must
    # not be compared as-is against honest pools.
    # ------------------------------------------------------------------
    def refresh_drift_gate(self) -> None:
        """Re-arm the gate after tables were attached or swapped on a
        pool post-construction (the gate flag is precomputed so routing
        with no armed table pays zero per-query cost)."""
        self._drift_on = any(
            getattr(p.cost_model.calibration, "drift_bound", None) is not None
            for p in self.pools
        )

    def _drift_ratio(self, pool: ClusterExecutor) -> Optional[float]:
        """measured/predicted reprice factor when the pool's quotes are
        currently stale beyond its bound, else None."""
        t = pool.cost_model.calibration
        if t is None or not t.drift_exceeded():
            return None
        return t.drift_ratio()

    def _drift_rejected(self, pool: ClusterExecutor) -> bool:
        spec = getattr(pool, "spec", None)
        if spec is None or getattr(spec, "drift_action", "reprice") != "reject":
            return False
        t = pool.cost_model.calibration
        return t is not None and t.drift_exceeded()

    def quoted_latency(self, pool: ClusterExecutor, q: Query,
                       now: Optional[float]) -> float:
        """The pool's latency quote, drift-repriced when its gate trips
        (the drifted pool may still win — but at its measured speed)."""
        lat = pool.quote(q, now)["latency_s"]
        if self._drift_on:
            r = self._drift_ratio(pool)
            if r is not None:
                self.drift_reprices += 1
                lat *= r
        return lat

    def quoted_cost(self, pool: ClusterExecutor, q: Query) -> float:
        """The pool's cost quote, drift-repriced: a pool running slower
        than quoted also bills more chip-seconds than quoted."""
        c = pool.quote_cost(q)
        if self._drift_on:
            r = self._drift_ratio(pool)
            if r is not None:
                self.drift_reprices += 1
                c *= r
        return c

    def _drift_adjust(self, est: dict, q: Query, now: float) -> dict:
        """LATENCY_AWARE view of the drift gate: reprice drifted pools'
        estimates, drop "reject" pools while alternatives remain (a
        rejected pool that is the ONLY option is repriced instead —
        admission control reroutes, it never strands a query)."""
        out: dict = {}
        rejected: list[str] = []
        for name, e in est.items():
            p = self.by_name[name]
            if self._drift_rejected(p):
                rejected.append(name)
                continue
            r = self._drift_ratio(p)
            if r is not None:
                self.drift_reprices += 1
                if self.events is not None:
                    self.events.emit(
                        "drift_reprice", now, qid=q.qid, pool=name, ratio=r,
                    )
                e = {"latency_s": e["latency_s"] * r, "cost": e["cost"] * r}
            out[name] = e
        if out:
            self.drift_rejects += len(rejected)
            if rejected and self.events is not None:
                self.events.emit(
                    "drift_reject", now, qid=q.qid, pools=tuple(rejected),
                )
            return out
        for name in rejected:
            r = self._drift_ratio(self.by_name[name])
            e = est[name]
            if r is not None:
                self.drift_reprices += 1
                e = {"latency_s": e["latency_s"] * r, "cost": e["cost"] * r}
            out[name] = e
        return out

    @property
    def vm_overloaded(self) -> bool:
        """The legacy single-VM overload signal the schedulers poll:
        EVERY reserved pool is past the overload threshold. An
        all-elastic registry is never overloaded — burst capacity is
        unbounded, so holding relaxed queries back would only invert
        priority against BoE, which drains freely."""
        rp = self.reserved_pools
        if not rp:
            return False
        if len(rp) == 1:  # hot path: the paper's single-VM system
            return rp[0].run_queue_len >= self.cfg.vm_overload_threshold
        return all(self.pool_overloaded(p) for p in rp)

    @property
    def reserved_min_queue_len(self) -> int:
        """Shortest run queue across the cost-efficient tier (the BoE
        drain signal; with one reserved pool: its run-queue length)."""
        rp = self.reserved_pools
        if not rp:
            return 0
        if len(rp) == 1:
            return rp[0].run_queue_len
        return min(p.run_queue_len for p in rp)

    # ------------------------------------------------------------------
    # Beyond-paper: execution-time SLAs. The deterministic SOS cost model
    # makes admission-time latency quotes possible (paper §3.3 vision 1:
    # "it is easier to profile and control the performance and cost").
    # ------------------------------------------------------------------
    def estimate(self, q: Query, now: Optional[float] = None) -> dict:
        """Latency/cost quote for EVERY pool at the current load. Quotes
        cover only the REMAINING stages (q.stage_cursor onward), so a
        preempted or spill-candidate query is priced for what's left,
        not for work it already ran."""
        return {p.name: p.quote(q, now) for p in self.pools}

    def should_spill(
        self, q: Query, now: float, pool: Optional[ClusterExecutor] = None
    ) -> bool:
        """Stage-boundary spill policy (SLAConfig.spill_enabled): move the
        remaining stages of a running reserved-pool query to an elastic
        pool when its slice pool is overloaded — a waiting query AT LEAST
        AS urgent as `q` has no slice — and the remaining work is worth
        the elastic premium. A less-urgent waiter never displaces a
        runner (a deadline-distant RELAXED query must not push an
        IMMEDIATE query onto the 9-24x-priced pool), and BEST_EFFORT
        queries are never spilled — they are preempted instead."""
        pool = pool or self.vm
        if q.current_sla is ServiceLevel.BEST_EFFORT:
            return False
        # O(1) per-level waiting counts (live pools override with a
        # locked snapshot scan — their worker threads mutate `waiting`)
        if not pool.has_displacing_waiter(q):
            return False
        return pool.remaining_exec_s(q) >= self.cfg.spill_min_remaining_s

    def rehome(
        self, pool: ClusterExecutor, q: Query, now: float
    ) -> Optional[ClusterExecutor]:
        """Stage-boundary re-placement for `pool` (wired as pool.rehome).

        Reserved pool: spill — under overload, hand the remaining stages
        to the cheapest elastic quote. Elastic pool: spill-back — once a
        reserved pool has a free slice and its predicted backlog drain
        time is below the low watermark, a spilled query returns at its
        next stage boundary, making spill symmetric. Both moves require
        the remaining work to be worth the hop (spill_min_remaining_s),
        and the watermark hysteresis (spill needs a displaced waiter,
        spill-back an EMPTY queue plus low backlog) prevents ping-pong."""
        if pool.pool_kind == "reserved":
            if not self.cfg.spill_enabled or not self.elastic_pools:
                return None
            if not self.should_spill(q, now, pool):
                return None
            ep = self.elastic_pools
            if len(ep) == 1:  # common registry shape: skip the quote
                return ep[0]
            return min(ep, key=lambda p: p.quote_cost(q))
        # elastic pool: symmetric spill-back
        if not (self.cfg.spill_back_enabled and q.spilled):
            return None
        eligible = []
        for p in self.reserved_pools:
            if not p.has_capacity():
                continue
            if p.drain_time_s(now) > self.cfg.spill_back_low_backlog_s:
                continue
            if p.remaining_exec_s(q) < self.cfg.spill_min_remaining_s:
                continue  # the last chunk is not worth the hop
            eligible.append(p)
        if not eligible:
            return None
        # pick by quote, like every other placement decision: an
        # IMMEDIATE query returns to the fastest eligible pool, lower
        # levels to the cheapest — never registry order, which could
        # drop a latency-SLA query onto a 4x-slower pool
        if len(eligible) == 1:  # one home to return to: skip the quote
            return eligible[0]
        if q.current_sla is ServiceLevel.IMMEDIATE:
            return min(eligible, key=lambda p: p.quote(q, now)["latency_s"])
        return min(eligible, key=lambda p: p.quote_cost(q))

    def wire_rehoming(self) -> None:
        """Install the stage-boundary re-placement hook on every pool the
        active SLAConfig makes eligible (reserved pools when spill is on,
        elastic pools when spill-back is on)."""
        for pool in self.pools:
            eligible = (
                self.cfg.spill_enabled
                if pool.pool_kind == "reserved"
                else self.cfg.spill_back_enabled
            )
            if eligible:
                pool.rehome = (
                    lambda q, now, _pool=pool: self.rehome(_pool, q, now)
                )

    def _fuse_at_placement(self, q: Query, now: float) -> Query:
        """Cross-pool fusion: pull compatible waiters out of their
        pools and merge them into the query being placed; the merged
        batch then routes by the normal quote rules. A mate a pool no
        longer holds (a live worker grabbed it concurrently) is skipped
        — `withdraw` is the authoritative claim."""
        mates: list[Query] = []
        for m, pool in self.fusion.candidates(q, self.fuse_max - 1):
            if pool.withdraw(m):
                mates.append(m)
        if not mates:
            return q
        merged = fuse_queries([q] + mates, now)
        if self.events is not None:
            self.events.emit(
                "fuse", now, qid=merged.qid,
                members=tuple(m.qid for m in merged.members),
            )
        return merged

    def route(self, q: Query, now: float) -> str:
        if (
            self.fusion is not None
            and q.members is None
            and q.work.kind == "serve"
            and q.stage_cursor == 0
            # placement-time fusion targets the populations the pending
            # queues cannot batch: IMMEDIATE queries route instantly
            # (they never sit in a scheduler queue, so cross-pool
            # fusion is their ONLY batching path) and BEST_EFFORT work
            # is a pure cost play. RELAXED work is deliberately left to
            # the relaxed pending queue, which sees whole dashboard
            # rounds before placement — re-merging it here only coarsens
            # stage granularity (benchmarks/scale.py fusion rows).
            and q.current_sla in self.cross_fuse_levels
            # an IMMEDIATE arrival fuses only when a reserved slice is
            # free for it: the batch starts NOW and pulls its waiting
            # mates forward with it. When everything is busy the arrival
            # must not gamble its own latency on a batch that queues.
            and (
                q.current_sla is not ServiceLevel.IMMEDIATE
                or any(p.has_capacity() for p in self.reserved_pools)
            )
        ):
            q = self._fuse_at_placement(q, now)
        sla = q.current_sla
        if self.policy is Policy.LATENCY_AWARE:
            est = self.estimate(q, now)
            if self._drift_on:
                est = self._drift_adjust(est, q, now)
            target = q.latency_target_s
            ok = {
                name: e for name, e in est.items()
                if target is None or e["latency_s"] <= target
            } or est  # nothing meets the target: best effort, cheapest
            pool = self.by_name[min(ok, key=lambda n: ok[n]["cost"])]
        else:
            open_reserved = [
                p for p in self.reserved_pools if not self.pool_overloaded(p)
            ]
            if self.policy is Policy.FORCE and sla in (
                ServiceLevel.RELAXED,
                ServiceLevel.BEST_EFFORT,
            ):
                # SLA directly decides the tier: relaxed/BoE are forced
                # onto the cost-efficient tier even under overload
                candidates = open_reserved or self.reserved_pools
            else:
                # immediate (FORCE) and everything (AUTO): overflow to
                # the elastic tier only when the reserved tier is full
                candidates = (
                    open_reserved or self.elastic_pools or self.reserved_pools
                )
            candidates = candidates or self.pools  # all-elastic registry
            if self._drift_on and len(candidates) > 1:
                # admission control: route around "reject" pools whose
                # drift gate tripped, as long as an alternative remains
                kept = [p for p in candidates if not self._drift_rejected(p)]
                if kept and len(kept) != len(candidates):
                    self.drift_rejects += len(candidates) - len(kept)
                    if self.events is not None:
                        self.events.emit(
                            "drift_reject", now, qid=q.qid,
                            pools=tuple(
                                p.name for p in candidates if p not in kept
                            ),
                        )
                    candidates = kept
            # quote only the candidate tier (a saturated pool's backlog
            # walk is pure waste when it is not a candidate anyway)
            if len(candidates) == 1:
                pool = candidates[0]
            elif self._drift_on:
                if sla is ServiceLevel.IMMEDIATE:
                    pool = min(
                        candidates,
                        key=lambda p: self.quoted_latency(p, q, now),
                    )
                else:
                    pool = min(candidates, key=lambda p: self.quoted_cost(p, q))
            elif sla is ServiceLevel.IMMEDIATE:
                pool = min(candidates, key=lambda p: p.quote(q, now)["latency_s"])
            else:
                pool = min(candidates, key=lambda p: p.quote_cost(q))
        if self.events is not None:
            self.events.emit(
                "place", now, qid=q.qid, pool=pool.name,
                sla=sla.name, cursor=q.stage_cursor,
            )
        pool.submit(q, now)
        return pool.name


class RelaxedScheduler:
    """Polls the relaxed pending queue: dequeue when the cost-efficient
    cluster can execute, or when a query approaches its deadline."""

    def __init__(self, coordinator: QueryCoordinator, cfg: SLAConfig,
                 fuse: bool = False, fuse_max: int = 8):
        self.q = PendingQueue(fuse=fuse)
        self.coordinator = coordinator
        self.cfg = cfg
        self.fuse = fuse
        self.fuse_max = fuse_max

    def enqueue(self, q: Query) -> None:
        self.q.append(q)

    def poll(self, now: float) -> list[Query]:
        out = []
        while self.q:
            head = self.q.head()
            deadline_near = (
                now - head.submit_time
                >= self.cfg.relaxed_deadline_s * self.cfg.deadline_slack
            )
            can_exec = not self.coordinator.vm_overloaded
            if not (can_exec or deadline_near):
                break
            q = pop_fused(self.q, now, self.fuse, self.fuse_max)
            q.dequeue_time = now
            self.coordinator.route(q, now)
            out.append(q)
        return out


class BoEScheduler:
    """Drains the BoE queue whenever the cost-efficient cluster is idle."""

    def __init__(self, coordinator: QueryCoordinator, cfg: SLAConfig,
                 fuse: bool = False, fuse_max: int = 8):
        self.q = PendingQueue(fuse=fuse)
        self.coordinator = coordinator
        self.cfg = cfg
        self.fuse = fuse
        self.fuse_max = fuse_max

    def enqueue(self, q: Query) -> None:
        self.q.append(q)

    def poll(self, now: float) -> list[Query]:
        out = []
        while self.q and self.coordinator.reserved_min_queue_len <= self.cfg.boe_idle_threshold:
            head = pop_fused(self.q, now, self.fuse, self.fuse_max)
            head.dequeue_time = now
            self.coordinator.route(head, now)
            out.append(head)
            # one dequeue per idle observation: re-check occupancy
        return out


class ServiceLayer:
    """Entry point (paper Fig. 4 left half): SLA-dispatches queries."""

    def __init__(
        self,
        coordinator: QueryCoordinator,
        cfg: SLAConfig,
        sla_enabled: bool = True,
        fuse: bool = False,
        fuse_max: int = 8,
    ):
        self.coordinator = coordinator
        self.cfg = cfg
        self.sla_enabled = sla_enabled
        self.relaxed = RelaxedScheduler(coordinator, cfg, fuse=fuse,
                                        fuse_max=fuse_max)
        self.boe = BoEScheduler(coordinator, cfg, fuse=fuse,
                                fuse_max=fuse_max)

    def submit(self, q: Query, now: float) -> None:
        # the paper's "w/o SLA" baseline rewrites every query to immediate
        # (reporting still groups by the SUBMITTED sla, as in Figs. 6-7)
        q.effective_sla = (
            q.sla if self.sla_enabled else ServiceLevel.IMMEDIATE
        )
        if q.effective_sla is ServiceLevel.IMMEDIATE:
            q.dequeue_time = now
            self.coordinator.route(q, now)
        elif q.effective_sla is ServiceLevel.RELAXED:
            self.relaxed.enqueue(q)
        else:
            self.boe.enqueue(q)

    def poll(self, now: float) -> int:
        """Poll both pending queues; returns how many queries were
        dequeued and routed (the simulator skips its pool pass when an
        idle poll moved nothing)."""
        return len(self.relaxed.poll(now)) + len(self.boe.poll(now))

    @property
    def pending(self) -> int:
        return len(self.relaxed.q) + len(self.boe.q)
