"""LIVE execution backend: the same ServiceLayer / schedulers /
QueryCoordinator drive real PyTorch model work on this host's device
(one CUDA card unless ``LiveConfig.device`` says otherwise), over the
same PoolSpec registry the control plane uses (core/pools.py).

A live pool is thread-backed hardware:

  kind="reserved" -> one serialized worker thread per chip (the
                     interference-free cost-efficient tier)
  kind="elastic"  -> a task pool of up to `chips` threads, each task
                     preceded by a provisioning sleep of `startup_s`

Every worker enqueues on the device's default stream, so the pools share
one card the way tenants share one accelerator: the decode kernel's
per-device counter buffer (kernels/decode_attention.py) is correct on one
stream only. Grad mode is thread-local, so every stage runs under
``torch.no_grad()`` in its worker and served prefill takes the flash
kernel, not its autograd Function.

A running query executes its StagePlan chunk-by-chunk through the model
— a prefill stage, then at most ``decode_chunk_tokens`` decode steps per
stage — and its decode state (KV cache + last token; the stage cursor
lives on the Query) is checkpointed at EVERY stage boundary. That makes
the stage-boundary policies exact on real work: an IMMEDIATE arrival
preempts a running BEST_EFFORT query at its next chunk, overload spills
the remaining chunks to an elastic pool, and spill-back returns them —
in all cases the resumed query re-runs nothing, and billing flows
through the same ``account_stage`` arithmetic as the simulated pools
(measured wall-seconds on a 1-chip worker, at the pool's price).

Placement is the coordinator's: every routing / spill / spill-back
decision reads ``pool.quote(q)``, never a hardcoded vm/cf branch.
Used by repro_torch/launch/serve_sla.py and tests/test_torch_live.py.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import torch

from ..configs import get_config
from ..models.transformer import LM
from . import sanitize
from .convergence import ConvergencePlane
from .cost_model import CostModel
from .engine import ClusterExecutor, account_stage
from .events import EventFeed
from .pools import (
    PoolSpec,
    build_live_pool,
    default_live_pool_specs,
    fit_spec_calibration,
)
from .query import Query, QueryWork
from .scheduler import QueryCoordinator, ServiceLayer, unpack_fused
from .sla import Policy, ServiceLevel, SLAConfig

F32 = torch.float32


def _prompt_inputs(vocab_size: int, batch: int, prompt_tokens: int, seed: int,
                   device) -> torch.Tensor:
    """Prompt batch (batch, prompt_tokens) for one prefill call, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``. The
    SHAPE depends only on (arch, batch, prompt_tokens), so the warm-up
    and every billed prefill launch the same kernels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab_size, (batch, prompt_tokens),
                         generator=gen, device=device)


def _sync(device: torch.device) -> None:
    """Wait until the work this thread enqueued on ``device`` is done:
    a CUDA event recorded on the current (default) stream, so the wait
    covers this stage and never the whole device. Eager CPU work is
    already done when it returns."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


def _copy_cache(cache: dict) -> dict:
    """A copy of every leaf of a decode cache (``LM.decode_step`` writes
    the K/V and mamba state of the cache it is given in place)."""
    return {k: _copy_cache(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


@dataclass(frozen=True)
class _LiveModel:
    """One arch's entry points. ``prefill(params, toks)`` returns (next
    token (B, 1), decode cache); ``decode(params, cache, tok)`` returns
    (next token (B, 1), cache) and advances ``cache`` IN PLACE. Greedy
    sampling is part of each call, so one stage is exactly one prefill,
    or one ``decode`` per token. Both run under ``torch.no_grad()``."""

    cfg: Any
    params: dict
    prefill: Callable
    decode: Callable
    device: torch.device


def live_model(model: LM, params: dict, kv_len: int) -> _LiveModel:
    """The live entry points of ``model`` with ``params`` (a params tree
    on the model's device), caching ``kv_len`` positions a sequence."""

    @torch.no_grad()
    def prefill(params, toks):
        logits, cache = model.prefill(params, toks, kv_len=kv_len, dtype=F32)
        return torch.argmax(logits, -1)[:, None], cache

    @torch.no_grad()
    def decode(params, cache, tok):
        logits, cache = model.decode_step(params, cache, tok, dtype=F32)
        return torch.argmax(logits, -1)[:, None], cache

    return _LiveModel(cfg=model.cfg, params=params, prefill=prefill,
                      decode=decode, device=model.device)


class _ModelPool:
    """Models shared by every live pool, warmed OUTSIDE the billed
    window: the first ``ensure`` for an (arch, batch) shape runs one
    throwaway prefill + decode step and waits for it, so no stage
    wall-clock ever includes building and loading the CUDA kernels (the
    first call of each wrapper runs ``nvcc``), and each worker thread's
    first ``ensure`` runs one GEMM, so no stage pays for the thread's
    cuBLAS handle. Warm-up seconds (build included) are recorded per
    shape in ``compile_s`` for observability.

    Weights are float32 and drawn from a ``torch.Generator`` seeded with
    0 on the device; on a CUDA device float32 GEMMs stay full float32
    (no TF32), as the reference computes."""

    #: lock contract — enforced at runtime by core.sanitize
    #: (REPRO_SANITIZE=1).
    _GUARDED_BY = {
        "_models": "_lock",
        "_warm": "_lock",
        "compile_s": "_lock",
    }

    def __init__(self, prompt_tokens: int, decode_tokens: int,
                 device="cuda", reduced: bool = True):
        self.prompt_tokens = prompt_tokens
        self.decode_tokens = decode_tokens
        self.device = torch.device(device)
        self.reduced = reduced
        if self.device.type == "cuda":
            # the reference computes in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self._models: dict[str, _LiveModel] = {}
        self._warm: set[tuple[str, int]] = set()
        self.compile_s: dict[tuple[str, int], float] = {}
        self._lock = sanitize.ordered_lock(
            "_ModelPool._lock", threading.Lock()
        )
        self._thread = threading.local()  # per-thread GEMM warm-up flag

    @property
    def kv_len(self) -> int:
        return self.prompt_tokens + self.decode_tokens + 8

    def _build(self, arch: str) -> _LiveModel:
        cfg = get_config(arch, reduced=self.reduced)
        if cfg.frontend:
            raise NotImplementedError(
                f"{arch}: the {cfg.frontend!r} frontend is not ported"
            )
        model = LM(cfg, device=self.device)  # refuses what is not ported
        gen = torch.Generator(device=self.device).manual_seed(0)
        return live_model(model, model.init(gen, dtype=F32), self.kv_len)

    def _warm_thread(self) -> None:
        """First call on this thread: a GEMM and a GEMM with a bias, so
        the thread's cuBLAS and cuBLASLt handles exist before any stage
        is timed."""
        if self.device.type != "cuda" or getattr(self._thread, "warm", False):
            return
        a = torch.ones((64, 64), dtype=F32, device=self.device)
        torch.addmm(a[0], a, a @ a)
        _sync(self.device)
        self._thread.warm = True

    def ensure(self, arch: str, batch: int) -> _LiveModel:
        """Return the arch's entry points, warmed for this batch."""
        self._warm_thread()
        with self._lock:
            lm = self._models.get(arch)
            if lm is None:
                lm = self._models[arch] = self._build(arch)
            key = (arch, batch)
            if key in self._warm:
                return lm
            t0 = time.monotonic()
            toks = _prompt_inputs(lm.cfg.vocab_size, batch,
                                  self.prompt_tokens, 0, lm.device)
            tok, cache = lm.prefill(lm.params, toks)
            if self.decode_tokens:
                tok, cache = lm.decode(lm.params, cache, tok)
            _sync(lm.device)
            self.compile_s[key] = time.monotonic() - t0
            self._warm.add(key)
            return lm


@dataclass
class DecodeCheckpoint:
    """Decode state captured at a stage boundary — what makes live
    preemption / spill / spill-back EXACT: a resumed query replays
    nothing, it decodes onward from here. The stage cursor (and the
    billing already accrued) live on the Query itself; the checkpoint
    is shared by every pool, so remaining chunks can resume on any pool.

    ``cache`` holds device tensors and is never written after it is
    saved: ``decode`` advances a cache in place, so a decode stage
    COPIES the checkpoint's cache when it loads it (copy on load) and
    saves the copy it advanced. A worker that dies mid-stage therefore
    leaves the last boundary's state intact for the resume."""

    cache: Any  # the model's decode cache (dict of tensors)
    tok: Any  # last sampled token, (batch, 1) int64
    decoded: int  # decode tokens already produced


class LiveExecutor(ClusterExecutor):
    """Thread-backed sibling of the simulated executors: the same
    placement interface the coordinator's registry reads (quote /
    effective_chips / run_queue_len / has_capacity / rehome), but stages
    execute real model work and are billed from MEASURED wall
    time through the same ``account_stage`` arithmetic.

    One "chip" is one host worker thread. All queue state is guarded by
    ``_mu`` — counters are moved inside one critical section per
    transition, so ``run_queue_len`` can never transiently under- or
    over-count (the old engine's unlocked ``_vm_busy`` race)."""

    #: holding ``_cv`` implies holding ``_mu`` (the Condition wraps it);
    #: core.sanitize reads this registry.
    _GUARDED_BY = {
        "running": ("_mu", "_cv"),
        "waiting": ("_mu", "_cv"),
        "stages_completed": ("_mu", "_cv"),
    }

    def __init__(self, spec: PoolSpec, engine: "LiveEngine"):
        price = (
            spec.price_per_chip_hour / 3600.0
            if spec.price_per_chip_hour is not None
            else engine.cfg.vm_price * spec.price_multiplier
        )
        # offline per-pool fit: the same resolution build_pool uses
        table = fit_spec_calibration(spec)
        super().__init__(
            cost_model=CostModel(
                use_calibration=False,
                decode_chunk_tokens=engine.cfg.decode_chunk_tokens,
                speed_factor=spec.speed_factor,
                calibration=table,
                parallel_overhead=spec.parallel_overhead,
            ),
            price_per_chip_s=price,
        )
        self.name = spec.name
        self.spec = spec
        self.engine = engine
        if spec.allocation is not None:
            from .allocation import Allocator

            self.allocator = Allocator(self.cost_model, spec.allocation)
        self._mu = sanitize.ordered_lock(
            "LiveExecutor._mu", threading.RLock()
        )
        self._cv = threading.Condition(self._mu)
        # qid -> (Query, placement token). The token is unique per
        # placement, so releasing an old placement can never clobber a
        # newer one (a query may hop away and back between pools faster
        # than the old worker's cleanup runs).
        self.running: dict[int, tuple[Query, object]] = {}
        self.waiting: list[Query] = []

    # --- registry interface (what the coordinator reads) --------------
    def _plan_chips(self, q: Query) -> int:
        if self.allocator is not None:
            # live pools honor the allocated width for quoting and
            # billing; execution still occupies one worker thread, the
            # width scales the billed chip-seconds like the simulator
            w = self.allocator.choose(q.work, q.current_sla)
            return max(1, min(w, self.spec.chips))
        return 1  # one worker thread per running query

    @property
    def run_queue_len(self) -> int:
        with self._mu:
            return len(self.running) + len(self.waiting)

    def predicted_backlog_cs(self, now: Optional[float] = None) -> float:
        """Predicted chip-seconds committed here, from the same cost
        model the quotes use (live stage walls are unknown upfront)."""
        with self._mu:
            qs = [q for q, _ in self.running.values()] + list(self.waiting)
        return sum(
            self.cost_model.plan(q.work, self._plan_chips(q))
            .remaining_chip_seconds(q.stage_cursor)
            for q in qs
        )

    def has_displacing_waiter(self, q: Query) -> bool:
        # live pools mutate `waiting` from worker threads: take a locked
        # snapshot scan instead of the sim's per-level counts
        with self._mu:
            return any(
                w.current_sla is not ServiceLevel.BEST_EFFORT
                and w.current_sla <= q.current_sla
                for w in self.waiting
            )

    def withdraw(self, q: Query) -> bool:
        """Claim a waiting query for placement-time fusion. Locked and
        authoritative: False means a worker (or another fusion) already
        took it, and the caller must not fuse it."""
        with self._cv:
            try:
                self.waiting.remove(q)
            except ValueError:
                return False
            if self.wait_observer is not None:
                self.wait_observer.discard(q)
            return True

    # --- lifecycle -----------------------------------------------------
    def start(self) -> None:
        """Begin consuming work (called after the coordinator wires
        rehoming, so no stage boundary ever misses its policy hook)."""

    def stop(self) -> None:
        raise NotImplementedError

    def submit(self, q: Query, now: float) -> None:
        raise NotImplementedError

    def _release(self, q: Query, token: object) -> None:
        """Drop this placement's `running` entry — a no-op when a newer
        placement already owns the qid."""
        with self._cv:
            cur = self.running.get(q.qid)
            if cur is not None and cur[1] is token:
                del self.running[q.qid]
            self._cv.notify_all()

    def force_release(self, qid: int) -> None:
        """Unconditionally forget a qid's placement (convergence plane:
        the owning worker is dead and will never release it). Token-less
        ON PURPOSE — the caller asserts the placement is lost; if the
        worker was merely wedged, its stage loop stops at the ownership
        check and its eventual ``_release`` is a no-op."""
        with self._cv:
            self.running.pop(qid, None)
            self._cv.notify_all()

    # --- the stage loop ------------------------------------------------
    def _execute(self, q: Query, token: object) -> None:
        """Run q's remaining stages on this pool. Returns when q
        finishes, fails, is preempted (re-queued here), or is re-homed.
        ANY exception surfaces as q.state == "failed" — nothing is
        swallowed, and drain() counts the failure immediately."""
        eng = self.engine
        try:
            lm = eng.models.ensure(q.work.arch, max(1, q.work.batch))
            chips = self._plan_chips(q)
            plan = self.cost_model.plan(q.work, chips)
            if q.start_time is None:
                q.start_time = eng.now()
            eng._note_beat(q)  # heartbeat BEFORE q is visibly "running"
            q.state = "running"
            q.cluster = self.name
            while q.stage_cursor < len(plan.stages):
                if eng._stop.is_set():
                    return  # shutdown: abandon between chunks, so a
                    # timed-out drain never waits out a deep backlog
                with self._mu:
                    cur = self.running.get(q.qid)
                if cur is None or cur[1] is not token or q.state == "failed":
                    return  # reaped / force-released: a resume (or the
                    # reaper's _fail) owns this query now
                stage = plan.stages[q.stage_cursor]
                start = eng.now()
                self._run_stage_work(lm, q)
                finish = eng.now()
                account_stage(
                    q, stage=stage.name, cluster=self.name, start=start,
                    finish=finish, chips=chips,
                    billed_cs=(finish - start) * chips,
                    price_per_chip_s=self.price_per_chip_s,
                )
                eng._note_beat(q)  # stage-boundary progress heartbeat
                with self._mu:  # workers finish stages concurrently
                    self.stages_completed += 1
                if eng.calibrator is not None:
                    # live calibration loop: feed the measured stage wall
                    # and hot-swap the fitted correction at this stage
                    # boundary — structure is calibration-invariant, so
                    # the plan below stays index-compatible
                    eng.calibrator.observe(
                        self, q.work, q.stage_cursor - 1, chips, finish - start
                    )
                    eng.calibrator.maybe_apply(self)
                if q.stage_cursor >= len(plan.stages):
                    eng._finish(q)
                    return
                if self._boundary_stop(q, token):
                    return
        except Exception as err:  # noqa: BLE001 — surfaced, not swallowed
            eng._fail(q, err)

    def _run_stage_work(self, lm: _LiveModel, q: Query) -> None:
        """Execute the model work of stage ``q.stage_cursor`` and
        checkpoint the resulting decode state. Chunk boundaries follow
        CostModel.plan exactly: stage 0 is prefill, stage i > 0 is the
        next <= decode_chunk_tokens decode steps. Returns when the
        device has finished the stage's work."""
        eng = self.engine
        batch = max(1, q.work.batch)
        if q.stage_cursor == 0:
            toks = _prompt_inputs(lm.cfg.vocab_size, batch,
                                  q.work.prompt_tokens, q.qid, lm.device)
            tok, cache = lm.prefill(lm.params, toks)
            _sync(lm.device)
            eng._save_ckpt(q, DecodeCheckpoint(cache, tok, 0))
            return
        ck = eng._load_ckpt(q)
        chunk = self.cost_model.decode_chunk_tokens or q.work.output_tokens
        n = min(chunk, q.work.output_tokens - ck.decoded)
        cache, tok = _copy_cache(ck.cache), ck.tok  # copy on load
        for _ in range(n):
            tok, cache = lm.decode(lm.params, cache, tok)
        _sync(lm.device)
        eng._save_ckpt(q, DecodeCheckpoint(cache, tok, ck.decoded + n))

    def _boundary_stop(self, q: Query, token: object) -> bool:
        """Stage-boundary policy, mirroring the simulator's
        ``_continue_run``: preempt first, then the coordinator's rehome
        hook (spill / spill-back). True = q stops executing here."""
        if self._should_preempt(q):
            q.preemptions += 1
            q.state = "preempted"
            with self._cv:
                # one critical section: leave `running` and re-enter
                # `waiting`, so run_queue_len never double-counts
                cur = self.running.get(q.qid)
                if cur is not None and cur[1] is token:
                    del self.running[q.qid]
                self.waiting.append(q)  # resumes at stage_cursor
                if self.wait_observer is not None:
                    self.wait_observer.add(self, q)  # no-op: cursor > 0
                self._cv.notify_all()
            return True
        if self.rehome is not None:
            now = self.engine.now()
            target = self.rehome(q, now)
            if target is not None and target is not self:
                self._handoff(q, target, now)
                return True
        return False

    def _should_preempt(self, q: Query) -> bool:
        return False  # reserved pools override


class LiveReservedPool(LiveExecutor):
    """Serialized worker thread(s): `spec.chips` threads, each running
    one query's stages at a time — the interference-free SOS tier."""

    pool_kind = "reserved"

    def __init__(self, spec: PoolSpec, engine: "LiveEngine"):
        super().__init__(spec, engine)
        self.workers = max(1, spec.chips)
        self._preempt = (
            engine.cfg.sla.preempt_best_effort
            if spec.preempt_best_effort is None
            else spec.preempt_best_effort
        )
        self._threads = [
            threading.Thread(
                target=self._worker, name=f"live-{self.name}-{i}", daemon=True
            )
            for i in range(self.workers)
        ]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)

    def has_capacity(self) -> bool:
        with self._mu:
            return not self.waiting and len(self.running) < self.workers

    def drain_time_s(self, now: Optional[float] = None) -> float:
        return self.predicted_backlog_cs(now) / self.workers

    def _queue_delay_estimate(self, q: Query, now: Optional[float]) -> float:
        return 0.0 if self.has_capacity() else self.drain_time_s(now)

    def submit(self, q: Query, now: float) -> None:
        q.cluster = self.name
        with self._cv:
            self.waiting.append(q)
            if self.wait_observer is not None:  # shared fusion index
                self.wait_observer.add(self, q)
            self._cv.notify_all()

    def _pop_waiting_locked(self) -> Query:
        # static RL001 exempts *_locked helpers; the runtime guard
        # covers their CALLERS instead (REPRO_SANITIZE=1)
        sanitize.guard(self, "waiting")
        # slice handoff mirrors the simulator: IMMEDIATE first, FIFO
        # within a level — a resumed preempted query keeps its place
        best = min(
            range(len(self.waiting)),
            key=lambda i: (int(self.waiting[i].current_sla), i),
        )
        q = self.waiting.pop(best)
        if self.wait_observer is not None:
            self.wait_observer.discard(q)
        return q

    def _worker(self) -> None:
        stop = self.engine._stop
        while not stop.is_set():
            with self._cv:
                if not self.waiting:
                    self._cv.wait(timeout=0.05)
                    continue
                q = self._pop_waiting_locked()
                token = object()
                self.running[q.qid] = (q, token)
            try:
                self._execute(q, token)
            finally:
                self._release(q, token)

    def _should_preempt(self, q: Query) -> bool:
        """An IMMEDIATE waiter bumps a running BEST_EFFORT query at this
        chunk boundary (chip-seconds already billed stay billed)."""
        if not self._preempt or q.current_sla is not ServiceLevel.BEST_EFFORT:
            return False
        with self._mu:
            return any(
                w.current_sla is ServiceLevel.IMMEDIATE for w in self.waiting
            )

    def respawn_workers(self) -> int:
        """Replace dead worker threads (convergence plane — called only
        from the engine's scheduler thread; ``_threads`` is touched by
        no other thread after ``start``). Returns the number replaced."""
        if self.engine._stop.is_set():
            return 0
        n = 0
        for i, t in enumerate(self._threads):
            if t.is_alive():
                continue
            nt = threading.Thread(
                target=self._worker, name=f"{t.name}r", daemon=True
            )
            self._threads[i] = nt
            nt.start()
            n += 1
        return n


class LiveElasticPool(LiveExecutor):
    """Burst tier: up to `spec.chips` concurrent tasks, each preceded by
    a provisioning sleep of `spec.startup_s` (not billed — provisioning
    is the provider's cost, the premium unit price is the customer's)."""

    pool_kind = "elastic"

    def __init__(self, spec: PoolSpec, engine: "LiveEngine"):
        super().__init__(spec, engine)
        self.startup_s = spec.startup_s
        self.workers = max(1, spec.chips)
        self._exec = ThreadPoolExecutor(
            max_workers=self.workers,
            thread_name_prefix=f"live-{spec.name}",
        )

    def stop(self) -> None:
        # queued-but-unstarted tasks are dropped; started ones abandon
        # at their next chunk boundary (_execute checks engine._stop)
        self._exec.shutdown(wait=True, cancel_futures=True)

    def _queue_delay_estimate(self, q: Query, now: Optional[float]) -> float:
        """Unlike the sim's unbounded burst tier, the live pool runs at
        most ``workers`` concurrent tasks — a saturated pool must quote
        the predicted drain of the work already committed to it, not
        just the provisioning sleep, or it under-quotes latency exactly
        when it is overloaded."""
        with self._mu:
            saturated = len(self.running) >= self.workers
        if not saturated:
            return self.startup_s
        return self.startup_s + self.predicted_backlog_cs(now) / self.workers

    def submit(self, q: Query, now: float) -> None:
        q.cluster = self.name
        token = object()
        with self._mu:
            self.running[q.qid] = (q, token)  # provisioning is committed
        try:
            self._exec.submit(self._task, q, token)
        except RuntimeError:  # pool already shut down: abandon cleanly
            self._release(q, token)

    def _task(self, q: Query, token: object) -> None:
        try:
            if self.startup_s:
                # interruptible provisioning: Event.wait returns True the
                # moment shutdown is signalled, so a stopping engine never
                # serves out queued startup sleeps (shutdown wall was
                # O(tasks x startup_s) with time.sleep here)
                if self.engine._stop.wait(self.startup_s):
                    return
            self._execute(q, token)
        except BaseException as err:  # pragma: no cover — _execute catches
            self.engine._fail(q, err)  # belt-and-braces: never swallow
        finally:
            self._release(q, token)


@dataclass
class LiveConfig:
    policy: Policy = Policy.AUTO
    sla_enabled: bool = True
    sla: SLAConfig = field(
        default_factory=lambda: SLAConfig(
            relaxed_deadline_s=10.0,
            poll_period_s=0.05,
            vm_overload_threshold=2,
            # live stages are milliseconds, so any remaining work is
            # worth a hop once spill/spill-back are enabled
            spill_min_remaining_s=0.0,
        )
    )
    #: executor registry: a list of PoolSpecs, one thread-backed pool
    #: each. None builds the legacy vm/cf live pair from the knobs below.
    pools: Optional[list[PoolSpec]] = None
    cf_startup_s: float = 0.3
    vm_price: float = 1.0  # $ per worker-second (multiplier base)
    cf_price_multiplier: float = 10.0
    # every live query runs this reduced shape (q.work is normalized at
    # submit — the legacy engine did the same implicitly)
    prompt_tokens: int = 32
    decode_tokens: int = 4
    #: decode chunk (= stage) size: the preemption/spill granularity
    decode_chunk_tokens: int = 2
    #: live calibration loop (core/calibration.py): fit each pool's
    #: cost model from its own measured stage walls and hot-swap the
    #: correction at stage boundaries, closing quote→measurement drift
    calibrate: bool = False
    calibration_alpha: float = 0.25  # EWMA weight of the newest stage
    calibration_min_samples: int = 8  # walls seen before the first swap
    #: JSON persistence: fitted state is loaded from here at startup and
    #: re-saved on every applied update (None keeps it in-memory)
    calibration_path: Optional[str] = None
    #: multi-query fusion: batch compatible pending queries (docs/fusion.md)
    fuse_queries: bool = False
    #: placement-time fusion across pools — live pools share the
    #: coordinator's CrossPoolFusionIndex, so compatible queries waiting
    #: on different pools merge into one batched execution
    cross_pool_fusion: bool = False
    fuse_max: int = 8
    #: a RUNNING query must reach a stage boundary (heartbeat) this
    #: often or its placement is declared dead — the query is resumed by
    #: the convergence plane or failed with Query.error set, so a worker
    #: dying mid-stage can never hang drain(). None disables the reaper.
    stage_deadline_s: Optional[float] = 60.0
    #: convergence control plane (core/convergence.py): respawn dead
    #: reserved workers, decay their pool's calibration confidence, and
    #: resume lost in-flight queries from their DecodeCheckpoint
    convergence: bool = False
    #: checkpoint resumes allowed per query before the reaper fails it
    max_resumes: int = 1
    #: audit feed (core/events.py) recording placement / spill / fuse /
    #: death / replace / resume / drift interventions
    events: bool = False
    #: the device every model runs on; "cpu" only when asked for
    device: str = "cuda"
    #: each arch's reduced config (``get_config(arch, reduced=True)``);
    #: False serves the full-width config
    reduced: bool = True


class LiveEngine:
    """Thread-backed mirror of the simulated service: same ServiceLayer,
    same schedulers, same QueryCoordinator, same PoolSpec registry —
    driving real models instead of a cost model."""

    #: lock contract (read by core.sanitize).
    _GUARDED_BY = {
        "done": "_lock",
        "failed": "_lock",
        "service": "_lock",
        "_ckpt": "_ckpt_mu",
        "_beats": "_beat_mu",
    }

    def __init__(self, cfg: LiveConfig):
        self.cfg = cfg
        if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"LiveConfig.device={cfg.device!r} but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU"
            )
        self.models = _ModelPool(cfg.prompt_tokens, cfg.decode_tokens,
                                 device=cfg.device, reduced=cfg.reduced)
        self.done: list[Query] = []
        self.failed: list[Query] = []
        self._lock = threading.RLock()  # service layer + result sinks
        self._ckpt: dict[int, DecodeCheckpoint] = {}
        self._ckpt_mu = threading.Lock()
        # qid -> (Query, last stage-boundary time): the reaper's evidence
        self._beats: dict[int, tuple[Query, float]] = {}
        self._beat_mu = threading.Lock()
        self.events = EventFeed() if cfg.events else None
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        specs = cfg.pools
        if specs is None:
            specs = default_live_pool_specs(
                cf_startup_s=cfg.cf_startup_s,
                cf_price_multiplier=cfg.cf_price_multiplier,
            )
        self.pools = [build_live_pool(spec, engine=self) for spec in specs]
        self.calibrator = None
        if cfg.calibrate:
            from .calibration import LiveCalibrator

            self.calibrator = LiveCalibrator(
                alpha=cfg.calibration_alpha,
                min_samples=cfg.calibration_min_samples,
                path=cfg.calibration_path,
            )
            for pool in self.pools:  # apply persisted fits before work
                self.calibrator.maybe_apply(pool)
        self.coordinator = QueryCoordinator(
            self.pools, policy=cfg.policy, cfg=cfg.sla,
            cross_pool_fusion=cfg.fuse_queries and cfg.cross_pool_fusion,
            fuse_max=cfg.fuse_max,
        )
        self.coordinator.wire_rehoming()
        self.coordinator.events = self.events
        for pool in self.pools:
            pool.events = self.events
        self.service = ServiceLayer(
            self.coordinator, cfg.sla, cfg.sla_enabled,
            fuse=cfg.fuse_queries, fuse_max=cfg.fuse_max,
        )
        #: live convergence (respawn + calibration decay + checkpoint
        #: resume) — created before the scheduler thread that steps it
        self.plane = ConvergencePlane(self) if cfg.convergence else None
        for pool in self.pools:  # consume only once rehoming is wired
            pool.start()
        self._sched_thread = threading.Thread(
            target=self._sched_loop, name="live-sched", daemon=True
        )
        self._sched_thread.start()

    # ------------------------------------------------------------------
    def now(self) -> float:
        return time.monotonic() - self._t0

    @property
    def vm_run_queue_len(self) -> int:  # legacy observability hook
        return self.coordinator.vm.run_queue_len

    def live_work(self, work: QueryWork) -> QueryWork:
        """Normalize a work descriptor to the reduced shape the live
        models actually run (every query shares one set of shapes)."""
        return replace(
            work,
            kind="serve",
            prompt_tokens=self.cfg.prompt_tokens,
            output_tokens=self.cfg.decode_tokens,
        )

    def price_menu(self, work: QueryWork):
        """Admission-time price menu quoted from the LIVE registry —
        per-pool Quote rows from the same pools queries execute on."""
        from .insights import price_menu

        return price_menu(
            self.live_work(work),
            pools=self.pools,
            relaxed_deadline_s=self.cfg.sla.relaxed_deadline_s,
        )

    # --- checkpoint store (host-shared across pools) -------------------
    def _save_ckpt(self, q: Query, ck: DecodeCheckpoint) -> None:
        with self._ckpt_mu:
            self._ckpt[q.qid] = ck

    def _load_ckpt(self, q: Query) -> DecodeCheckpoint:
        with self._ckpt_mu:
            ck = self._ckpt.get(q.qid)
        if ck is None:
            raise RuntimeError(
                f"no checkpoint for Q{q.qid} at stage {q.stage_cursor}"
            )
        return ck

    def _drop_ckpt(self, q: Query) -> None:
        with self._ckpt_mu:
            self._ckpt.pop(q.qid, None)

    def _has_ckpt(self, qid: int) -> bool:
        with self._ckpt_mu:
            return qid in self._ckpt

    # --- stage-boundary heartbeats (the reaper's evidence) -------------
    def _note_beat(self, q: Query) -> None:
        t_s = self.now()
        with self._beat_mu:
            self._beats[q.qid] = (q, t_s)

    def _clear_beat(self, q: Query) -> None:
        with self._beat_mu:
            self._beats.pop(q.qid, None)

    def _reap(self, now_s: float) -> None:
        """Fail or resume queries whose worker died mid-stage: a RUNNING
        query must make stage-boundary progress within
        ``stage_deadline_s`` or its placement is declared dead. Without
        this, a lost worker left the query in state "running" forever
        and ``drain()`` sat out its full timeout."""
        deadline_s = self.cfg.stage_deadline_s
        if deadline_s is None:
            return
        with self._beat_mu:
            stale = [
                q for q, t_s in self._beats.values()
                if q.state == "running" and now_s - t_s > deadline_s
            ]
        for q in stale:
            if self.plane is not None and self.plane.try_resume(q, now_s):
                continue
            self._fail(q, TimeoutError(
                f"stage deadline: no stage-boundary progress in "
                f"{deadline_s:.1f}s (worker died or wedged)"
            ))

    # --- result sinks (called from worker threads) ---------------------
    def _finish(self, q: Query) -> None:
        # a fused query completes as its members: times shared, billing
        # split by tokens with the exact-sum repair (same helper as the
        # simulator), so drain() counts each submitted query once
        with self._lock:
            if q.state == "failed":  # the reaper won this race
                return
            q.finish_time = self.now()
            q.state = "done"
            self.done.extend(unpack_fused(q))
        self._drop_ckpt(q)
        self._clear_beat(q)

    def _fail(self, q: Query, err: BaseException) -> None:
        with self._lock:
            if q.state in ("failed", "done"):  # double report / lost race
                return
            q.finish_time = self.now()
            q.state = "failed"
            q.error = f"{type(err).__name__}: {err}"
            self.failed.extend(unpack_fused(q))
        self._drop_ckpt(q)
        self._clear_beat(q)
        if self.events is not None:
            self.events.emit(
                "fail", q.finish_time, qid=q.qid, error=q.error
            )

    # ------------------------------------------------------------------
    def submit(self, q: Query) -> None:
        q.submit_time = self.now()
        q.work = self.live_work(q.work)
        with self._lock:
            self.service.submit(q, q.submit_time)

    def _sched_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                self.service.poll(self.now())
            now_s = self.now()
            if self.cfg.stage_deadline_s is not None:
                self._reap(now_s)
            if self.plane is not None:
                self.plane.step_live(now_s)
            time.sleep(self.cfg.sla.poll_period_s)

    def drain(self, n_expected: int, timeout: float = 120.0) -> list[Query]:
        """Block until n_expected queries have COMPLETED — done or
        failed — or the timeout passes. Failures count toward
        completion, so a raising query surfaces immediately instead of
        making the drain sit out its full timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if len(self.done) + len(self.failed) >= n_expected:
                    break
            time.sleep(0.02)
        self.shutdown()
        with self._lock:
            out = list(self.done) + list(self.failed)
        if sanitize.enabled():
            # conservation + trace stitching over completed queries only
            # (failed ones may have partial traces mid-stage)
            sanitize.check_result([q for q in out if q.state == "done"])
        return out

    def shutdown(self) -> None:
        self._stop.set()
        for pool in self.pools:
            pool.stop()
        self._sched_thread.join(timeout=5.0)
        if self.calibrator is not None and self.calibrator.path is not None:
            self.calibrator.save(self.calibrator.path)
