"""Deterministic per-stage cost model — the property that makes SOS
suitable for flexible SLAs (paper §3.3 vision 1).

A query compiles to a chain of stages; every stage has a roofline time on
a given worker slice, derived from the same three-term model as
EXPERIMENTS.md §Roofline. Empirical calibration (core/calibration.py)
closes the loop between measurements and the scheduler: a
``CalibrationTable`` — fitted offline from dry-run JSONs or online from
measured stage walls — scales stage times (never plan structure), and
every table update invalidates the plan cache via a version check, so a
mid-run hot swap flows into quotes immediately.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path
from typing import TYPE_CHECKING, Optional

import numpy as np

from ..configs import get_config
from ..models.config import ModelConfig
from ..perf.hw import H100, HwSpec
from .query import QueryWork

if TYPE_CHECKING:  # pragma: no cover — import cycle guard
    from .calibration import CalibrationTable

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun"


@dataclass(frozen=True)
class Stage:
    name: str
    time_s: float  # on the stage's isolated worker slice
    chips: int  # worker slice size

    @property
    def chip_seconds(self) -> float:
        return self.time_s * self.chips


@dataclass(frozen=True)
class StagePlan:
    stages: tuple[Stage, ...]

    @property
    def exec_time(self) -> float:
        return self._suffix_time[0]

    @property
    def chip_seconds(self) -> float:
        return self._suffix_cs[0]

    # suffix sums make every remaining-* view O(1): the backlog signal
    # and the coordinator's quotes call them per query per event, and
    # chunked decode gives long generations hundreds of stages.
    # np.cumsum is a sequential left-to-right accumulate (np.add.accumulate,
    # not the pairwise tree np.sum uses), so these are bit-identical to the
    # old Python accumulation loop while building long plans in C.
    @cached_property
    def _suffix_time(self) -> tuple[float, ...]:
        if not self.stages:
            return (0.0,)
        acc = np.cumsum([s.time_s for s in reversed(self.stages)])
        return (*acc[::-1].tolist(), 0.0)

    @cached_property
    def _suffix_cs(self) -> tuple[float, ...]:
        if not self.stages:
            return (0.0,)
        acc = np.cumsum([s.chip_seconds for s in reversed(self.stages)])
        return (*acc[::-1].tolist(), 0.0)

    # --- stage-cursor views (engine.py runs a query as a cursor) ------
    def remaining_time(self, cursor: int = 0) -> float:
        return self._suffix_time[min(cursor, len(self.stages))]

    def remaining_chip_seconds(self, cursor: int = 0) -> float:
        return self._suffix_cs[min(cursor, len(self.stages))]


def _analytic_step(cfg: ModelConfig, tokens: int, kind: str, chips: int,
                   hw: HwSpec = H100) -> float:
    """Analytic roofline step time for `tokens` processed on `chips`."""
    n_active = cfg.active_params()
    factor = 6 if kind == "train" else 2
    flops = factor * n_active * tokens
    # weight streaming + activations; decode is weight-bound per token
    bytes_ = 2 * n_active + tokens * cfg.d_model * 2 * max(cfg.num_layers, 1)
    compute = flops / (chips * hw.peak_flops_bf16)
    memory = bytes_ / (chips * hw.hbm_bandwidth)
    return max(compute, memory)


def _decode_step_time(cfg: ModelConfig, batch: int, context: int, chips: int,
                      hw: HwSpec = H100) -> float:
    """One decode token for `batch` sequences at a given context length."""
    return _decode_chunk_time(cfg, batch, context, 1, chips, hw)


def _decode_chunk_time(cfg: ModelConfig, batch: int, context0: int, n: int,
                       chips: int, hw: HwSpec = H100) -> float:
    """Exact time of `n` consecutive decode tokens whose first token
    reads a KV cache of `context0` tokens: token j is priced at context
    ``context0 + j``. Summing per token makes a generation's total
    independent of how it is chunked (chunk boundaries are a scheduling
    choice, not a cost), while later chunks correctly pay for the longer
    cache they read — the old model priced every chunk at the INITIAL
    context, systematically under-quoting long generations.

    The per-token KV walk is vectorized: the per-layer min(window,
    context) sum collapses to one ``np.minimum.outer`` over the chunk's
    contexts. All intermediates stay exact int64 (no overflow at any
    realistic model/context size) and the final per-token times are
    accumulated sequentially, so the result is bit-identical to the
    scalar reference (``_decode_chunk_time_scalar``, kept as the
    equivalence oracle for tests/test_vectorized.py)."""
    if n <= 0:
        return 0.0
    n_active = cfg.active_params()
    compute = 2 * n_active * batch / (chips * hw.peak_flops_bf16)
    ssm = 0
    if cfg.ssm_state:
        n_mamba = sum(1 for k in cfg.layer_kinds() if k == "mamba")
        ssm = n_mamba * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    windows = () if cfg.attention_free else tuple(cfg.window_pattern())
    kv_unit = 2 * cfg.num_kv_heads * cfg.head_dim * 2  # k+v bf16 per tok
    bw = chips * hw.hbm_bandwidth
    ctx = context0 + np.arange(n, dtype=np.int64)
    # falsy window (None or 0) = full attention over the whole context
    n_full = sum(1 for w in windows if not w)
    sliding = np.array([w for w in windows if w], dtype=np.int64)
    kv = n_full * ctx
    if sliding.size:
        kv = kv + np.minimum.outer(ctx, sliding).sum(axis=1)
    bytes_ = 2 * n_active + batch * (kv * kv_unit + ssm)
    per_token = np.maximum(compute, bytes_ / bw)
    total = 0.0
    for t in per_token.tolist():  # sequential: total must not depend on
        total += t                # numpy's pairwise summation tree
    return total


def _decode_chunk_time_scalar(cfg: ModelConfig, batch: int, context0: int,
                              n: int, chips: int, hw: HwSpec = H100) -> float:
    """The original per-token loop — the equivalence oracle the
    vectorized `_decode_chunk_time` is locked against in tests."""
    n_active = cfg.active_params()
    compute = 2 * n_active * batch / (chips * hw.peak_flops_bf16)
    ssm = 0
    if cfg.ssm_state:
        n_mamba = sum(1 for k in cfg.layer_kinds() if k == "mamba")
        ssm = n_mamba * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    windows = () if cfg.attention_free else tuple(cfg.window_pattern())
    kv_unit = 2 * cfg.num_kv_heads * cfg.head_dim * 2  # k+v bf16 per tok
    bw = chips * hw.hbm_bandwidth
    total = 0.0
    for j in range(n):
        context = context0 + j
        kv = sum((min(w, context) if w else context) for w in windows)
        bytes_ = 2 * n_active + batch * (kv * kv_unit + ssm)
        total += max(compute, bytes_ / bw)
    return total


class CostModel:
    """Maps QueryWork -> StagePlan on a worker slice of `chips` chips.

    Decode is split into chunks of ``decode_chunk_tokens`` tokens (0
    disables chunking): long generations become a chain of short stages,
    so they are preemptible at chunk boundaries and a fault retries only
    the failed chunk. Plan STRUCTURE depends only on the work (never on
    `chips` or ``speed_factor``), so a mid-plan stage cursor stays valid
    when the remaining stages are re-planned for a different slice size
    or a different pool (cross-pool spill, spill-back, preemption resume).

    ``speed_factor`` models heterogeneous pool hardware relative to the
    `hw` baseline: a 0.25x pool (e.g. CPU spot) runs every stage 4x
    longer — and bills 4x the chip-seconds — on the same plan structure.

    ``calibration`` injects an explicit ``CalibrationTable``
    (core/calibration.py): its per-(arch, kind) factors scale stage
    times and its fitted ``speed_factor`` (when set) overrides the
    declared one. The table is LIVE state — any update bumps its
    version, and ``plan`` clears the plan cache on a version change, so
    a calibration hot swap flows into the very next quote. An injected
    table applies regardless of ``use_calibration``, which only gates
    the process-wide default table over ``results/dryrun``.

    ``parallel_overhead`` models the coordination tax of spreading one
    stage across a wider slice: every stage time is scaled by
    ``1 + parallel_overhead * (chips - 1)``. The pure roofline is
    exactly linear in chips (time ∝ 1/chips), which makes chip-seconds
    — and therefore cost — width-independent and the latency/cost
    frontier degenerate; a nonzero overhead restores the real trade
    (wider = faster wall time, but more billed chip-seconds), which is
    what the per-query allocator (core/allocation.py) sweeps. The
    default 0.0 keeps every existing plan bit-identical.
    """

    #: LRU bound on the plan cache: the per-query chips sweep multiplies
    #: keys per (work shape × allocation), which grew the old unbounded
    #: dict without limit on long heterogeneous days
    PLAN_CACHE_MAX = 4096

    def __init__(self, hw: HwSpec = H100, use_calibration: bool = True,
                 decode_chunk_tokens: int = 32, speed_factor: float = 1.0,
                 calibration: Optional["CalibrationTable"] = None,
                 parallel_overhead: float = 0.0):
        if speed_factor <= 0:
            raise ValueError(f"speed_factor must be > 0, got {speed_factor}")
        if parallel_overhead < 0:
            raise ValueError(
                f"parallel_overhead must be >= 0, got {parallel_overhead}"
            )
        self.hw = hw
        self.use_calibration = use_calibration
        self.decode_chunk_tokens = decode_chunk_tokens
        self.speed_factor = speed_factor
        self.calibration = calibration
        self.parallel_overhead = parallel_overhead
        # key -> (table version the plan was computed under, plan);
        # entries are version-tagged so a plan computed concurrently
        # with a hot swap can never be served under the NEW version.
        # LRU-bounded: the chips axis in the key means an allocator
        # sweep creates one entry per (work shape, width).
        self._plan_cache: OrderedDict[tuple, tuple[int, StagePlan]] = OrderedDict()
        self._cal_version = -1
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0

    def _table(self) -> Optional["CalibrationTable"]:
        if self.calibration is not None:
            return self.calibration
        if self.use_calibration:
            from .calibration import default_table

            return default_table()
        return None

    def set_calibration(self, table: Optional["CalibrationTable"]) -> None:
        """Swap the injected table (None reverts to the default/none).
        Safe at any stage boundary: calibration scales times, never plan
        structure, so mid-plan stage cursors stay valid."""
        self.calibration = table
        self.invalidate_cache()

    def invalidate_cache(self) -> None:
        self._plan_cache.clear()
        self._cal_version = -1

    def plan_cache_stats(self) -> dict:
        """Hit/miss counters (and current size) of the LRU plan cache —
        what the scale benchmark asserts to show the allocator's chips
        sweep stays cached instead of re-planning per query."""
        return {
            "hits": self.plan_cache_hits,
            "misses": self.plan_cache_misses,
            "size": len(self._plan_cache),
            "max": self.PLAN_CACHE_MAX,
        }

    def plan_version(self) -> int:
        """The active calibration table's version (0 when uncalibrated)
        — what plan-derived caches (the executors' static quotes, the
        incremental backlog's waiting sums) validate against so a hot
        swap invalidates them exactly like the plan cache itself."""
        cal = self.calibration
        if cal is not None:
            return cal.version
        if not self.use_calibration:  # hot path: no table can exist
            return 0
        table = self._table()
        return table.version if table is not None else 0

    @property
    def effective_speed_factor(self) -> float:
        """The speed quotes are made at: the table's fitted value when
        one exists, the declared constant otherwise."""
        t = self._table()
        if t is not None and t.speed_factor is not None:
            return t.speed_factor
        return self.speed_factor

    def _cal(self, arch: str, kind: str) -> float:
        t = self._table()
        cal = t.factor(arch, kind) if t is not None else 1.0
        return cal / self.effective_speed_factor

    def plan(self, work: QueryWork, chips: int) -> StagePlan:
        # versioned cache: a calibration update (hot swap, re-fit,
        # default-table invalidation) must reach the next plan() call —
        # the old cache never invalidated, so updates silently no-opped
        ver = self.plan_version()
        if ver != self._cal_version:
            self._plan_cache.clear()
            self._cal_version = ver
        key = (work.arch, work.kind, work.batch, work.prompt_tokens,
               work.output_tokens, work.train_steps, work.seq_len, chips)
        cached = self._plan_cache.get(key)
        if cached is not None and cached[0] == ver:
            self.plan_cache_hits += 1
            self._plan_cache.move_to_end(key)
            return cached[1]
        self.plan_cache_misses += 1
        cfg = get_config(work.arch)
        cal = self._cal(work.arch, work.kind)
        if self.parallel_overhead:
            # the parallelism tax composes with calibration exactly like
            # the speed factor: it scales times, never plan structure
            cal = cal * (1.0 + self.parallel_overhead * (chips - 1))
        stages: list[Stage] = []
        if work.kind == "train":
            t = _analytic_step(cfg, work.batch * work.seq_len, "train", chips)
            stages.append(Stage("train_steps", cal * t * work.train_steps, chips))
        else:
            tp = _analytic_step(
                cfg, work.batch * work.prompt_tokens, "serve", chips
            )
            stages.append(Stage("prefill", cal * tp, chips))
            if work.output_tokens:
                chunk = self.decode_chunk_tokens or work.output_tokens
                done = 0
                while done < work.output_tokens:
                    # each chunk pays for the KV cache grown by the
                    # chunks before it (token-exact, so chunking never
                    # changes the total). Context depends only on the
                    # work, so plan STRUCTURE stays chips/speed-
                    # independent and cursors survive pool hops.
                    n = min(chunk, work.output_tokens - done)
                    t_chunk = _decode_chunk_time(
                        cfg, work.batch, work.prompt_tokens + done, n, chips
                    )
                    stages.append(
                        Stage(f"decode[{done}:{done + n}]", cal * t_chunk, chips)
                    )
                    done += n
        out = StagePlan(tuple(stages))
        self._plan_cache[key] = (ver, out)
        if len(self._plan_cache) > self.PLAN_CACHE_MAX:
            self._plan_cache.popitem(last=False)
        return out

    def exec_time(self, work: QueryWork, chips: int) -> float:
        return self.plan(work, chips).exec_time

    def chip_seconds(self, work: QueryWork, chips: int) -> float:
        return self.plan(work, chips).chip_seconds
