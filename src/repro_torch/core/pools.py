"""N-pool executor registry: pool specs and the builder that turns them
into ClusterExecutors.

The paper's flexible-SLA argument (and Kassing et al.'s allocation
study) is that the cost/latency frontier is traced by CHOOSING among
heterogeneous resource pools per query — a reserved slice, elastic burst
capacity, cheap-but-slow spot capacity — each with its own price, speed,
startup latency, and capacity model. ``PoolSpec`` captures exactly those
axes declaratively; ``build_pool`` instantiates the matching executor:

  kind="reserved" -> CostEfficientCluster (bounded POS/SOS slice pool,
                     optional autoscale)
  kind="elastic"  -> HighElasticCluster (unbounded burst slices with a
                     provisioning delay, premium unit price)

Pool heterogeneity enters the cost model as a ``speed_factor`` relative
to the hardware baseline: a 0.25x pool (CPU spot) runs every stage 4x
longer on the SAME plan structure, so a query's stage cursor stays valid
when its remaining stages hop pools (spill, spill-back) — only times and
bills are re-derived.

The default registry (``default_pool_specs``) is the paper's vm/cf pair
built from the legacy SimConfig knobs, so a registry of those two specs
reproduces the two-cluster simulator bit-for-bit, and a registry of size one
degenerates to a single-cluster system.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..perf.hw import H100, HwSpec
from .allocation import AllocationConfig, Allocator
from .clusters import (
    AutoscaleConfig,
    CostEfficientCluster,
    FaultModel,
    HighElasticCluster,
)
from .cost_model import CostModel
from .engine import ClusterExecutor
from .sla import SLAConfig


@dataclass(frozen=True)
class PoolSpec:
    """Declarative description of one executor pool in the registry."""

    name: str
    kind: str = "reserved"  # reserved | elastic
    #: reserved: total slice capacity; elastic: max chips per burst slice
    chips: int = 64
    mode: str = "sos"  # reserved execution: pos | sos
    slice_chips: int = 16  # SOS isolated sub-slice size
    #: pool hardware speed relative to the hw baseline (0.25 = 4x slower)
    speed_factor: float = 1.0
    #: absolute $/chip-hour; None derives hw.reserved_price * multiplier
    price_per_chip_hour: Optional[float] = None
    price_multiplier: float = 1.0
    startup_s: float = 0.0  # provisioning delay (elastic pools)
    interference_alpha: float = 0.5  # POS processor-sharing penalty
    max_concurrent: int = 8  # POS admission cap
    min_chips: int = 4  # elastic: min chips per burst slice
    tokens_per_chip: int = 262_144  # elastic slice sizing
    autoscale: Optional[AutoscaleConfig] = None  # reserved pools only
    #: None follows SLAConfig.preempt_best_effort; a bool overrides it
    preempt_best_effort: Optional[bool] = None
    #: directory of dry-run JSONs recorded on THIS pool's hardware;
    #: build_pool fits the pool's speed_factor and per-(arch, kind)
    #: corrections from it (core/calibration.py), replacing the declared
    #: speed_factor constant with a measured one
    dryrun_dir: Optional[str] = None
    #: filter for a mixed dryrun_dir: only records whose "hw" field or
    #: filename carry this tag belong to this pool's hardware
    hw_tag: str = ""
    #: per-query chips-per-stage allocation bounds (core/allocation.py):
    #: when set, the pool's slice width becomes a per-(work, service
    #: level) decision swept over this grid instead of the fixed
    #: slice_chips / tokens_per_chip sizing. None keeps the legacy
    #: fixed-knob sizing bit-for-bit.
    allocation: Optional[AllocationConfig] = None
    #: coordination tax of wider slices: stage times scale by
    #: ``1 + parallel_overhead * (chips - 1)`` (CostModel). 0.0 keeps
    #: the pure — exactly chips-linear — roofline, under which every
    #: width costs the same chip-seconds and the frontier is degenerate.
    parallel_overhead: float = 0.0
    #: admission-control drift gate (CalibrationTable.drift_bound):
    #: when the pool's measured/predicted drift EWMA strays more than
    #: this relative bound, the coordinator stops trusting its quotes.
    #: None disables the gate for this pool.
    drift_bound: Optional[float] = None
    #: what a tripped gate does to this pool's quotes: "reprice" scales
    #: them to the measured speed; "reject" routes new queries to other
    #: candidate pools while any remain (falling back to reprice when
    #: this pool is the only option)
    drift_action: str = "reprice"

    def effective_price_per_chip_hour(self, hw: HwSpec = H100) -> float:
        if self.price_per_chip_hour is not None:
            return self.price_per_chip_hour
        return hw.reserved_price * self.price_multiplier


def fit_spec_calibration(spec: PoolSpec, *, hw: HwSpec = H100):
    """The one dryrun-fit resolution both backends share: a spec with
    ``dryrun_dir`` fits a CalibrationTable from that pool's hardware
    records (None otherwise), so simulated and live pools stay
    bit-identical by construction."""
    if not spec.dryrun_dir:
        return None
    from .calibration import fit_dryruns

    return fit_dryruns(spec.dryrun_dir, hw=hw, hw_tag=spec.hw_tag)


def build_pool(
    spec: PoolSpec,
    *,
    hw: HwSpec = H100,
    use_calibration: bool = True,
    decode_chunk_tokens: int = 32,
    fault: Optional[FaultModel] = None,
    rng: Optional[np.random.Generator] = None,
    sla: Optional[SLAConfig] = None,
    calibration=None,
) -> ClusterExecutor:
    """Instantiate the executor a PoolSpec describes. All pools built for
    one simulation share `rng` so fault sampling stays deterministic for
    a given seed regardless of how queries hop between pools.

    Calibration: an explicit `calibration` table wins; otherwise a spec
    with `dryrun_dir` fits one from that pool's dry-run JSONs (offline
    per-pool calibration — the fitted speed_factor replaces the declared
    constant). An injected table applies regardless of
    `use_calibration`, which only gates the process-wide default."""
    sla = sla or SLAConfig()
    if spec.drift_action not in ("reprice", "reject"):
        raise ValueError(
            f"unknown drift_action {spec.drift_action!r} for {spec.name!r} "
            "(expected 'reprice' or 'reject')"
        )
    table = calibration
    if table is None:
        table = fit_spec_calibration(spec, hw=hw)
    if spec.drift_bound is not None:
        # the drift gate needs a table to hold its EWMA; arm the pool's
        # existing one (an injected table's own bound wins) or create
        # one that reproduces the pool's table-less stage times exactly
        # (the default dry-run loader when calibration is on, unit
        # factors when it is off)
        if table is None:
            from .calibration import CalibrationTable, _load_default_factor

            table = CalibrationTable(
                loader=_load_default_factor if use_calibration else None,
                source=f"drift-gate:{spec.name}",
                drift_bound=spec.drift_bound,
            )
        elif table.drift_bound is None:
            table.drift_bound = spec.drift_bound
    cm = CostModel(
        hw=hw,
        use_calibration=use_calibration,
        decode_chunk_tokens=decode_chunk_tokens,
        speed_factor=spec.speed_factor,
        calibration=table,
        parallel_overhead=spec.parallel_overhead,
    )
    if spec.kind == "elastic":
        pool: ClusterExecutor = HighElasticCluster(
            cost_model=cm,
            hw=hw,
            startup_s=spec.startup_s,
            min_chips=spec.min_chips,
            max_chips=spec.chips,
            tokens_per_chip=spec.tokens_per_chip,
            fault=fault,
            rng=rng,
        )
    elif spec.kind == "reserved":
        preempt = (
            sla.preempt_best_effort
            if spec.preempt_best_effort is None
            else spec.preempt_best_effort
        )
        pool = CostEfficientCluster(
            chips=spec.chips,
            mode=spec.mode,
            max_concurrent=spec.max_concurrent,
            interference_alpha=spec.interference_alpha,
            sos_slice_chips=spec.slice_chips,
            cost_model=cm,
            hw=hw,
            fault=fault,
            rng=rng,
            autoscale=spec.autoscale,
            preempt_best_effort=preempt,
        )
    else:
        raise ValueError(f"unknown pool kind {spec.kind!r} for {spec.name!r}")
    pool.name = spec.name
    pool.price_per_chip_s = spec.effective_price_per_chip_hour(hw) / 3600.0
    pool.spec = spec  # type: ignore[attr-defined]
    if spec.allocation is not None:
        pool.allocator = Allocator(cm, spec.allocation)
    return pool


def build_live_pool(spec: PoolSpec, *, engine) -> ClusterExecutor:
    """Live counterpart of `build_pool`: the same PoolSpec vocabulary
    instantiates thread-backed executors that run real jitted model work
    on this host (core/live.py):

      kind="reserved" -> LiveReservedPool (one serialized worker thread
                         per chip — the interference-free tier)
      kind="elastic"  -> LiveElasticPool (a task pool of up to `chips`
                         threads with a provisioning sleep of startup_s)

    `engine` is the owning LiveEngine (model pool, clock, checkpoint
    store, result sinks). Imported lazily: the live classes pull in torch
    and the model zoo, which the control plane alone never needs."""
    from .live import LiveElasticPool, LiveReservedPool

    if spec.kind == "elastic":
        return LiveElasticPool(spec, engine)
    if spec.kind == "reserved":
        return LiveReservedPool(spec, engine)
    raise ValueError(f"unknown pool kind {spec.kind!r} for {spec.name!r}")


def default_live_pool_specs(
    *,
    cf_startup_s: float = 0.3,
    cf_price_multiplier: float = 10.0,
) -> list[PoolSpec]:
    """The legacy live pair: one serialized cost-efficient worker thread
    and a 16-way elastic thread pool with a provisioning sleep — the
    pre-registry LiveEngine, now expressed as two PoolSpecs."""
    return [
        PoolSpec(name="vm", kind="reserved", chips=1),
        PoolSpec(
            name="cf",
            kind="elastic",
            chips=16,
            startup_s=cf_startup_s,
            price_multiplier=cf_price_multiplier,
        ),
    ]


def default_pool_specs(
    *,
    vm_chips: int = 4,
    vm_mode: str = "pos",
    interference_alpha: float = 0.5,
    sos_slice_chips: int = 32,
    cf_startup_s: float = 2.0,
    elastic_price_multiplier: float = 10.0,
    autoscale: Optional[AutoscaleConfig] = None,
) -> list[PoolSpec]:
    """The paper's two-pool system (reserved VM + elastic CF) as a
    registry — the SimConfig default, bit-for-bit the two-cluster simulator."""
    return [
        PoolSpec(
            name="vm",
            kind="reserved",
            chips=vm_chips,
            mode=vm_mode,
            slice_chips=sos_slice_chips,
            interference_alpha=interference_alpha,
            autoscale=autoscale,
        ),
        PoolSpec(
            name="cf",
            kind="elastic",
            chips=64,
            min_chips=4,
            startup_s=cf_startup_s,
            price_multiplier=elastic_price_multiplier,
        ),
    ]
