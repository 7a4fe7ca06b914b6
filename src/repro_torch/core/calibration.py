"""Per-pool calibration: fit cost models from measurements, both ways.

The flexible-SLA menu (paper §3.3 vision 1) stands on a *deterministic,
accurate* cost model — admission prices and latency quotes are only as
honest as the stage-time predictions behind them. Kassing et al. and
Skyrise both show that per-resource-tier calibration against measured
execution is what makes a cost/latency frontier trustworthy. This module
closes the quote→measurement loop in both directions:

offline — ``fit_dryruns(dir)`` fits a pool's ``speed_factor`` and
    per-(arch, kind) correction factors from the dry-run JSONs recorded
    on that pool's hardware (``PoolSpec.dryrun_dir`` / ``hw_tag``),
    replacing the old module-global ``lru_cache`` over ``results/dryrun``
    with an explicit, invalidatable ``CalibrationTable``.

online — ``LiveCalibrator`` fits corrections from the pools' own
    measured ``stage_trace`` walls (an EWMA over predicted-vs-actual
    stage ratios in log space), persists them to JSON, and hot-swaps
    them into each pool's cost model at stage boundaries. Calibration
    scales stage *times*, never plan *structure*, so a mid-plan stage
    cursor stays valid across a hot swap — the same invariant that makes
    spill and preemption resume safe.

Fit model: ``measured = analytic(arch, kind) * factor(arch, kind) /
speed_factor``. Given per-record ratios r_i = measured_i / analytic_i,
the pool speed is the inverted geometric-mean ratio (one number for the
whole pool's hardware) and the per-(arch, kind) factors absorb what a
single speed cannot (attention vs SSM kernels, train vs serve).
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import threading
from pathlib import Path
from typing import Callable, Iterable, Optional

from ..configs import get_config
from ..perf.hw import H100, HwSpec
from . import cost_model as _cost_model
from .cost_model import CostModel, _analytic_step

# factors outside these bounds mean the record (or the analytic model) is
# broken — clamp rather than poison every quote with it
FACTOR_BOUNDS = (0.25, 20.0)
SPEED_BOUNDS = (1.0 / 64.0, 64.0)

# one global version sequence: ANY new or mutated table gets a version no
# cached plan has seen, so CostModel._plan_cache invalidation is a simple
# integer comparison even when the table object itself is swapped
_VERSION = itertools.count(1)


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


def _geomean(vals: Iterable[float]) -> float:
    logs = [math.log(v) for v in vals]
    return math.exp(sum(logs) / len(logs))


class CalibrationTable:
    """Explicit calibration state for one cost model: a fitted pool
    ``speed_factor`` (None keeps the declared constant) plus
    per-(arch, kind) correction factors. Every mutation bumps
    ``version``, which is what lets ``CostModel`` invalidate its plan
    cache — the old module-level ``lru_cache`` could never be updated
    after first use."""

    def __init__(
        self,
        factors: Optional[dict] = None,
        speed_factor: Optional[float] = None,
        source: str = "",
        loader: Optional[Callable[[str, str], float]] = None,
        drift_bound: Optional[float] = None,
        drift_alpha: float = 0.25,
        drift_min_samples: int = 4,
    ):
        self._factors: dict[tuple[str, str], float] = dict(factors or {})
        self.speed_factor = speed_factor
        self.source = source
        self._loader = loader
        self.version = next(_VERSION)
        #: admission-control drift gate: when the EWMA of measured /
        #: predicted stage walls strays more than this relative bound
        #: from 1.0, the coordinator stops quoting this pool's stale
        #: speed (reprice at measured speed, or reject — see
        #: scheduler.QueryCoordinator). None disables the gate.
        self.drift_bound = drift_bound
        self.drift_alpha = drift_alpha
        self.drift_min_samples = drift_min_samples
        self._drift_log = 0.0  # log-space EWMA of measured/predicted
        self._drift_n = 0

    # --- admission-control drift gate ---------------------------------
    def observe_drift(self, predicted_s: float, measured_s: float) -> None:
        """Feed one predicted-vs-measured stage wall into the drift
        EWMA. Deliberately NOT a version bump: drift gates ADMISSION
        (quotes get repriced or rejected), it does not rescale plans —
        plan caches stay valid, and only a real re-fit (``update`` /
        ``set_speed_factor``, e.g. LiveCalibrator.maybe_apply) moves
        the version."""
        if predicted_s <= 0 or measured_s <= 0:
            return
        lr = math.log(measured_s / predicted_s)
        if self._drift_n == 0:
            self._drift_log = lr
        else:
            a = self.drift_alpha
            self._drift_log = (1.0 - a) * self._drift_log + a * lr
        self._drift_n += 1

    def drift_ratio(self) -> Optional[float]:
        """EWMA of measured/predicted stage walls (None before the first
        observation). >1: the pool runs slower than quoted."""
        return math.exp(self._drift_log) if self._drift_n else None

    def drift_samples(self) -> int:
        return self._drift_n

    def drift_exceeded(self) -> bool:
        """Whether quotes from this table's pool are currently stale:
        the gate is armed (a bound is set and enough walls were seen)
        and the drift EWMA strays past the bound."""
        if self.drift_bound is None or self._drift_n < self.drift_min_samples:
            return False
        return abs(math.exp(self._drift_log) - 1.0) > self.drift_bound

    def reset_drift(self) -> None:
        """Forget the drift EWMA (a re-fit just landed: the new speed is
        the measured one, so the old residuals no longer apply)."""
        self._drift_log = 0.0
        self._drift_n = 0

    def factor(self, arch: str, kind: str) -> float:
        """Correction factor for one (arch, kind). A miss asks the
        loader (the default table reads results/dryrun lazily) and
        caches the answer — a deterministic fill, not a mutation, so the
        version does not move."""
        key = (arch, kind)
        f = self._factors.get(key)
        if f is None:
            f = self._loader(arch, kind) if self._loader is not None else 1.0
            self._factors[key] = f
        return f

    # --- mutations (each bumps version -> plan caches invalidate) -----
    def set_factor(self, arch: str, kind: str, value: float) -> None:
        self._factors[(arch, kind)] = _clamp(value, *FACTOR_BOUNDS)
        self.version = next(_VERSION)

    def set_speed_factor(self, value: Optional[float]) -> None:
        self.speed_factor = (
            None if value is None else _clamp(value, *SPEED_BOUNDS)
        )
        self.version = next(_VERSION)

    def update(
        self,
        factors: Optional[dict] = None,
        speed_factor: Optional[float] = None,
    ) -> None:
        """Batch mutation: one version bump for any number of changes."""
        for (arch, kind), v in (factors or {}).items():
            self._factors[(arch, kind)] = _clamp(v, *FACTOR_BOUNDS)
        if speed_factor is not None:
            self.speed_factor = _clamp(speed_factor, *SPEED_BOUNDS)
        self.version = next(_VERSION)

    def invalidate(self) -> None:
        """Drop every cached/learned factor and bump the version: the
        next lookup re-reads the source (dry-run JSONs may have been
        re-recorded)."""
        self._factors.clear()
        self.version = next(_VERSION)

    # --- persistence ---------------------------------------------------
    def as_dict(self) -> dict:
        out = {
            "speed_factor": self.speed_factor,
            "factors": {
                f"{arch}/{kind}": round(v, 6)
                for (arch, kind), v in sorted(self._factors.items())
            },
            "source": self.source,
        }
        # drift-gate config only when armed: ungated tables keep the
        # legacy payload byte-identical
        if self.drift_bound is not None:
            out["drift_bound"] = self.drift_bound
            out["drift_alpha"] = self.drift_alpha
            out["drift_min_samples"] = self.drift_min_samples
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationTable":
        factors = {}
        for key, v in (d.get("factors") or {}).items():
            arch, _, kind = key.partition("/")
            factors[(arch, kind)] = float(v)
        return cls(
            factors=factors,
            speed_factor=d.get("speed_factor"),
            source=d.get("source", ""),
            drift_bound=d.get("drift_bound"),
            drift_alpha=float(d.get("drift_alpha", 0.25)),
            drift_min_samples=int(d.get("drift_min_samples", 4)),
        )

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.as_dict(), indent=1,
                                         sort_keys=True) + "\n")

    @classmethod
    def load(cls, path) -> "CalibrationTable":
        return cls.from_dict(json.loads(Path(path).read_text()))


# ---------------------------------------------------------------------------
# the default table: lazy results/dryrun semantics of the old lru_cache,
# now invalidatable
# ---------------------------------------------------------------------------

# canonical dry-run cells the legacy calibration read (dryrun.py output)
_KIND_SHAPE = {"serve": "prefill_32k", "train": "train_4k"}
_SHAPE_TOKENS = {"prefill_32k": 32 * 32768, "train_4k": 256 * 4096}

_default: Optional[CalibrationTable] = None


def _load_default_factor(arch: str, kind: str) -> float:
    """HLO-derived step time / analytic step time, from the canonical
    dry-run record in ``results/dryrun`` (the legacy behavior)."""
    shape = _KIND_SHAPE.get(kind)
    if shape is None:
        return 1.0
    path = _cost_model.RESULTS / f"{arch}__{shape}__16x16.json"
    if not path.exists():
        return 1.0
    try:
        rec = json.loads(path.read_text())
        terms = rec["roofline"]["terms"]
        cfg = get_config(arch)
        an = _analytic_step(cfg, _SHAPE_TOKENS[shape], kind,
                            chips=rec["chips"])
        return _clamp(terms["step_s"] / an, *FACTOR_BOUNDS) if an else 1.0
    except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError,
            ZeroDivisionError):
        # malformed/partial dry-run record: the declared constant stands
        return 1.0


def default_table() -> CalibrationTable:
    """The process-wide table backing ``CostModel(use_calibration=True)``
    when no table is injected — same semantics as the old global
    ``lru_cache``, but explicitly invalidatable."""
    global _default
    if _default is None:
        _default = CalibrationTable(
            source=str(_cost_model.RESULTS), loader=_load_default_factor
        )
    return _default


def invalidate_default_calibration() -> None:
    """Drop the default table's cached factors; every CostModel using it
    re-plans on its next call (dry-run records changed on disk)."""
    if _default is not None:
        _default.invalidate()


# ---------------------------------------------------------------------------
# offline fit: dry-run JSONs -> (speed_factor, per-(arch, kind) factors)
# ---------------------------------------------------------------------------

def _parse_dryrun_record(rec: dict) -> Optional[tuple]:
    """(arch, kind, chips, tokens, step_s) from one dry-run JSON, or
    None when the record is unusable (skipped/errored cells)."""
    if rec.get("status") not in (None, "ok"):
        return None
    try:
        arch = rec["arch"]
        chips = int(rec["chips"])
        step_s = float(rec["roofline"]["terms"]["step_s"])
    except (KeyError, TypeError, ValueError):
        return None
    shape = rec.get("shape", "")
    kind = rec.get("kind") or ("train" if "train" in shape else "serve")
    tokens = rec.get("tokens") or _SHAPE_TOKENS.get(shape)
    if tokens is None or step_s <= 0 or chips <= 0:
        return None
    return arch, kind, chips, int(tokens), step_s


def _record_matches_hw(rec: dict, fname: str, hw_tag: str) -> bool:
    """Match the record's "hw" field exactly, or the tag as a whole
    "__"-delimited filename segment (dryrun.py names are
    arch__shape__mesh[__variant].json) — substring matching would let
    hw_tag="v5" swallow both v5e and v5p records."""
    if not hw_tag:
        return True
    if rec.get("hw") == hw_tag:
        return True
    stem = fname[:-5] if fname.endswith(".json") else fname
    return hw_tag in stem.split("__")


def fit_dryruns(
    dryrun_dir,
    *,
    hw: HwSpec = H100,
    hw_tag: str = "",
) -> CalibrationTable:
    """Fit one pool's calibration from the dry-run JSONs recorded on its
    hardware. ``hw_tag`` filters a mixed directory to the records whose
    ``"hw"`` field (or filename) carries the tag.

    speed_factor = 1 / geomean(measured_i / analytic_i)   over all records
    factor(a, k) = geomean(ratio over that (arch, kind)) * speed_factor

    so a uniformly-4x-slow pool fits speed 0.25 with every factor at 1.0,
    and per-(arch, kind) residuals absorb what one speed cannot."""
    dryrun_dir = Path(dryrun_dir)
    ratios: dict[tuple[str, str], list[float]] = {}
    n_records = 0
    # files silently dropped used to be invisible (the RL004 bug shape:
    # a fit quietly computed from fewer records than the caller shipped);
    # now every skip is named with its reason in the table's source
    skipped: list[str] = []
    for p in sorted(dryrun_dir.glob("*.json")):
        try:
            rec = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError) as err:
            skipped.append(f"{p.name}: unreadable ({type(err).__name__})")
            continue
        if not _record_matches_hw(rec, p.name, hw_tag):
            continue  # intentional filter, not a skip worth surfacing
        parsed = _parse_dryrun_record(rec)
        if parsed is None:
            skipped.append(f"{p.name}: unrecognized record shape")
            continue
        arch, kind, chips, tokens, step_s = parsed
        try:
            cfg = get_config(arch)
        except KeyError:
            skipped.append(f"{p.name}: unknown arch {arch!r}")
            continue
        an = _analytic_step(cfg, tokens, kind, chips=chips, hw=hw)
        if an <= 0:
            skipped.append(f"{p.name}: non-positive analytic step")
            continue
        ratios.setdefault((arch, kind), []).append(step_s / an)
        n_records += 1
    if not ratios:
        raise ValueError(
            f"no usable dry-run records in {dryrun_dir}"
            + (f" matching hw_tag={hw_tag!r}" if hw_tag else "")
        )
    speed = _clamp(
        1.0 / _geomean([r for rs in ratios.values() for r in rs]),
        *SPEED_BOUNDS,
    )
    factors = {
        key: _clamp(_geomean(rs) * speed, *FACTOR_BOUNDS)
        for key, rs in ratios.items()
    }
    table = CalibrationTable(
        factors=factors,
        speed_factor=speed,
        source=f"dryrun:{dryrun_dir}"
        + (f"#{hw_tag}" if hw_tag else "")
        + f" ({n_records} records)"
        + (f" [skipped {len(skipped)}: " + "; ".join(skipped) + "]"
           if skipped else ""),
    )
    return table


# ---------------------------------------------------------------------------
# online fit: measured stage walls -> per-pool speed correction (EWMA)
# ---------------------------------------------------------------------------

def _fitted_speed(st: dict) -> float:
    """The one fit expression every read-out shares: the speed the
    pool's DECLARED constant should have been, given the EWMA of
    measured/predicted ratios recorded against that declared speed."""
    return _clamp(st["declared"] / math.exp(st["log_ratio"]), *SPEED_BOUNDS)


class LiveCalibrator:
    """Closes quote→measurement drift from the pools' own measured stage
    walls. Per pool it keeps a log-space EWMA of the ratio

        r = measured stage wall / reference prediction

    where the *reference* is a frozen copy of the pool's cost model at
    its DECLARED speed — predictions for the ratio never chase the
    corrections, so the fit is a stable fixed point:

        fitted speed_factor = declared speed_factor / ewma(r)

    ``maybe_apply`` hot-swaps the fitted speed into the pool's cost
    model at a stage boundary (a `CalibrationTable` version bump, so
    plan caches invalidate but plan structure — and therefore every
    mid-plan stage cursor — is untouched) and persists the state to
    ``path`` when one is configured."""

    #: relative speed change below which a hot swap is skipped (avoids
    #: re-planning every pool on sub-permille EWMA wiggle)
    APPLY_EPSILON = 1e-3

    #: lock contract (read by core.sanitize).
    _GUARDED_BY = {
        "_state": "_mu",
        "_tables": "_mu",
        "_refs": "_mu",
    }

    def __init__(
        self,
        alpha: float = 0.25,
        min_samples: int = 8,
        path=None,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.min_samples = min_samples
        self.path = Path(path) if path is not None else None
        self._mu = threading.Lock()
        # pool name -> {"log_ratio": EWMA, "n": samples, "declared": speed}
        self._state: dict[str, dict] = {}
        self._tables: dict[str, CalibrationTable] = {}
        self._refs: dict[str, CostModel] = {}
        self._save_mu = threading.Lock()  # serializes persistence writes
        if self.path is not None and self.path.exists():
            self.load(self.path)

    # --- observation ---------------------------------------------------
    def _ref_model(self, pool) -> CostModel:
        """Frozen declared-speed model the ratios are measured against.
        It carries the pool's offline-fitted per-(arch, kind) factors
        (speed excluded), so the EWMA measures only the residual SPEED
        error beyond the offline fit and the two compose cleanly."""
        with self._mu:
            cm = self._refs.get(pool.name)
            # rebuild on a declared-speed change: the frozen reference
            # must always reflect the CURRENT spec, like the EWMA state
            if cm is None or cm.speed_factor != pool.cost_model.speed_factor:
                src = pool.cost_model
                base = src.calibration
                ref_table = (
                    CalibrationTable(factors=dict(base._factors))
                    if base is not None
                    else None
                )
                cm = CostModel(
                    hw=src.hw,
                    use_calibration=False,
                    decode_chunk_tokens=src.decode_chunk_tokens,
                    speed_factor=src.speed_factor,
                    calibration=ref_table,
                )
                self._refs[pool.name] = cm
            return cm

    def observe(self, pool, work, index: int, chips: int,
                wall_s: float) -> None:
        """Record one measured stage wall: stage ``index`` of ``work``'s
        plan ran on ``pool`` in ``wall_s`` seconds on a ``chips`` slice."""
        plan = self._ref_model(pool).plan(work, chips)
        if not 0 <= index < len(plan.stages):
            return
        predicted = plan.stages[index].time_s
        if predicted <= 0 or wall_s <= 0:
            return
        lr = math.log(wall_s / predicted)
        # admission-control drift: the pool's ACTIVE table (when its
        # gate is armed) also sees the wall, measured against the
        # CURRENT model — the one quotes are made from — not the frozen
        # declared reference the speed fit uses
        table = pool.cost_model.calibration
        if table is not None and table.drift_bound is not None:
            cur = pool.cost_model.plan(work, chips)
            cur_pred = cur.stages[index].time_s
            if cur_pred > 0:
                table.observe_drift(cur_pred, wall_s)
        declared = pool.cost_model.speed_factor
        with self._mu:
            st = self._state.get(pool.name)
            if st is None or st["declared"] != declared:
                # first wall, or the pool's DECLARED speed changed since
                # the state was persisted: old ratios were measured
                # against a different reference and would mis-fit —
                # start the EWMA over
                self._state[pool.name] = {
                    "log_ratio": lr, "n": 1, "declared": declared,
                }
                return
            alpha = self.alpha
            if st.get("decayed"):
                # post-replacement re-learn (``decay``): weight fresh
                # walls like the running average of a near-empty window
                # (2/(n+2) is the EWMA whose effective memory is the n
                # samples seen since the decay), so a replaced worker's
                # true speed dominates within a handful of stages; the
                # boost expires once confidence is back at min_samples.
                alpha = max(alpha, 2.0 / (st["n"] + 2.0))
                if st["n"] + 1 >= self.min_samples:
                    st.pop("decayed")
            st["log_ratio"] = (
                (1.0 - alpha) * st["log_ratio"] + alpha * lr
            )
            st["n"] += 1

    def decay(self, pool_name: str) -> bool:
        """Reduce the pool's calibration confidence after a worker
        replacement (core/convergence.py): the replacement host inherits
        the pool EWMA as its prior — the fitted speed stays applied, so
        quotes never snap back to the declared speed — but ``n`` drops
        to 1, re-arming ``maybe_apply``'s min_samples gate and boosting
        ``observe``'s effective alpha until the replacement has re-earned
        the confidence. Returns False when the pool has no state yet."""
        with self._mu:
            st = self._state.get(pool_name)
            if st is None:
                return False
            st["n"] = 1
            st["decayed"] = True
            return True

    def observe_query(self, pool, q) -> None:
        """Convenience: feed every stage of a finished query's trace that
        ran on `pool` (offline analysis of simulated traces)."""
        for e in q.stage_trace:
            if e.cluster == pool.name:
                self.observe(pool, q.work, e.index, e.chips,
                             e.finish - e.start)

    # --- read-outs -----------------------------------------------------
    def ratio(self, pool_name: str) -> Optional[float]:
        """Current EWMA of measured/predicted for the pool (None before
        the first observation)."""
        with self._mu:
            st = self._state.get(pool_name)
            return math.exp(st["log_ratio"]) if st else None

    def samples(self, pool_name: str) -> int:
        with self._mu:
            st = self._state.get(pool_name)
            return st["n"] if st else 0

    def drift_ratio(self, pool) -> Optional[float]:
        """The pool's admission-control drift EWMA (measured/predicted
        against its ACTIVE table), None when the pool carries no table
        or the gate has seen no walls — the per-pool drift bound itself
        lives on the table (``CalibrationTable.drift_bound``)."""
        table = pool.cost_model.calibration
        return table.drift_ratio() if table is not None else None

    def drift_exceeded(self, pool) -> bool:
        table = pool.cost_model.calibration
        return table.drift_exceeded() if table is not None else False

    def fitted_speed_factor(self, pool) -> Optional[float]:
        """Fit against the declared speed the ratios were MEASURED
        under — persisted state may predate a spec change."""
        with self._mu:
            st = self._state.get(pool.name)
            return _fitted_speed(st) if st is not None else None

    # --- the hot swap --------------------------------------------------
    def maybe_apply(self, pool) -> bool:
        """Stage-boundary hot-swap: once ``min_samples`` walls have been
        seen, install/refresh the fitted speed on the pool's cost model.
        Returns True when the model changed. One critical section per
        call: concurrent workers of the same pool must agree on a single
        table, or the pool's cost model could hold an orphan the later
        updates never reach."""
        with self._mu:
            st = self._state.get(pool.name)
            if st is None or st["n"] < self.min_samples:
                return False
            if st["declared"] != pool.cost_model.speed_factor:
                # persisted fit against a since-changed declared spec:
                # don't apply; observe() restarts the EWMA on new walls
                return False
            fitted = _fitted_speed(st)
            table = self._tables.get(pool.name)
            if table is None:
                # seed from the pool's current (offline-fitted) table so
                # the hot swap refines its speed WITHOUT dropping the
                # per-(arch, kind) factors the dry-runs measured. The
                # fitted speed is set BEFORE install: a concurrent
                # plan() between install and a later speed update would
                # otherwise quote at the raw declared constant.
                base = pool.cost_model.calibration
                table = self._tables[pool.name] = CalibrationTable(
                    factors=dict(base._factors) if base is not None else None,
                    speed_factor=fitted,
                    source=f"live:{pool.name}"
                    + (f" over [{base.source}]"
                       if base is not None and base.source else ""),
                    # the drift gate survives the table swap: the live
                    # table inherits the base's admission-control config
                    drift_bound=base.drift_bound if base is not None else None,
                    drift_alpha=base.drift_alpha if base is not None else 0.25,
                    drift_min_samples=(
                        base.drift_min_samples if base is not None else 4
                    ),
                )
                pool.cost_model.set_calibration(table)
            else:
                current = table.speed_factor
                if current is not None and abs(fitted - current) <= (
                    self.APPLY_EPSILON * current
                ):
                    return False
                table.set_speed_factor(fitted)
            # the re-fit just moved quotes to the measured speed — the
            # old drift residuals no longer describe them
            table.reset_drift()
        if self.path is not None:
            self.save(self.path)
        return True

    def table(self, pool_name: str) -> Optional[CalibrationTable]:
        with self._mu:
            return self._tables.get(pool_name)

    # --- persistence ---------------------------------------------------
    def as_dict(self) -> dict:
        with self._mu:
            return {
                "alpha": self.alpha,
                "min_samples": self.min_samples,
                "pools": {
                    name: {
                        "log_ratio": st["log_ratio"],
                        "ratio": round(math.exp(st["log_ratio"]), 6),
                        "n": st["n"],
                        "declared_speed_factor": st["declared"],
                        "fitted_speed_factor": round(_fitted_speed(st), 6),
                    }
                    for name, st in sorted(self._state.items())
                },
            }

    def save(self, path) -> None:
        """Atomic persistence: every pool's worker threads save on an
        applied update, so write-to-temp + rename — a torn or
        interleaved in-place write would crash the next startup's
        load() with invalid JSON."""
        payload = json.dumps(self.as_dict(), indent=1, sort_keys=True) + "\n"
        path = Path(path)
        with self._save_mu:
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_text(payload)
            os.replace(tmp, path)

    def load(self, path) -> None:
        d = json.loads(Path(path).read_text())
        with self._mu:
            for name, st in (d.get("pools") or {}).items():
                self._state[name] = {
                    "log_ratio": float(st["log_ratio"]),
                    "n": int(st["n"]),
                    "declared": float(st.get("declared_speed_factor", 1.0)),
                }


# ---------------------------------------------------------------------------
# drift probe: a measured live run for benchmarks/tests
# ---------------------------------------------------------------------------

def measure_live_speed_drift(
    declared_speed: float,
    *,
    n_queries: int = 12,
    decode_tokens: int = 64,
    decode_chunk_tokens: int = 8,
    alpha: float = 0.2,
    min_samples: int = 10,
    true_speed: Optional[float] = None,
    device: str = "cuda",
):
    """Run a 1-pool LiveEngine with the calibration loop on and record
    the loop's ONLINE decode-wall drift: at each stage boundary,
    ``(samples seen, work, index, wall_s, pred_now)`` where ``pred_now``
    is from the model in effect while the stage ran (observation
    happens before that boundary's hot swap). DECODE walls only: one
    pool speed cannot fit prefill and decode simultaneously (the
    analytic prefill:decode ratio differs from the live engine's — the
    per-(arch, kind) factor axis exists for that), so speed-drift
    claims ride the homogeneous stage type. Returns ``(engine, walls)``
    with the engine already shut down.

    With ``true_speed`` the probe reads no wall clock: the engine's
    clock stands still except at each stage, where it advances by that
    stage's modeled time on a pool whose TRUE speed is ``true_speed``
    (the stages still run the real model work). The measured walls are
    then exact and independent of host load. Without it the walls are
    the host's own, measured on its wall clock."""
    from .live import LiveConfig, LiveEngine
    from .pools import PoolSpec
    from .query import Query, QueryWork
    from .sla import ServiceLevel, SLAConfig

    eng = LiveEngine(LiveConfig(
        pools=[PoolSpec(name="vm", kind="reserved", chips=1,
                        speed_factor=declared_speed)],
        sla=SLAConfig(relaxed_deadline_s=10.0, poll_period_s=0.02,
                      vm_overload_threshold=1_000),
        decode_tokens=decode_tokens,
        decode_chunk_tokens=decode_chunk_tokens,
        calibrate=True, calibration_alpha=alpha,
        calibration_min_samples=min_samples,
        device=device,
    ))
    if true_speed is not None:
        _install_model_clock(eng, CostModel(
            use_calibration=False, decode_chunk_tokens=decode_chunk_tokens,
            speed_factor=true_speed,
        ))
    walls: list[tuple] = []
    orig_observe = eng.calibrator.observe

    def observing(pool, work, index, chips, wall_s):
        if wall_s > 0 and index > 0:
            pred = pool.cost_model.plan(work, chips).stages[index].time_s
            walls.append((eng.calibrator.samples(pool.name), work, index,
                          wall_s, pred))
        orig_observe(pool, work, index, chips, wall_s)

    eng.calibrator.observe = observing
    for _ in range(n_queries):
        eng.submit(Query(work=QueryWork(), sla=ServiceLevel.IMMEDIATE,
                         submit_time=0.0))
    done = [q for q in eng.drain(n_queries, timeout=120)
            if q.state == "done"]
    if len(done) != n_queries:
        raise RuntimeError(
            f"drift probe: only {len(done)}/{n_queries} queries finished"
        )
    return eng, walls


def _install_model_clock(eng, truth: CostModel) -> None:
    """Replace ``eng.now`` with a clock that advances only when a stage
    of ``eng``'s pools ends, by that stage's time in ``truth``'s plan."""
    mu = threading.Lock()
    clock = [0.0]

    def now() -> float:
        with mu:
            return clock[0]

    for pool in eng.pools:
        def modeled(lm, q, pool=pool, work=pool._run_stage_work):
            work(lm, q)
            t_s = truth.plan(q.work, pool._plan_chips(q)).stages[
                q.stage_cursor].time_s
            with mu:
                clock[0] += t_s

        pool._run_stage_work = modeled
    eng.now = now


# ---------------------------------------------------------------------------
# CLI (the CI calibration-smoke entry point)
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Fit a pool calibration table from dry-run JSONs."
    )
    ap.add_argument("--fit", required=True, metavar="DIR",
                    help="directory of dry-run JSONs to fit")
    ap.add_argument("--hw-tag", default="",
                    help="only fit records whose hw field/filename match")
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="write the fitted table here")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the fit produced a usable table")
    args = ap.parse_args(argv)
    table = fit_dryruns(args.fit, hw_tag=args.hw_tag)
    print(json.dumps(table.as_dict(), indent=1, sort_keys=True))
    if args.out:
        table.save(args.out)
    if args.check:  # explicit raises: a gate must survive python -O
        d = table.as_dict()
        if not d["factors"]:
            raise SystemExit("fit produced no (arch, kind) factors")
        if not d["speed_factor"] or d["speed_factor"] <= 0:
            raise SystemExit("fit produced no usable speed_factor")
        print(f"calibration-smoke OK: {len(d['factors'])} factors, "
              f"speed_factor={d['speed_factor']:.4f}")


if __name__ == "__main__":
    main()
