"""One-switch runtime sanitizer for the engine's correctness contracts.

``REPRO_SANITIZE=1`` (or ``SimConfig.sanitize=True``) turns on, together:

  * the incremental-vs-scan backlog check and heap invariant previously
    gated on ``REPRO_DEBUG_BACKLOG`` (engine.ClusterExecutor.advance_to),
  * lock-held asserts on the live engine's guarded attributes, generated
    from the ``_GUARDED_BY`` class registries,
  * lock-ORDER asserts: acquisitions that descend the lock hierarchy
    (``LOCK_RANKS``, the JAX package's statically derived table; this
    package's threaded modules keep its lock names) raise before they
    can deadlock; ``tests/test_torch_core_sched.py`` pins the table to
    the JAX package's,
  * post-run chip-second conservation and gap/overlap-free stage-trace
    asserts over the finished population (``check_result``).

Checks raise ``SanitizeError`` (an AssertionError, so pytest and the
hypothesis suite report them natively). The switch is read once at
import; tests flip it with ``set_enabled``. All checks are observers:
with the sanitizer off NOTHING runs, and with it on results must be
bit-identical.
"""
from __future__ import annotations

import os
import threading
from typing import Iterable

_ENABLED = os.environ.get("REPRO_SANITIZE", "") == "1"

#: chip-second conservation tolerance: sums of per-stage billed seconds
#: are compared to per-query totals accumulated sequentially, so only
#: float re-association across the population needs slack.
REL_TOL = 1e-9
#: trace stitching tolerance
EPS = 1e-9


class SanitizeError(AssertionError):
    """A correctness contract was violated at runtime."""


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> bool:
    """Flip the global switch (tests); returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


# --- lock-held guards, driven by the _GUARDED_BY registries ---------------

def _lock_held(lock) -> bool:
    # RLock / Condition expose _is_owned (held by THIS thread); a plain
    # Lock only knows locked() (held by someone — the best it can say).
    probe = getattr(lock, "_is_owned", None)
    if probe is not None:
        try:
            return bool(probe())
        except TypeError:
            pass
    locked = getattr(lock, "locked", None)
    return bool(locked()) if locked is not None else True


def guard(obj, attr: str) -> None:
    """Assert that one of the locks ``type(obj)._GUARDED_BY[attr]``
    declares is currently held. No-op when the sanitizer is off or the
    attribute is not in the registry — callers sprinkle ``guard(self,
    "waiting")`` at the top of ``*_locked`` helpers, so the check covers
    their callers)."""
    if not _ENABLED:
        return
    registry = getattr(type(obj), "_GUARDED_BY", None)
    if not registry or attr not in registry:
        return
    locks = registry[attr]
    if isinstance(locks, str):
        locks = (locks,)
    for name in locks:
        lock = getattr(obj, name, None)
        if lock is not None and _lock_held(lock):
            return
    raise SanitizeError(
        f"sanitize: {type(obj).__name__}.{attr} accessed without holding "
        f"{' or '.join(locks)} (declared in _GUARDED_BY)"
    )


# --- lock-order enforcement ----------------------------------------------

#: the lock hierarchy: every lock ranked by its longest acquisition path
#: (outer locks rank lower, nested-inner locks higher), as the JAX
#: package's static lock graph derives it for the same classes and lock
#: names. Acquiring DOWN the hierarchy — a lower-ranked lock while
#: holding a higher-ranked one — is the ABBA half of a potential
#: deadlock, caught here before it can block. Equal-rank locks carry no
#: nesting evidence and are left unconstrained.
LOCK_RANKS = {
    "LiveExecutor._mu": 0,
    "_ModelPool._lock": 0,
    "CrossPoolFusionIndex._lock": 1,
}

_held_tls = threading.local()


def _held_stack() -> list:
    st = getattr(_held_tls, "stack", None)
    if st is None:
        st = _held_tls.stack = []
    return st


def check_lock_order(label: str) -> None:
    """Raise if acquiring ``label`` NOW would descend the static lock
    hierarchy on this thread. Called before the underlying acquire, so
    the violation surfaces as a stack trace instead of a deadlock."""
    rank = LOCK_RANKS.get(label)
    if rank is None:
        return
    for held_label, held_rank in _held_stack():
        if held_label != label and held_rank is not None and held_rank > rank:
            raise SanitizeError(
                f"sanitize: acquiring {label} (rank {rank}) while "
                f"holding {held_label} (rank {held_rank}) descends the "
                f"static lock hierarchy — the reverse nesting exists in "
                f"the code, so this order can deadlock (ABBA)"
            )


class _OrderedLock:
    """Transparent wrapper around a ``threading`` lock that enforces
    :data:`LOCK_RANKS` when the sanitizer is on. Off, each acquire costs
    one extra attribute hop and nothing else; results are bit-identical
    either way (the wrapper never reorders or blocks differently).
    ``Condition(wrapped_mu)`` works: the Condition binds the wrapper's
    ``acquire``/``release`` (order-checked) and reaches ``_is_owned`` /
    ``_release_save`` / ``_acquire_restore`` through ``__getattr__``."""

    __slots__ = ("_label", "_raw")

    def __init__(self, label: str, raw) -> None:
        object.__setattr__(self, "_label", label)
        object.__setattr__(self, "_raw", raw)

    def acquire(self, *args, **kwargs) -> bool:
        if _ENABLED:
            check_lock_order(self._label)
        got = self._raw.acquire(*args, **kwargs)
        if got and _ENABLED:
            _held_stack().append((self._label, LOCK_RANKS.get(self._label)))
        return got

    def release(self) -> None:
        if _ENABLED:
            # tolerate an enable-flip mid-hold: pop only what was pushed
            st = _held_stack()
            for i in range(len(st) - 1, -1, -1):
                if st[i][0] == self._label:
                    del st[i]
                    break
        self._raw.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_raw"), name)


def ordered_lock(label: str, raw):
    """Wrap ``raw`` (a ``threading`` lock) so acquisitions are checked
    against the static lock hierarchy under ``REPRO_SANITIZE=1``. The
    ``label`` is the lock graph's node name, ``Class.attr``."""
    return _OrderedLock(label, raw)


# --- post-run population checks -------------------------------------------

def check_result(queries: Iterable) -> None:
    """Chip-second conservation + gap/overlap-free traces over finished
    queries. Mirrors tests/test_properties.py::_check_fusion_invariants:
    fused members share one stage trace (carried by member 0) and split
    the bill, so conservation is checked over the POPULATION — traces
    deduped by identity — while per-query exactness holds only for
    unfused queries."""
    if not _ENABLED:
        return
    qs = [q for q in queries if q is not None]
    billed_total = 0.0
    for q in qs:
        billed_total += q.chip_seconds
        tr = getattr(q, "stage_trace", None)
        if not tr:
            continue
        # stage indices contiguous from 0, stages stitched in time
        idx = [e.index for e in tr]
        if idx != list(range(len(tr))):
            raise SanitizeError(
                f"sanitize: q{q.qid} stage trace indices {idx} are not "
                f"contiguous from 0 — a stage was dropped or duplicated"
            )
        for a, b in zip(tr, tr[1:]):
            if b.start < a.finish - EPS:
                raise SanitizeError(
                    f"sanitize: q{q.qid} stage {b.index} starts at "
                    f"{b.start} before stage {a.index} finishes at "
                    f"{a.finish} — overlapping execution of one query"
                )
        if (
            getattr(q, "fused_with", 0) == 0
            and getattr(q, "members", None) is None
        ):
            trace_cs = sum(e.chip_seconds for e in tr)
            if abs(trace_cs - q.chip_seconds) > max(
                REL_TOL * abs(q.chip_seconds), REL_TOL
            ):
                raise SanitizeError(
                    f"sanitize: q{q.qid} billed {q.chip_seconds} chip-s "
                    f"but its stage trace sums to {trace_cs} — billing "
                    f"and trace disagree"
                )
    # population conservation: every billed chip-second appears in
    # exactly one stage-trace event (fused members share a trace object)
    seen: set[int] = set()
    trace_total = 0.0
    for q in qs:
        tr = getattr(q, "stage_trace", None)
        if not tr or id(tr) in seen:
            continue
        seen.add(id(tr))
        for e in tr:
            trace_total += e.chip_seconds
    if abs(trace_total - billed_total) > max(REL_TOL * abs(billed_total), REL_TOL):
        raise SanitizeError(
            f"sanitize: population billed {billed_total} chip-s but "
            f"stage traces account for {trace_total} — chip-seconds "
            f"created or destroyed"
        )
