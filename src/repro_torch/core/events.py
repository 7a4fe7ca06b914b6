"""Append-only, capped audit event feed (otter's ``log/spec.py`` /
``cloudfeeds.py`` idiom, ROADMAP item 3).

Every control-plane action — placement, preempt, spill, fusion, scale,
worker death, replacement, checkpoint resume, drift intervention — is
recorded as one immutable row:

    (seq, kind, t_s, (sorted (key, value) payload pairs))

The feed is the system's flight recorder, not its WAL: replay means
re-running the recorded day from the same config and seed and checking
the two feeds' ``fingerprint()`` (a SHA-256 over canonical JSON rows)
match bit-for-bit — benchmarks/chaos.py and the chaos-smoke CI job do
exactly that. Rows therefore never contain wall-clock time or id()s;
``t_s`` is the caller's deterministic engine clock.

The buffer is capped (a day of placements at 1M queries would otherwise
hold the whole run live): the oldest rows fall off, ``dropped`` counts
how many, and ``fingerprint()`` folds the total emitted count in so a
truncated feed can never masquerade as a complete one.

Thread-safety: ``emit`` is called from live worker threads and the
scheduler thread concurrently; one plain ``threading.Lock`` guards the
buffer (the lock is a leaf — nothing is ever called while holding it,
so it takes no rank in ``sanitize.LOCK_RANKS``).
"""
from __future__ import annotations

import hashlib
import json
import threading
from collections import deque

#: default row cap — generous for a 5k–50k query chaos day, bounded for
#: a 1M-query one (the fingerprint still covers the drop count)
DEFAULT_CAP = 200_000

#: one row: (seq, kind, t_s, payload_items)
Row = tuple


def row_json(row: Row) -> str:
    """Canonical JSON for one row. ``json.dumps`` renders floats with
    ``repr`` (shortest round-trip), so two rows serialize identically
    iff their floats are bit-identical — which is exactly the replay
    contract the fingerprint enforces."""
    seq, kind, t_s, items = row
    return json.dumps(
        [seq, kind, t_s, [[k, _jsonable(v)] for k, v in items]],
        separators=(",", ":"),
    )


def _jsonable(v):
    if isinstance(v, tuple):
        return list(v)
    return v


class EventFeed:
    """Append-only capped feed of control-plane events.

    ``emit(kind, t_s, **payload)`` is the single producer entry point;
    payload keys are sorted so emission-site dict ordering can never
    leak into the fingerprint. Readers get snapshots (``rows()``), per-
    kind tallies (``counts()``) and the replay digest (``fingerprint()``).
    """

    #: lock contract — core.sanitize reads this.
    _GUARDED_BY = {
        "_rows": "_lock",
        "_seq": "_lock",
    }

    __slots__ = ("cap", "_rows", "_seq", "_lock")

    def __init__(self, cap: int = DEFAULT_CAP):
        self.cap = max(1, int(cap))
        self._rows: deque = deque(maxlen=self.cap)
        self._seq = 0
        self._lock = threading.Lock()

    def emit(self, kind: str, t_s: float, **payload) -> int:
        """Record one event at engine time ``t_s``; returns its seq."""
        # the row is composed OUTSIDE the lock: emit sits on worker hot
        # paths, the critical section is two statements
        items = tuple(sorted(payload.items()))
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._rows.append((seq, kind, t_s, items))
        return seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    @property
    def total(self) -> int:
        """Rows ever emitted (>= len(self) once the cap bites)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Rows that fell off the capped buffer."""
        with self._lock:
            return self._seq - len(self._rows)

    def rows(self) -> list:
        with self._lock:
            return list(self._rows)

    def counts(self) -> dict:
        """Per-kind row tallies over the retained window."""
        out: dict = {}
        for _, kind, _, _ in self.rows():
            out[kind] = out.get(kind, 0) + 1
        return out

    def tail(self, n: int = 20) -> list:
        rows = self.rows()
        return rows[-n:]

    def fingerprint(self) -> str:
        """SHA-256 over the canonical JSON of every retained row plus
        the total emitted count — the replay identity: two runs of the
        same seeded day must produce equal fingerprints, bit-for-bit."""
        with self._lock:
            rows = list(self._rows)
            seq = self._seq
        h = hashlib.sha256()
        h.update(f"total={seq}\n".encode())
        for row in rows:
            h.update(row_json(row).encode())
            h.update(b"\n")
        return h.hexdigest()
