"""Copy of myscaledb_tpu/runtime/memory.py (JAX-free; imports renamed to this package),
plus ``uncharged``.

Hierarchical memory budget: query -> process.

Reference analog: MemoryTracker (src/Common/MemoryTracker.h:50) — every
allocation charges a query-level tracker chained to the server tracker;
exceeding a limit throws MEMORY_LIMIT_EXCEEDED and the query dies cleanly
instead of OOM-killing the process.  Here the charged quantities are the
engine's own HBM-sized intermediates (join builds, shuffles, score
matrices, sort buffers) estimated at the operator boundary — the goal is
the same: a 10M-key build or a giant shuffle must fail with a budget error,
not crash the worker (round 2's config 4 did exactly that).

Operators call ``charge(nbytes, site)`` inside a ``query_scope``; the
charge is released when the scope exits.  Tracking is advisory-estimated
(XLA owns the real allocator), which matches how the reference treats
untracked allocations from external libs.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class MemoryLimitExceeded(RuntimeError):
    pass


class MemoryTracker:
    def __init__(self, limit: int | None = None,
                 parent: "MemoryTracker | None" = None, name: str = "total"):
        self._lock = threading.Lock()
        self.limit = limit
        self.parent = parent
        self.name = name
        self.used = 0
        self.peak = 0

    def charge(self, nbytes: int, site: str = "") -> None:
        if nbytes <= 0:
            return
        with self._lock:
            new = self.used + nbytes
            if self.limit is not None and new > self.limit:
                raise MemoryLimitExceeded(
                    f"{self.name} memory limit exceeded at {site or '?'}: "
                    f"would use {new} > limit {self.limit} bytes "
                    f"(attempted +{nbytes})")
            self.used = new
            self.peak = max(self.peak, new)
        if self.parent is not None:
            try:
                self.parent.charge(nbytes, site)
            except MemoryLimitExceeded:
                with self._lock:
                    self.used -= nbytes
                raise

    def release(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            self.used = max(0, self.used - nbytes)
        if self.parent is not None:
            self.parent.release(nbytes)


PROCESS = MemoryTracker(limit=None, name="process")

_tl = threading.local()


def current_query_tracker() -> MemoryTracker | None:
    return getattr(_tl, "query", None)


@contextmanager
def query_scope(limit: int | None):
    """Per-query tracker chained to the process tracker; releases
    everything charged when the query finishes (success or error)."""
    tracker = MemoryTracker(limit=limit, parent=PROCESS, name="query")
    prev = getattr(_tl, "query", None)
    _tl.query = tracker
    try:
        yield tracker
    finally:
        _tl.query = prev
        PROCESS.release(tracker.used)


@contextmanager
def uncharged():
    """Work that no statement's budget covers (a lookup into state the
    session keeps): inside, ``charge`` does nothing, as it does outside
    every ``query_scope``."""
    prev = getattr(_tl, "query", None)
    _tl.query = None
    try:
        yield
    finally:
        _tl.query = prev


def charge(nbytes: int, site: str = "") -> None:
    """Charge the active query tracker (no-op outside a query scope)."""
    t = current_query_tracker()
    if t is not None:
        t.charge(int(nbytes), site)
