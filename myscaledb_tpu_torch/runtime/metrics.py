"""Copy of myscaledb_tpu/runtime/metrics.py (JAX-free; imports renamed to this package).

Engine counters and gauges.

Reference analog: 425 cumulative ProfileEvents (src/Common/ProfileEvents.cpp)
+ 198 CurrentMetrics gauges (src/Common/CurrentMetrics.cpp), exported via
system.events / system.metrics.  The host runtime is single-process Python,
so a lock-guarded dict suffices; the names mirror the reference's where the
semantics carried over.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_lock = threading.Lock()
_events: dict[str, int] = defaultdict(int)        # cumulative counters
_metrics: dict[str, int] = defaultdict(int)       # current gauges
_timings: dict[str, float] = defaultdict(float)   # cumulative seconds

# counter names kept aligned with the reference where meaningful
QUERY = "Query"
SELECT_QUERY = "SelectQuery"
SELECTED_ROWS = "SelectedRows"
RESULT_ROWS = "ResultRows"
VECTOR_SCAN_ROWS = "VectorScanRows"
VECTOR_SCAN_QUERIES = "VectorScanQueries"
AGG_ROWS = "AggregatedRows"
JOIN_PROBE_ROWS = "JoinProbeRows"
SORTED_ROWS = "SortedRows"
FAILED_QUERY = "FailedQuery"
PARTS_WRITTEN = "PartsWritten"
PARTS_MERGED = "PartsMerged"
COMPRESSED_BYTES = "CompressedWrittenBytes"
RETRIES = "HostRetries"
INJECTED_FAULTS = "InjectedFaults"


def increment(name: str, value: int = 1) -> None:
    with _lock:
        _events[name] += value


def set_metric(name: str, value: int) -> None:
    with _lock:
        _metrics[name] = value


def add_time(name: str, seconds: float) -> None:
    with _lock:
        _timings[name] += seconds


@contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add_time(name, time.perf_counter() - t0)


def events_snapshot() -> dict[str, int]:
    with _lock:
        return dict(_events)


def metrics_snapshot() -> dict[str, int]:
    with _lock:
        return dict(_metrics)


def timings_snapshot() -> dict[str, float]:
    with _lock:
        return dict(_timings)


def reset() -> None:
    with _lock:
        _events.clear()
        _metrics.clear()
        _timings.clear()
