"""Copy of myscaledb_tpu/runtime/metrics.py (JAX-free; imports renamed to this package).

Engine counters and gauges.

Reference analog: 425 cumulative ProfileEvents (src/Common/ProfileEvents.cpp)
+ 198 CurrentMetrics gauges (src/Common/CurrentMetrics.cpp), exported via
system.events / system.metrics (the seconds of system.timings are the
spans', runtime/tracing.py).  The host runtime is single-process Python,
so a lock-guarded dict suffices; the names mirror the reference's where the
semantics carried over.
"""

from __future__ import annotations

import threading
from collections import defaultdict

_lock = threading.Lock()
_events: dict[str, int] = defaultdict(int)        # cumulative counters
_metrics: dict[str, int] = defaultdict(int)       # current gauges

# counter names kept aligned with the reference where meaningful
QUERY = "Query"
SELECT_QUERY = "SelectQuery"
SELECTED_ROWS = "SelectedRows"
RESULT_ROWS = "ResultRows"
VECTOR_SCAN_ROWS = "VectorScanRows"
VECTOR_SCAN_QUERIES = "VectorScanQueries"
AGG_ROWS = "AggregatedRows"
JOIN_PROBE_ROWS = "JoinProbeRows"
# rows x storage width of every column a join materializes, and elements
# of join row indexes or masks copied to the host (the port's own)
JOIN_CARRIED_BYTES = "JoinCarriedBytes"
JOIN_ROWS_TO_HOST = "JoinRowsToHost"
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


def events_snapshot() -> dict[str, int]:
    with _lock:
        return dict(_events)


def metrics_snapshot() -> dict[str, int]:
    with _lock:
        return dict(_metrics)


def reset() -> None:
    with _lock:
        _events.clear()
        _metrics.clear()
