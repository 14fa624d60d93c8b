"""Latency arithmetic.  A failed statement counts as ``inf``: slower than
every statement that came back, so it misses every latency limit."""

from __future__ import annotations

import math
import statistics

FAILED = math.inf


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (0..100) by linear interpolation between
    order statistics (numpy's default).  ``inf`` entries sort last; an
    interpolation that touches one gives ``inf``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    if frac == 0.0:
        return xs[lo]
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def spread(values) -> float:
    """Distance between the first and third quartiles over the median, as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2


def window_latencies_ms(records) -> list:
    """Each record's send-to-rows latency in ms, ``inf`` where it failed."""
    return [(r.t_done - r.t_send) * 1e3 if r.error is None else FAILED
            for r in records]


def latency_metrics(latencies_ms, done_in_window: int,
                    seconds: float) -> dict:
    """qps over the window, p50 and p95 in ms over every statement sent in
    it (failures as ``inf``)."""
    return {"qps": done_in_window / seconds,
            "latency_p50_ms": percentile(latencies_ms, 50),
            "latency_p95_ms": percentile(latencies_ms, 95)}
