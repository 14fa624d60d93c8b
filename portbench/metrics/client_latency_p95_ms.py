"""client_latency_p95_ms: the 95th percentile of the window's statement
latencies, send to rows on the host, in a cell of several clients on one
session: the clients the execution lock passes over.  A failed statement
counts as slower than any."""

from portbench import stats


def read(r):
    lat = stats.window_latencies_ms(r.window_records)
    return stats.percentile(lat, 95) if lat else None
