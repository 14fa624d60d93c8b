"""client_latency_p50_ms: the median latency of the window's statements,
send to rows on the host, in a cell of several clients on one session.
There a statement waits for the session's execution lock behind the
others, so this is the time a user of a shared session sees.  A failed
statement counts as slower than any."""

from portbench import stats


def read(r):
    lat = stats.window_latencies_ms(r.window_records)
    return stats.percentile(lat, 50) if lat else None
