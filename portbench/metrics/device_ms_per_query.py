"""device_ms_per_query: the union of the device operations' intervals in
the traced window, per statement (however many ran at once)."""


def read(r):
    if r.trace is None or not r.traced_statements:
        return None
    return r.trace.busy_us / 1e3 / r.traced_statements
