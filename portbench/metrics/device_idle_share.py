"""device_idle_share: 1 minus the union of the device operations'
intervals over the traced window's length, in %.  The window runs from
the end of one marker kernel to the start of the other."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_us / r.trace.window_us)
