"""k1_roofline: K1's share of its roofline in the traced phase, in %.

The least time of a launch is the larger of its bytes at the card's HBM
rate and its int8 operations at the card's int8 peak (``roofline.py``),
for one query over the configuration's rows; K1's time is the device time
of its kernels in the trace (the int8 scan and its query-quantizing
prologue).  The card's power limit is printed beside the result."""

from portbench import roofline

NAMES = ("segmin_sq8", "quantize_queries_kernel")


def read(r):
    if r.trace is None:
        return None
    events = [e for e in r.trace.events if any(n in e.name for n in NAMES)]
    launches = sum(1 for e in events if "segmin_sq8" in e.name)
    if not launches:
        return None
    n, d = int(r.cfg["rows"]), int(r.cfg["dim"])
    least = max(roofline.bound_s(roofline.k1_bytes(n, d, 1)),
                2.0 * n * d / roofline.PEAKS["int8_ops"])
    busy = sum(e.end - e.start for e in events) / 1e6
    return 100.0 * launches * least / busy
