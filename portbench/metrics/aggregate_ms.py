"""aggregate_ms: the window's ``aggregate`` spans (``sql/executor.py``:
grouping, the aggregates' states and their results, with the host syncs
inside) summed, per statement (per ``query`` span)."""


def read(r):
    n = sum(1 for name, _, _ in r.spans if name == "query")
    d = [b - a for name, a, b in r.spans if name == "aggregate"]
    return 1e3 * sum(d) / n if d and n else None
