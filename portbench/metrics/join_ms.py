"""join_ms: the window's ``join`` spans (``sql/executor.py``: from the
join's key evaluation and build, through the probe, to the carried
columns) summed, per statement (per ``query`` span).  None where the
program opens no ``join`` span."""


def read(r):
    n = sum(1 for name, _, _ in r.spans if name == "query")
    d = [b - a for name, a, b in r.spans if name == "join"]
    return 1e3 * sum(d) / n if d and n else None
