"""executor_host_ms: the host's own work in the driver and the executor,
per statement: the window's ``query`` spans (``sql/driver.py``) less the
``parse`` and ``sync`` spans inside them, over the number of ``query``
spans.  What is left is Python on the host: planning, expression
evaluation, launching the card's work and building the result."""


def read(r):
    total = {"query": 0.0, "parse": 0.0, "sync": 0.0}
    n = 0
    for name, a, b in r.spans:
        if name in total:
            total[name] += b - a
            n += name == "query"
    if not n:
        return None
    return 1e3 * (total["query"] - total["parse"] - total["sync"]) / n
