"""sync_wait_ms: the window's ``sync`` spans summed, per statement (per
``query`` span): the host blocked on the card at a read of a device
value, or at a copy to it, in the driver, the executor and ``ops/``.
Every ``sync`` span runs under the session's execution lock, so the sum
holds no two clients' waits at once."""


def read(r):
    n = sum(1 for name, _, _ in r.spans if name == "query")
    d = [b - a for name, a, b in r.spans if name == "sync"]
    return 1e3 * sum(d) / n if d and n else None
