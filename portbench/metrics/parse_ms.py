"""parse_ms: the mean duration of the port's own ``parse`` span
(``sql/driver.py``: lexer and parser) over the window's statements.  The
span covers host-only work, so its host clock is the right clock."""


def read(r):
    d = [b - a for name, a, b in r.spans if name == "parse"]
    return 1e3 * sum(d) / len(d) if d else None
