"""to_rows_ms: the mean duration of the port's ``to_rows`` span
(``core/table.py::Table.to_rows``): the result's columns copied to the
host and turned into Python rows, over the window's statements."""


def read(r):
    d = [b - a for name, a, b in r.spans if name == "to_rows"]
    return 1e3 * sum(d) / len(d) if d else None
