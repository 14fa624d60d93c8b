"""lock_wait_ms: the mean duration of the port's ``lock_wait`` span
(``session.py::Session.sql_as``): from the call until the session's
execution lock is held, over the window's statements.  Where several
clients share one session, this is the time a statement queues behind
the others."""


def read(r):
    d = [b - a for name, a, b in r.spans if name == "lock_wait"]
    return 1e3 * sum(d) / len(d) if d else None
