"""client_fairness: the statements the least-served client completed in
the window over the clients' mean, in %.  100 is an even share; a lock
that lets one client hold it reads near 0.  Nothing to read with one
client."""


def read(r):
    n = int(r.traffic["clients"])
    if n < 2 or not r.window_records:
        return None
    done = [0] * n
    for rec in r.window_records:
        if rec.error is None:
            done[rec.client] += 1
    return 100.0 * min(done) * n / sum(done) if sum(done) else None
