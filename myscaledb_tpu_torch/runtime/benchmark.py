"""Query load benchmark: the port of myscaledb_tpu/runtime/benchmark.py —
QPS and latency percentiles for a query stream.

Reference analog: clickhouse-benchmark (programs/benchmark/Benchmark.cpp) —
reads queries, fires them at a server (or an in-process session), reports
QPS, rows/s and latency p50/p90/p99/p99.9.

Usage:
    python -m myscaledb_tpu_torch benchmark -q "SELECT 1" -d 5
    python -m myscaledb_tpu_torch benchmark --url http://host:8123 \\
        -q "SELECT count() FROM t" -c 4 -d 10

In-process runs take the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def percentile(sorted_vals: list, p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(p * len(sorted_vals)))
    return sorted_vals[i]


class Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: list[float] = []
        self.rows = 0
        self.errors = 0

    def add(self, dt: float, rows: int, error: bool = False):
        with self.lock:
            if error:
                self.errors += 1
            else:
                self.latencies.append(dt)
                self.rows += rows


def run_local(queries: list[str], duration: float, session,
              tables: dict | None = None) -> dict:
    """In-process load loop (clickhouse-local style) on ``session``."""
    if tables:
        for name, data in tables.items():
            session.create_table(name, data)
    stats = Stats()
    t_end = time.perf_counter() + duration
    i = 0
    while time.perf_counter() < t_end:
        q = queries[i % len(queries)]
        i += 1
        t0 = time.perf_counter()
        try:
            r = session.sql(q)
            stats.add(time.perf_counter() - t0, r.n_rows)
        except Exception:                                 # noqa: BLE001
            stats.add(0.0, 0, error=True)
    return summarize(stats, duration)


def run_http(queries: list[str], duration: float, url: str,
             concurrency: int = 1, user: str | None = None,
             password: str | None = None) -> dict:
    import urllib.request
    stats = Stats()
    t_end = time.perf_counter() + duration
    counter = {"i": 0}
    lock = threading.Lock()

    def worker():
        while time.perf_counter() < t_end:
            with lock:
                q = queries[counter["i"] % len(queries)]
                counter["i"] += 1
            req = urllib.request.Request(url, data=q.encode())
            if user:
                req.add_header("X-ClickHouse-User", user)
            if password:
                req.add_header("X-ClickHouse-Key", password)
            t0 = time.perf_counter()
            try:
                body = urllib.request.urlopen(req, timeout=60).read()
                stats.add(time.perf_counter() - t0, body.count(b"\n"))
            except Exception:                             # noqa: BLE001
                stats.add(0.0, 0, error=True)

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return summarize(stats, duration)


def summarize(stats: Stats, duration: float) -> dict:
    lat = sorted(stats.latencies)
    n = len(lat)
    return {
        "queries": n,
        "errors": stats.errors,
        "qps": n / duration if duration else 0.0,
        "rows_per_s": stats.rows / duration if duration else 0.0,
        "latency_ms": {
            "p50": percentile(lat, 0.50) * 1e3,
            "p90": percentile(lat, 0.90) * 1e3,
            "p99": percentile(lat, 0.99) * 1e3,
            "p999": percentile(lat, 0.999) * 1e3,
            "mean": (sum(lat) / n * 1e3) if n else 0.0,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-q", "--query", action="append", required=False,
                    help="query to run (repeatable; round-robin)")
    ap.add_argument("--url", default=None,
                    help="HTTP endpoint (default: in-process session)")
    ap.add_argument("-c", "--concurrency", type=int, default=1)
    ap.add_argument("-d", "--duration", type=float, default=5.0)
    ap.add_argument("--user", default=None)
    ap.add_argument("--password", default=None)
    ap.add_argument("--data-dir", default=None,
                    help="in-process mode: open stored tables from this dir")
    ap.add_argument("--device", default=None,
                    help="in-process mode: the session's device (default: "
                         "the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    queries = args.query or [ln.strip() for ln in sys.stdin if ln.strip()]
    if not queries:
        ap.error("no queries given (use -q or pipe queries on stdin)")
    if args.url:
        out = run_http(queries, args.duration, args.url, args.concurrency,
                       args.user, args.password)
    else:
        from myscaledb_tpu_torch.runtime.client import local_session
        out = run_local(queries, args.duration,
                        local_session(args.device, args.data_dir))
    print(json.dumps(out, indent=2))
    return 0
