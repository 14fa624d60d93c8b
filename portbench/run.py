"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Steps: build or load the port's kernel library (its fixed ``_build``
directory in the checkout; ``kernel_build`` in the result line says
whether this run built it, and in how many of ``setup_s``'s seconds);
make the cell's data on the card from the seed; open a session over it;
warm up the cell's own statements; measure for ``--seconds`` with
closed-loop clients; with ``--trace 1`` also trace a short phase on the
card and count host syncs; free the program's state; compare every
statement that came back with the plain reference; print one JSON line.
The numbers compared are printed beside their limits, last on standard
error and last in the result line (``checks``).

Exit codes: 0 a result was printed (``correct`` may be false); 3 no CUDA
card, or fewer than the cell asks for; 4 the program is not in the
checkout; 5 a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CACHE = HERE / ".cache"


def process_start() -> float:
    """time.time() at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def set_environment() -> None:
    """Fixed cache directories inside the checkout, and no JAX pulled in by
    a library.  Done before torch is imported."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class SpanDrain:
    """Reads the port's span ring every ``EVERY`` statements, under the
    session's execution lock, so it never wraps inside the window."""
    EVERY = 100

    def __init__(self, session):
        import threading

        from myscaledb_tpu_torch.runtime import tracing
        self.tracing = tracing
        self.session = session
        self.spans = []
        self.n = 0
        self.lock = threading.Lock()
        tracing.clear_span_log()

    def _drain(self):
        with self.session.exec_lock:
            self.spans += [(s.name, s.start, s.end)
                           for s in self.tracing.span_log_snapshot()]
            self.tracing.clear_span_log()

    def tick(self):
        with self.lock:
            self.n += 1
            due = self.n % self.EVERY == 0
        if due:
            self._drain()

    def finish(self) -> list:
        self._drain()
        return self.spans


def kernel_wrappers():
    """The port's kernel wrappers by name; each counts its launches."""
    from myscaledb_tpu_torch.ops.kernels.binary_scan import \
        binary_segment_mins
    from myscaledb_tpu_torch.ops.kernels.distance import segmin_f32
    from myscaledb_tpu_torch.ops.kernels.distance_q import segmin_sq8
    from myscaledb_tpu_torch.ops.kernels.group_agg import group_aggregate
    from myscaledb_tpu_torch.ops.kernels.merge_count import merge_count
    return {"segmin_sq8": segmin_sq8, "segmin_f32": segmin_f32,
            "group_aggregate": group_aggregate, "merge_count": merge_count,
            "binary_segment_mins": binary_segment_mins}


def count_syncs(fn) -> int:
    """Synchronising operations of ``fn()``, one warning each under
    PyTorch's sync debug mode."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


class Reading:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def per_layer(bench, cell, reading) -> dict:
    from portbench import spec
    out = {}
    for m in spec.cell_metrics(bench, cell, "per_layer"):
        value = spec.metric_reader(m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: int,
             device: str, start: float, cfg: dict = None,
             tr: dict = None, control: bool = False) -> dict:
    """One run of ``cell``; returns the result object.  ``cfg`` and ``tr``
    replace the configuration and the traffic mix (tests run them small
    on the CPU).  ``control``: also judge the reference's lower-precision
    rows in the program's place, under ``control`` (``control.py``)."""
    import torch

    from portbench import load, spec, stats, traffic, window
    from portbench import trace as tracing
    cfg = cfg if cfg is not None else spec.config(bench, cell["config"])
    tr = tr if tr is not None else spec.traffic(cell["traffic"])
    ref = spec.reference(cell["config"])
    on_card = torch.device(device).type == "cuda"

    # 1. the kernel library (built once per checkout)
    built = build_s = None
    if on_card:
        from myscaledb_tpu_torch.ops.kernels import build
        built = not build.library_path().exists()
        t_build = time.perf_counter()
        build.library()
        build_s = time.perf_counter() - t_build
    # 2. data on the device, statements formatted
    n_run, n_warm = traffic.vectors_needed(tr)
    data = spec.generator(cfg).make(cfg, seed, device, n_run + n_warm)
    if on_card:     # the generator's temporaries leave the allocator's cache
        torch.cuda.empty_cache()
    warm, statements = traffic.build(tr, cfg, seed, data["queries"])
    session = load.open_session(cfg, data, device)
    # 3. warm-up: the cell's own statements, over vectors of their own
    for st in warm:
        session.sql_as(None, st.text).to_rows()
    if on_card:
        torch.cuda.synchronize()
    seq = window.Sequence(statements)
    clients = int(tr["clients"])
    setup_s = time.time() - start

    # 4. the window
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    drain = SpanDrain(session) if trace else None
    records, t_open, t_close = window.run_phase(
        session, seq, clients, "window", seconds=seconds,
        after_each=drain.tick if drain else None)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    spans = drain.finish() if drain else []
    everything = list(records)

    # 5. the traced phase and the host-sync count (--trace 1)
    reading = None
    if trace:
        trace_obj, host, last, syncs, sync_recs = None, [], [], None, []
        round_len = sum(int(s["weight"]) for s in tr["statements"])
        if on_card:
            def traced_phase():
                # a lost trace runs the phase again: every try's statements
                # are judged, the last try's are the traced ones
                seq.align(round_len)
                last[:] = window.run_phase(
                    session, seq, clients, "trace",
                    count=int(tr["trace_statements"]))[0]
                everything.extend(last)

            def sync_phase():
                seq.align(round_len)
                sync_recs.extend(window.run_phase(
                    session, seq, 1, "syncs",
                    count=int(tr["sync_statements"]))[0])
            drain2 = SpanDrain(session)
            trace_obj = tracing.traced(traced_phase)
            host = drain2.finish()
            host += [("to_rows", r.wall_sql, r.wall_done) for r in last]
            syncs = count_syncs(sync_phase)
            everything += sync_recs
        reading = Reading(cfg=cfg, traffic=tr, cell=cell, spans=spans,
                          window_records=records,
                          window_statements=len(records), launches=launches,
                          trace=trace_obj, traced_statements=len(last),
                          syncs=syncs, sync_statements=len(sync_recs),
                          host_intervals=host)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # 6. the program's state freed, then the reference
    del session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    failed = [r for r in everything if r.error is not None]
    items = []
    for r in everything:
        if r.error is None:
            st = statements[r.pos % len(statements)]
            items.append(({"name": st.name, **st.params}, r.rows))
    verdict = ref.judge(cfg, data, items)
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in verdict["numbers"].items()}
    correct = not failed and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    control_numbers = None
    if control:
        rows = ref.control_rows(cfg, data, items)
        control_numbers = ref.judge(
            cfg, data, [(p, r) for (p, _), r in zip(items, rows)])["numbers"]

    if trace:
        metrics = per_layer(bench, cell["name"], reading)
    else:
        lat = stats.window_latencies_ms(records)
        came_back = sum(1 for r in records
                        if r.error is None and r.t_done <= t_close)
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        values = stats.latency_metrics(lat, came_back, t_close - t_open)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": units[m["name"]]}
                   for m in spec.cell_metrics(bench, cell["name"],
                                              "end_to_end")}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": len(failed) + verdict["wrong"], "metrics": metrics,
              "device": dev}
    if trace and reading.trace is not None:
        dev["busy_s"] = reading.trace.busy_us / 1e6
        dev["window_s"] = reading.trace.window_us / 1e6
        result["breakdown"] = {
            "device_ops": tracing.top_ops(reading.trace),
            "idle_gaps": tracing.labelled_gaps(reading.trace,
                                               reading.host_intervals)}
    result["by_statement"] = by_statement(records, statements)
    result["per_5s"] = [sum(1 for r in records
                            if t_open + a <= r.t_done < t_open + a + 5)
                        for a in range(0, int(seconds), 5)]
    if built is not None:
        # setup_s holds the build; a run that compiled says so here
        result["kernel_build"] = {"built": built, "seconds": build_s}
    if control_numbers is not None:
        result["control"] = control_numbers
    if failed:
        result["errors"] = sorted({r.error for r in failed})[:3]
    result["checks"] = checks
    return result


def by_statement(records, statements) -> dict:
    """Each statement kind's count, median and 95th percentile (ms) in the
    window: what a mix's percentiles are made of."""
    from portbench import stats
    lat = {}
    for r, ms in zip(records, stats.window_latencies_ms(records)):
        lat.setdefault(statements[r.pos % len(statements)].name,
                       []).append(ms)
    return {k: {"n": len(v), "p50_ms": stats.percentile(v, 50),
                "p95_ms": stats.percentile(v, 95)}
            for k, v in sorted(lat.items())}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    start = process_start()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    set_environment()
    import torch

    from portbench import guard, spec
    if not torch.cuda.is_available():
        print("portbench: no CUDA card is available", file=sys.stderr)
        return 3
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    try:
        import myscaledb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 4
    result = run_cell(bench, cell, args.seed, args.seconds, args.trace,
                      "cuda", start)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"portbench: JAX-side modules were loaded: {bad}",
              file=sys.stderr)
        return 5
    result["device"]["power_limit"] = power_limit()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
