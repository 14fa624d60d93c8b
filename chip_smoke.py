"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Usage:  python3 chip_smoke.py [--seed N]

The main path is the filtered exact vector top-k through SQL (BASELINE
config 1): ``connect()`` -> ``Session.create_table`` -> ``Session.sql`` of

    SELECT id, distance(emb, [q...]) AS d FROM t WHERE price < 50
    ORDER BY d LIMIT 10

over n = 1,000,000 rows of 128-dim f32 embeddings and a uniform Int32 price
column.  Phases, one JSON line each; any failure raises and the script
exits non-zero without printing a result:

  device   the card's name and power limit
  build    nvcc builds the kernels of myscaledb_tpu_torch/csrc for sm_90a
  kernels  each kernel against its plain PyTorch version at config-1
           shapes, and its time beside its bound, the plain version's time
           and a library yardstick
  sql_sq8  twenty certified queries after the sidecar build and a
           warm-up query: the int8 kernel runs, the f32 one does not,
           and the rows match a direct-formula oracle on the card; a
           profiler pass over five more shows where a query's time goes
  sql_f32  identical rows, where the certificate must fail: the f32 kernel
           runs too (L2, Cosine and IP statements)

Kernel times are medians of CUDA-event timings: ``ms`` is one call of the
wrapper (for segmin_sq8 that includes its PyTorch query quantization),
``kernel_ms`` the bare launch, ``plain_ms`` the plain PyTorch version and
``library_ms`` the yardstick call (torch.matmul in f32 for segmin_f32,
torch._int_mm for segmin_sq8 where it takes the shape).  ``bound_ms`` is
the larger of the bytes over 3.35 TB/s and the operations over the H100's
peak for their type.

The launch counters are zeroed just before each SQL path's run (the twenty
certified queries; the three uncertifiable statements) and read just after
it; each kernel must have launched in the run of its path, and the summary
reports those counts.  Launches made to compare a kernel with its plain
version and the profiler pass count nowhere.  The last lines are the
kernels summary, the nvidia-smi name/power line, and
{"ok": true, "device": {...}}.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12            # f32 outside the tensor cores
INT8_OPS = 1979e12           # int8 tensor cores

N, D, K = 1_000_000, 128, 10
METRICS = ("L2", "Cosine", "IP")
# K1: the int dot is exact, so the bounds differ from the plain version only
# by sqrt rounding (the kernel uses no FMA contraction in the bound).
SQ8_RTOL, SQ8_ATOL = 1e-5, 1e-5
# K2: the f32 dot sums in another order than cuBLAS; under L2's
# cancellation (|x|^2 - 2 x.q + |q|^2 with terms ~256) that moves the score
# by a few f32 ulps of 256, i.e. ~1e-4 absolute.
F32_RTOL, F32_ATOL = 1e-5, 1e-3
# SQL rows against the oracle: the reference's own tolerance
# (tests/test_vector.py), since reductions of other shapes sum in other
# orders.
SQL_RTOL = 2e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50) -> float:
    """Median device time of one call: CUDA events around each of ``reps``
    calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if not torch.equal(torch.isposinf(a), torch.isposinf(b)):
        raise AssertionError("kernel and plain version disagree on +inf")
    fin = torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def phase_kernels(gen):
    from myscaledb_tpu_torch.ops.kernels.distance import (
        query_aux, segmin_f32, segmin_f32_plain)
    from myscaledb_tpu_torch.ops.kernels.distance_q import (
        segmin_sq8, segmin_sq8_plain, quantize_queries)
    from myscaledb_tpu_torch.ops.kernels import build
    from myscaledb_tpu_torch.ops.vector import build_sq8

    dev = "cuda"
    report = {"segmin_f32": {"max_abs_err": 0.0, "checks": 0},
              "segmin_sq8": {"max_abs_err": 0.0, "checks": 0}}

    def check(name, got, want, rtol, atol, tag):
        err = max_err(got, want)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{name} {tag}: kernel vs plain max abs "
                                 f"error {err} beyond rtol={rtol} "
                                 f"atol={atol}")
        r = report[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["checks"] += 1

    timings = {}
    for n, d in ((N, D), (N + 3, D), (N + 3, 768)):
        x = torch.randn(n, d, device=dev, generator=gen)
        sqn = (x * x).sum(1)
        mask = (torch.rand(n, device=dev, generator=gen) < 0.5).float()
        for nq in (1, 10, 128):
            q = torch.randn(nq, d, device=dev, generator=gen)
            for metric in METRICS:
                qa = query_aux(q, metric)
                check("segmin_f32",
                      segmin_f32(x, q, sqn, qa, mask, metric),
                      segmin_f32_plain(x, q, sqn, qa, mask, metric),
                      F32_RTOL, F32_ATOL, f"n={n} d={d} nq={nq} {metric}")
            if (n, d) != (N, D):
                continue
            qa = query_aux(q, "L2")
            nseg = -(-n // 128)
            nbytes = n * d * 4 + 2 * n * 4 + nq * (d + 1) * 4 + nq * nseg * 4
            b, by = bound_ms(nbytes, 2.0 * nq * n * d, F32_FLOPS)
            out = torch.empty((nq, nseg), device=dev)

            def raw_f32():   # the bare launch, for the kernel's own time
                build.check(build.library().msdb_segmin_f32(
                    x.data_ptr(), q.data_ptr(), sqn.data_ptr(),
                    qa.data_ptr(), mask.data_ptr(), out.data_ptr(), n, d,
                    nq, 0, torch.cuda.current_stream().cuda_stream),
                    "segmin_f32")
            t = {"ms": time_ms(lambda: segmin_f32(x, q, sqn, qa, mask, "L2")),
                 "kernel_ms": time_ms(raw_f32),
                 "plain_ms": time_ms(lambda: segmin_f32_plain(
                     x, q, sqn, qa, mask, "L2"), reps=10),
                 "library_ms": time_ms(lambda: torch.matmul(q, x.T)),
                 "bound_ms": b, "bound_by": by}
            timings[("segmin_f32", nq)] = t
        if (n, d) == (N, D):
            x8, sides = build_sq8(x)
            n_pad = x8.shape[0]
            mv = (torch.nn.functional.pad(mask, (0, n_pad - n))[None]
                  * sides[3:4]).contiguous()
            for nq in (1, 10, 128):
                q = torch.randn(nq, d, device=dev, generator=gen)
                for metric in METRICS:
                    check("segmin_sq8",
                          segmin_sq8(x8, sides, q, mv, metric),
                          segmin_sq8_plain(x8, sides, q, mv, metric),
                          SQ8_RTOL, SQ8_ATOL, f"nq={nq} {metric}")
                nseg = n_pad // 128
                # x8 row, three side fields, the mask; the query side and
                # the output
                nbytes = n_pad * (d + 16) + nq * (d + 16) + nq * nseg * 4
                b, by = bound_ms(nbytes, 2.0 * nq * n_pad * d, INT8_OPS)
                q8, qside = quantize_queries(q, "L2")
                q8t = q8.T.contiguous()
                out = torch.empty((nq, nseg), device=dev)

                def raw_sq8():
                    build.check(build.library().msdb_segmin_sq8(
                        x8.data_ptr(), sides.data_ptr(), q8.data_ptr(),
                        qside.data_ptr(), mv.data_ptr(), out.data_ptr(),
                        n_pad, d, nq, 0,
                        torch.cuda.current_stream().cuda_stream),
                        "segmin_sq8")
                try:
                    lib = time_ms(lambda: torch._int_mm(x8, q8t))
                    lib_note = "torch._int_mm(x8, q8.T)"
                except RuntimeError as e:
                    lib, lib_note = None, ("torch._int_mm refuses "
                                           f"(n_pad, {d}) x ({d}, {nq}): "
                                           f"{str(e).splitlines()[0][:120]}")
                timings[("segmin_sq8", nq)] = {
                    "ms": time_ms(lambda: segmin_sq8(x8, sides, q, mv, "L2")),
                    "kernel_ms": time_ms(raw_sq8),
                    "plain_ms": time_ms(lambda: segmin_sq8_plain(
                        x8, sides, q, mv, "L2"), reps=10),
                    "library_ms": lib, "library_note": lib_note,
                    "bound_ms": b, "bound_by": by}
            del x8, sides, mv
        del x, sqn, mask
        torch.cuda.empty_cache()
    return report, timings


def vec_sql(v: np.ndarray) -> str:
    return "[" + ",".join(repr(float(a)) for a in v) + "]"


def oracle(x, price, q, k):
    """Direct-formula L2 over every row on the card, WHERE price < 50,
    stable sort by (distance, id)."""
    dist = ((x - q[None, :]) ** 2).sum(1)
    dist = torch.where(price < 50, dist, torch.inf)
    order = torch.sort(dist, stable=True).indices[:k]
    return order.cpu().numpy(), dist[order].cpu().numpy()


def profile_queries(s, stmt, queries):
    """Where a query's time goes: torch.profiler over a few main-path
    queries.  Returns wall time, summed device kernel time (their ratio is
    the device's busy share, with the profiler's own host overhead in the
    wall time) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for qv in queries:
            s.sql(stmt.format(q=vec_sql(qv))).to_rows()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(queries)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows only (kernels, copies): the CPU-side op rows repeat
    # the device time of the kernels they launch
    kernels = [e for e in prof.key_averages() if dev_us(e) > 0 and (
        getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        or e.self_cpu_time_total == 0)]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / len(queries)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms_per_query": wall_ms,
            "device_ms_per_query": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top_kernels_us_per_query": {
                e.key[:60]: dev_us(e) / len(queries) for e in top}}


def phase_sql(seed: int):
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.ops.kernels.distance import segmin_f32
    from myscaledb_tpu_torch.ops.kernels.distance_q import segmin_sq8
    from myscaledb_tpu_torch.sql.executor import _vector_sidecar

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    s = P.connect()
    if s.device.type != "cuda":
        raise AssertionError(f"connect() chose {s.device}, not the card")
    s.create_table("t", data)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = s.tables["t"]["emb"].data
    price = s.tables["t"]["price"].data
    queries = rng.standard_normal((21, D), dtype=np.float32)
    stmt = ("SELECT id, distance(emb, {q}) AS d FROM t WHERE price < 50 "
            "ORDER BY d LIMIT 10")

    # the per-table scan sidecar (squared norms + SQ8) is built on a
    # table's first query; build it here to time it on its own
    t0 = time.perf_counter()
    _vector_sidecar(s, "t", s.tables["t"], "emb")
    torch.cuda.synchronize()
    sidecar_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.sql(stmt.format(q=vec_sql(queries[0])))          # warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    # the main path's own run: counts zeroed just before, read just after
    segmin_sq8.launches = 0
    segmin_f32.launches = 0
    lat = []
    for qi in range(1, 21):
        t0 = time.perf_counter()
        rows = s.sql(stmt.format(q=vec_sql(queries[qi]))).to_rows()
        lat.append((time.perf_counter() - t0) * 1e3)
        want_ids, want_d = oracle(x, price, torch.as_tensor(queries[qi],
                                                            device="cuda"), K)
        got_ids = np.array([r[0] for r in rows])
        got_d = np.array([r[1] for r in rows], dtype=np.float32)
        if not np.array_equal(got_ids, want_ids):
            raise AssertionError(f"query {qi}: ids {got_ids} != oracle "
                                 f"{want_ids}")
        np.testing.assert_allclose(got_d, want_d, rtol=SQL_RTOL)
    sq8_runs, f32_runs = segmin_sq8.launches, segmin_f32.launches
    if sq8_runs < 20 or f32_runs != 0:
        raise AssertionError(f"certified path not taken: segmin_sq8 "
                             f"{sq8_runs}, segmin_f32 {f32_runs} launches")
    counts = {"sql_sq8": {"segmin_sq8": sq8_runs, "segmin_f32": f32_runs}}
    # outside every reported count
    breakdown = profile_queries(s, stmt, queries[1:6])
    emit({"phase": "sql_sq8", "rows": N, "dim": D, "k": K, "queries": 20,
          "statement": stmt.format(q="[...]"),
          "load_s": load_s, "sidecar_build_s": sidecar_s,
          "warmup_query_s": first_s,
          "median_query_ms": float(np.median(lat)),
          "p90_query_ms": float(np.percentile(lat, 90)),
          "rows_scanned_per_s": N / (float(np.median(lat)) / 1e3),
          "segmin_sq8_launches": sq8_runs, "segmin_f32_launches": f32_runs,
          "oracle": "ids equal, distances rtol 2e-5",
          "profile_5_queries": breakdown})

    # identical rows: the int8 certificate cannot separate them, so the
    # f32 segment-min kernel runs (ties resolve to the lowest ids)
    m = 1 << 16
    same = np.tile(rng.standard_normal((1, D), dtype=np.float32), (m, 1))
    s.create_table("same", {"id": np.arange(m, dtype=np.int64),
                            "emb": same})
    qv = vec_sql(rng.standard_normal(D, dtype=np.float32))
    out = {}
    # the uncertifiable path's own run: counts zeroed just before, read
    # just after
    segmin_sq8.launches = 0
    segmin_f32.launches = 0
    for name, sql in (
            ("L2", f"SELECT id, distance(emb, {qv}) AS d FROM same "
                   "ORDER BY d LIMIT 10"),
            ("Cosine", f"SELECT id, cosineDistance(emb, {qv}) AS d FROM same "
                       "ORDER BY d LIMIT 10"),
            ("IP", f"SELECT id, dotProduct(emb, {qv}) AS d FROM same "
                   "ORDER BY d DESC LIMIT 10")):
        before = (segmin_sq8.launches, segmin_f32.launches)
        rows = s.sql(sql).to_rows()
        ids = [r[0] for r in rows]
        if ids != list(range(10)):
            raise AssertionError(f"{name}: ids {ids}, want 0..9")
        if not np.isfinite([r[1] for r in rows]).all():
            raise AssertionError(f"{name}: non-finite distances")
        grew = (segmin_sq8.launches - before[0],
                segmin_f32.launches - before[1])
        if grew[0] < 1 or grew[1] < 1:
            raise AssertionError(f"{name}: launches grew by {grew}; the "
                                 "certificate should fail over to K2")
        out[name] = {"sq8": grew[0], "f32": grew[1]}
    counts["sql_f32"] = {"segmin_sq8": segmin_sq8.launches,
                         "segmin_f32": segmin_f32.launches}
    emit({"phase": "sql_f32", "rows": m, "statements": out,
          "segmin_sq8_launches": counts["sql_f32"]["segmin_sq8"],
          "segmin_f32_launches": counts["sql_f32"]["segmin_f32"],
          "ids": "0..9 for each metric"})
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    import myscaledb_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from myscaledb_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(build.library_path().name),
          "ptxas": [ln.strip() for ln in build.BUILD_LOG.splitlines()
                    if "registers" in ln or "spill" in ln]})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report, timings = phase_kernels(gen)
    emit({"phase": "kernels", "rows": N, "dim": D,
          "tolerance": {"segmin_sq8": [SQ8_RTOL, SQ8_ATOL],
                        "segmin_f32": [F32_RTOL, F32_ATOL]},
          "checks": report,
          "timing_L2_50pct_mask": {f"{k}/nq={nq}": v
                                   for (k, nq), v in timings.items()},
          "kernels": ["segmin_sq8", "segmin_f32"]})

    counts = phase_sql(args.seed)

    summary = []
    # each kernel's launches come from the run of the path that takes it:
    # K1 from the certified main path (sql_sq8), K2 from the path where the
    # certificate fails (sql_f32); both runs' counts are printed beside
    for name, path, src, replaces in (
            ("segmin_sq8", "sql_sq8", "myscaledb_tpu_torch/csrc/segmin_sq8.cu",
             "myscaledb_tpu/ops/pallas/distance_q.py:103"),
            ("segmin_f32", "sql_f32", "myscaledb_tpu_torch/csrc/segmin_f32.cu",
             "myscaledb_tpu/ops/pallas/distance.py:77")):
        if counts[path][name] < 1:
            raise AssertionError(f"{name} never launched on path {path}")
        t = timings[(name, 1)]          # the SQL path scans one query
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "path": path,
                        "launches": counts[path][name],
                        "launches_by_path": {p: c[name]
                                             for p, c in counts.items()},
                        "max_abs_err": report[name]["max_abs_err"],
                        "ms": t["ms"], "kernel_ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
