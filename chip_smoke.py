"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

Usage:  python3 chip_smoke.py [--seed N]

Two main paths, each through the entry points a user calls (``connect()``
-> ``Session.create_table`` -> ``Session.sql``):

  BASELINE config 1, the filtered exact vector top-k, over n = 1,000,000
  rows of 128-dim f32 embeddings and a uniform Int32 price column:

    SELECT id, distance(emb, [q...]) AS d FROM t WHERE price < 50
    ORDER BY d LIMIT 10

  BASELINE config 2, filtered GROUP BY, over n = 100,000,000 rows of
  g Int32 uniform in [0, 256) and v Int32 uniform in [-1000, 1000):

    SELECT g, sum(v), count(), avg(v) FROM t WHERE v > -500 GROUP BY g
    ORDER BY g

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

  device      the card's name and power limit
  build       nvcc builds the kernels of myscaledb_tpu_torch/csrc for sm_90a
  kernels     each kernel against its plain PyTorch version at its path's
              shapes, and its time beside its bound, the plain version's
              time and a library yardstick
  sql_sq8     twenty certified queries after the sidecar build and a
              warm-up query: the int8 kernel runs, the f32 one does not,
              and the rows match a direct-formula oracle on the card; a
              profiler pass over five more shows where a query's time goes
  sql_f32     identical rows, where the certificate must fail: the f32 kernel
              runs too (L2, Cosine and IP statements)
  sql_groupby config 2's statement ten times after a warm-up query, each
              result equal to an int64 bincount/index_add_ oracle on the
              card, the group-aggregate kernel launched in every query; a
              profiler pass over three more and a count of the host
              synchronisations of one; then, on a 10M-row table, one
              statement per other aggregation branch (float sums, 4096
              groups, sumIf, min/max/any, ROLLUP, DISTINCT), each checked
              against its own oracle

Kernel times are medians of CUDA-event timings: ``ms`` is one call of the
wrapper (for segmin_sq8 that includes its PyTorch query quantization),
``kernel_ms`` the bare launch, ``plain_ms`` the plain PyTorch version and
``library_ms`` the yardstick call (torch.matmul in f32 for segmin_f32,
torch._int_mm for segmin_sq8 with the query block zero-padded to a
multiple of 8 columns, one index_add_ into G + 1 int64 slots for
group_aggregate).  ``bound_ms`` is the larger of the bytes over 3.35 TB/s
and the operations over the H100's peak for their type.

The launch counters are zeroed just before each SQL path's run (the twenty
certified queries; the three uncertifiable statements; the ten config-2
statements) and read just after it; each kernel must have launched in the
run of its path, and the summary reports those counts.  Launches made to
compare a kernel with its plain version, the profiler passes and the
10M-row branch statements count nowhere.  The last lines are the kernels
summary, the nvidia-smi name/power line, and {"ok": true, "device":
{...}}.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
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
# BASELINE config 2 (bench.py:162-216): rows, groups, the statement
N2, G2 = 100_000_000, 256
N2_BRANCHES = 10_000_000
GROUPBY_SQL = ("SELECT g, sum(v), count(), avg(v) FROM t WHERE v > -500 "
               "GROUP BY g ORDER BY g")
# K3: counts and int sums are exact; f32 sums are taken in another order
# than the plain version's (f64, rounded once), a few f32 ulps of the
# partial sums apart.
K3_RTOL, K3_ATOL = 1e-5, 1e-3


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


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel: its (mangled) name, then ptxas's
    registers/shared memory and spill lines."""
    out = []
    for ln in log.splitlines():
        ln = ln.strip()
        if "Function properties for" in ln:
            out.append(ln.split("Function properties for", 1)[1].strip())
        elif out and ("registers" in ln or "spill" in ln):
            out[-1] += " | " + ln.replace("ptxas info    : ", "")
    return out


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
                # torch._int_mm takes widths that are multiples of 8: the
                # same product with the query block zero-padded to 8 / 16
                wide = -(-nq // 8) * 8
                q8t_pad = torch.nn.functional.pad(q8t, (0, wide - nq))
                lib = time_ms(lambda: torch._int_mm(x8, q8t_pad))
                lib_note = (f"torch._int_mm(x8, q8.T) with q8 zero-padded "
                            f"to {wide} columns" if wide != nq
                            else "torch._int_mm(x8, q8.T)")
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
    report["group_aggregate"], timings[("group_aggregate", 1)] = \
        k3_kernel(gen)
    return report, timings


def k3_kernel(gen):
    """K3 against group_aggregate_plain on the card: n in {100M,
    1,000,003}, G in {1, 17, 256}, three argument sets, a 50% and an
    all-false mask, int extremes; float sums also bit-identical between two
    kernel calls.  Then the times at config-2 shapes."""
    from myscaledb_tpu_torch.ops.kernels import build
    from myscaledb_tpu_torch.ops.kernels.group_agg import (
        group_aggregate, group_aggregate_plain, grid)

    dev = "cuda"
    rep = {"max_abs_err": 0.0, "checks": 0, "bit_identical_float_checks": 0}
    for n in (N2, 1_000_003):
        v = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device=dev,
                          generator=gen, dtype=torch.int32)
        v[:3] = torch.tensor([2 ** 31 - 1, -(2 ** 31 - 1), -2 ** 31],
                             dtype=torch.int32)
        v[n // 2:n // 2 + 1000] = 2 ** 31 - 1          # a run of the extreme
        f = torch.randn(n, device=dev, generator=gen)
        half = torch.rand(n, device=dev, generator=gen) < 0.5
        for G in (1, 17, 256):
            gid = torch.randint(0, G, (n,), device=dev, generator=gen,
                                dtype=torch.int32)
            for mask_name, mask in (("50%", half),
                                    ("none", torch.zeros_like(half))):
                for kinds, args in ((("int", "count"), (v, None)),
                                    (("float",), (f,)),
                                    (("int", "float", "count", "int"),
                                     (v, f, None, v))):
                    tag = f"n={n} G={G} mask={mask_name} kinds={kinds}"
                    got = group_aggregate(gid, mask, args, kinds, G)
                    again = group_aggregate(gid, mask, args, kinds, G)
                    want = group_aggregate_plain(gid, mask, args, kinds, G)
                    torch.cuda.synchronize()
                    if not torch.equal(got[1], want[1]):
                        raise AssertionError(f"group_aggregate {tag}: "
                                             "counts differ")
                    for k, a, a2, b in zip(kinds, got[0], again[0], want[0]):
                        if k != "float":
                            if not torch.equal(a, b):
                                raise AssertionError(
                                    f"group_aggregate {tag}: {k} sums "
                                    "differ from the plain version")
                            continue
                        err = float((a - b).abs().max())
                        if not torch.allclose(a, b, rtol=K3_RTOL,
                                              atol=K3_ATOL):
                            raise AssertionError(
                                f"group_aggregate {tag}: float max abs "
                                f"error {err} beyond rtol={K3_RTOL} "
                                f"atol={K3_ATOL}")
                        if not torch.equal(a, a2):
                            raise AssertionError(
                                f"group_aggregate {tag}: float sums differ "
                                "between two kernel calls")
                        rep["max_abs_err"] = max(rep["max_abs_err"], err)
                        rep["bit_identical_float_checks"] += 1
                    rep["checks"] += 1
            del gid
        del v, f, half
        torch.cuda.empty_cache()

    # times at config-2 shapes: sum(v), count(), avg(v) (sum and avg share
    # one argument after the dedupe), WHERE v > -500
    n, G = N2, G2
    gid = torch.randint(0, G, (n,), device=dev, generator=gen,
                        dtype=torch.int32)
    v = torch.randint(-1000, 1000, (n,), device=dev, generator=gen,
                      dtype=torch.int32)
    mask = v > -500
    args, kinds = (v, None, v), ("int", "count", "int")
    nblocks, rows = grid(n)
    part_i = torch.empty((nblocks, 2, G), dtype=torch.int64, device=dev)
    part_f = torch.empty((nblocks, 1, G), dtype=torch.float32, device=dev)
    out_i = torch.empty((2, G), dtype=torch.int64, device=dev)
    out_f = torch.empty((1, G), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * 8)(v.data_ptr())

    def raw_k3():   # the bare launch (both kernels of the entry point)
        build.check(build.library().msdb_group_agg(
            gid.data_ptr(), mask.data_ptr(), ptrs, 1, 0, n, G, nblocks, rows,
            part_i.data_ptr(), part_f.data_ptr(), out_i.data_ptr(),
            out_f.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "group_aggregate")

    tgt = torch.where(mask, gid.long(), G)
    v64 = v.long()
    # gid + mask + v read once; the outputs (3 x G int64) written once
    nbytes = n * (4 + 1 + 4) + 3 * G * 8
    b, by = bound_ms(nbytes, 2.0 * n, F32_FLOPS)
    t = {"ms": time_ms(lambda: group_aggregate(gid, mask, args, kinds, G)),
         "kernel_ms": time_ms(raw_k3),
         "plain_ms": time_ms(lambda: group_aggregate_plain(
             gid, mask, args, kinds, G), reps=5),
         "library_ms": time_ms(lambda: torch.zeros(
             G + 1, dtype=torch.int64, device=dev).index_add_(0, tgt, v64),
             reps=5),
         "library_note": "torch.zeros(G + 1, int64).index_add_(0, tgt, v64)"
                         ", mask folded into tgt",
         "bound_ms": b, "bound_by": by}
    got = out_i.clone()
    want = group_aggregate_plain(gid, mask, (v, None), ("int", "count"), G)
    if not (torch.equal(got[0], want[1]) and torch.equal(got[1], want[0][0])):
        raise AssertionError("group_aggregate bare launch differs from the "
                             "plain version")
    del gid, v, mask, tgt, v64, part_i, part_f
    torch.cuda.empty_cache()
    return rep, t


def vec_sql(v: np.ndarray) -> str:
    return "[" + ",".join(repr(float(a)) for a in v) + "]"


def oracle(x, price, q, k):
    """Direct-formula L2 over every row on the card, WHERE price < 50,
    stable sort by (distance, id)."""
    dist = ((x - q[None, :]) ** 2).sum(1)
    dist = torch.where(price < 50, dist, torch.inf)
    order = torch.sort(dist, stable=True).indices[:k]
    return order.cpu().numpy(), dist[order].cpu().numpy()


def profile_statements(s, statements):
    """Where a query's time goes: torch.profiler over a few main-path
    statements.  Returns wall time, summed device kernel time (their ratio
    is the device's busy share, with the profiler's own host overhead in
    the wall time) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for stmt in statements:
            s.sql(stmt).to_rows()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(statements)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows only (kernels, copies): the CPU-side op rows repeat
    # the device time of the kernels they launch
    kernels = [e for e in prof.key_averages() if dev_us(e) > 0 and (
        getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        or e.self_cpu_time_total == 0)]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / len(statements)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms_per_query": wall_ms,
            "device_ms_per_query": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top_kernels_us_per_query": {
                e.key[:60]: dev_us(e) / len(statements) for e in top}}


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
    breakdown = profile_statements(
        s, [stmt.format(q=vec_sql(qv)) for qv in queries[1:6]])
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


def groupby_oracle(g, v, mask, G):
    """Per-group count and int64 sum on the card by bincount/index_add_."""
    gs = g[mask].long()
    cnt = torch.bincount(gs, minlength=G)
    sums = torch.zeros(G, dtype=torch.int64, device=g.device).index_add_(
        0, gs, v[mask].long())
    return cnt, sums


def check_groupby_rows(rows, cnt, sums, tag):
    """Rows (g, sum, count, avg) against the oracle: every non-empty group
    once, in key order; counts and sums equal; avg equal to sum / count
    in f64."""
    present = torch.nonzero(cnt > 0).flatten().tolist()
    if [r[0] for r in rows] != present:
        raise AssertionError(f"{tag}: group keys differ from the oracle")
    c = cnt.cpu().numpy()
    s = sums.cpu().numpy()
    for gk, sm, ct, av in rows:
        if sm != s[gk] or ct != c[gk]:
            raise AssertionError(f"{tag}: group {gk}: sum/count {sm}/{ct}, "
                                 f"oracle {s[gk]}/{c[gk]}")
        if av != float(np.float64(s[gk]) / np.float64(c[gk])):
            raise AssertionError(f"{tag}: group {gk}: avg {av} != "
                                 "sum / count in f64")


def count_host_syncs(fn):
    """Synchronisations of one call, as PyTorch's sync debug mode reports
    them (one warning per synchronising op).  Returns the count and the
    count per calling source line."""
    import collections
    import os
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(sites.values()), dict(sites)


def phase_groupby(seed: int):
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.ops.kernels.group_agg import group_aggregate

    rng = np.random.default_rng(seed + 2)
    t0 = time.perf_counter()
    s = P.connect()
    s.create_table("t", {"g": rng.integers(0, G2, N2, dtype=np.int32),
                         "v": rng.integers(-1000, 1000, N2, dtype=np.int32)})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    g = s.tables["t"]["g"].data
    v = s.tables["t"]["v"].data
    cnt, sums = groupby_oracle(g, v, v > -500, G2)
    t0 = time.perf_counter()
    check_groupby_rows(s.sql(GROUPBY_SQL).to_rows(), cnt, sums, "warm-up")
    first_s = time.perf_counter() - t0

    # the main path's own run: counts zeroed just before, read just after
    group_aggregate.launches = 0
    lat, per_query = [], []
    for qi in range(10):
        before = group_aggregate.launches
        t0 = time.perf_counter()
        rows = s.sql(GROUPBY_SQL).to_rows()
        lat.append((time.perf_counter() - t0) * 1e3)
        per_query.append(group_aggregate.launches - before)
        check_groupby_rows(rows, cnt, sums, f"query {qi}")
    launches = group_aggregate.launches
    if min(per_query) < 1:
        raise AssertionError(f"group_aggregate launches per query "
                             f"{per_query}: the path skipped K3")
    # outside every reported count
    breakdown = profile_statements(s, [GROUPBY_SQL] * 3)
    syncs, sync_sites = count_host_syncs(
        lambda: s.sql(GROUPBY_SQL).to_rows())
    peak0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s.sql(GROUPBY_SQL).to_rows()
    peak_query = torch.cuda.max_memory_allocated()
    emit({"phase": "sql_groupby", "rows": N2, "groups": G2,
          "statement": GROUPBY_SQL, "queries": 10, "load_s": load_s,
          "warmup_query_s": first_s,
          "median_query_ms": float(np.median(lat)),
          "p90_query_ms": float(np.percentile(lat, 90)),
          "query_ms": lat,
          "rows_aggregated_per_s": N2 / (float(np.median(lat)) / 1e3),
          "group_aggregate_launches": launches,
          "launches_per_query": per_query,
          "host_syncs_per_query": syncs,
          "host_sync_sites": sync_sites,
          "peak_device_bytes_before_query": peak0,
          "peak_device_bytes_in_query": peak_query,
          "oracle": "counts and int64 sums equal (bincount/index_add_ on "
                    "the card), avg equal to sum/count in f64",
          "profile_3_queries": breakdown})
    del g, v, cnt, sums
    s.tables.clear()
    torch.cuda.empty_cache()
    branches = groupby_branches(s, rng)
    emit({"phase": "sql_groupby_branches", "rows": N2_BRANCHES,
          "max_memory_bytes_per_query": s.settings.max_memory_bytes_per_query,
          "statements": branches})
    return {"group_aggregate": launches}


def groupby_branches(s, rng):
    """One statement per other aggregation branch over a 10M-row table,
    each checked against an oracle on the card."""
    from myscaledb_tpu_torch.ops.kernels.group_agg import group_aggregate
    n = N2_BRANCHES
    # DISTINCT groups all 10M rows with a sort, which the default 512 MiB
    # per-query budget refuses (in the JAX package too)
    s.settings.max_memory_bytes_per_query = 4 << 30
    s.create_table("b", {"g": rng.integers(0, G2, n, dtype=np.int32),
                         "h": rng.integers(0, 4096, n, dtype=np.int32),
                         "v": rng.integers(-1000, 1000, n, dtype=np.int32),
                         "f": rng.standard_normal(n, dtype=np.float32)})
    tb = s.tables["b"]
    g, h, v, f = (tb[c].data for c in ("g", "h", "v", "f"))
    every = torch.ones(n, dtype=torch.bool, device=g.device)
    out = {}

    def run(name, sql):
        before = group_aggregate.launches
        t0 = time.perf_counter()
        rows = s.sql(sql).to_rows()
        out[name] = {"statement": sql,
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "group_aggregate_launches":
                         group_aggregate.launches - before,
                     "rows": len(rows)}
        return rows

    # K3's float path
    rows = run("sum_float32", "SELECT g, sum(f), count() FROM b GROUP BY g "
               "ORDER BY g")
    fs = torch.zeros(G2, dtype=torch.float64, device=g.device).index_add_(
        0, g.long(), f.double()).cpu().numpy()
    got = np.array([r[1] for r in rows], dtype=np.float64)
    err = float(np.abs(got - fs).max())
    if not np.allclose(got, fs, rtol=K3_RTOL, atol=K3_ATOL):
        raise AssertionError(f"sum(f): max abs error {err} against the f64 "
                             "oracle")
    out["sum_float32"]["max_abs_err_vs_f64"] = err
    # 4096 groups: the matmul path
    rows = run("groups_4096", "SELECT h, count(), sum(v) FROM b GROUP BY h "
               "ORDER BY h")
    cnt, sums = groupby_oracle(h, v, every, 4096)
    if [(r[0], r[1], r[2]) for r in rows] != [
            (k, int(cnt[k]), int(sums[k])) for k in range(4096)
            if int(cnt[k])]:
        raise AssertionError("4096 groups: rows differ from the oracle")
    # own validity: the matmul path
    rows = run("sumif", "SELECT g, sumIf(v, g < 100), count() FROM b "
               "GROUP BY g ORDER BY g")
    cnt, sums = groupby_oracle(g, v, every, G2)
    want = [(k, int(sums[k]) if k < 100 else 0, int(cnt[k]))
            for k in range(G2) if int(cnt[k])]
    if [tuple(r) for r in rows] != want:
        raise AssertionError("sumIf: rows differ from the oracle")
    # scatter path: min / max / any (the value of the lowest row id)
    rows = run("min_max_any", "SELECT g, min(v), max(v), any(v) FROM b "
               "GROUP BY g ORDER BY g")
    gl = g.long()
    lo = torch.full((G2,), 2 ** 31 - 1, dtype=torch.int32,
                    device=g.device).scatter_reduce_(0, gl, v, "amin")
    hi = torch.full((G2,), -2 ** 31, dtype=torch.int32,
                    device=g.device).scatter_reduce_(0, gl, v, "amax")
    first = torch.full((G2,), n, dtype=torch.int64,
                       device=g.device).scatter_reduce_(
        0, gl, torch.arange(n, device=g.device), "amin")
    want = [(k, int(lo[k]), int(hi[k]), int(v[first[k]]))
            for k in range(G2) if int(first[k]) < n]
    if [tuple(r) for r in rows] != want:
        raise AssertionError("min/max/any: rows differ from the oracle")
    # ROLLUP: the groups, then the grand total with the key defaulted
    rows = run("rollup", "SELECT g, sum(v), count() FROM b WHERE g < 8 "
               "GROUP BY g WITH ROLLUP")
    sel = g < 8
    cnt, sums = groupby_oracle(g, v, sel, 8)
    want = [(k, int(sums[k]), int(cnt[k])) for k in range(8)]
    want.insert(1, (0, int(sums.sum()), int(cnt.sum())))
    if [tuple(r) for r in rows] != want:
        raise AssertionError(f"ROLLUP: rows {rows[:3]}... differ from the "
                             f"oracle {want[:3]}...")
    # DISTINCT
    rows = run("distinct", "SELECT DISTINCT g FROM b")
    if sorted(r[0] for r in rows) != torch.unique(g).tolist():
        raise AssertionError("DISTINCT: keys differ from torch.unique")
    s.tables.clear()
    torch.cuda.empty_cache()
    return out


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
          "ptxas": ptxas_summary(build.BUILD_LOG)})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report, timings = phase_kernels(gen)
    emit({"phase": "kernels", "rows": N, "dim": D,
          "tolerance": {"segmin_sq8": [SQ8_RTOL, SQ8_ATOL],
                        "segmin_f32": [F32_RTOL, F32_ATOL],
                        "group_aggregate": [K3_RTOL, K3_ATOL]},
          "checks": report,
          "timing_L2_50pct_mask": {f"{k}/nq={nq}": v
                                   for (k, nq), v in timings.items()
                                   if k != "group_aggregate"},
          "timing_group_aggregate_config2": timings[("group_aggregate", 1)],
          "kernels": ["segmin_sq8", "segmin_f32", "group_aggregate"]})

    counts = phase_sql(args.seed)
    counts["sql_groupby"] = phase_groupby(args.seed)

    summary = []
    # each kernel's launches come from the run of the path that takes it:
    # K1 from the certified main path (sql_sq8), K2 from the path where the
    # certificate fails (sql_f32), K3 from config 2's statement
    # (sql_groupby); every run's counts are printed beside
    for name, path, src, replaces in (
            ("segmin_sq8", "sql_sq8", "myscaledb_tpu_torch/csrc/segmin_sq8.cu",
             "myscaledb_tpu/ops/pallas/distance_q.py:103"),
            ("segmin_f32", "sql_f32", "myscaledb_tpu_torch/csrc/segmin_f32.cu",
             "myscaledb_tpu/ops/pallas/distance.py:77"),
            ("group_aggregate", "sql_groupby",
             "myscaledb_tpu_torch/csrc/group_agg.cu",
             "myscaledb_tpu/ops/pallas/group_agg.py:190")):
        if counts[path][name] < 1:
            raise AssertionError(f"{name} never launched on path {path}")
        t = timings[(name, 1)]          # the SQL path scans one query
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "path": path,
                        "launches": counts[path][name],
                        "launches_by_path": {p: c.get(name, 0)
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
