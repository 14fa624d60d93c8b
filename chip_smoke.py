"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

Usage:  python3 chip_smoke.py [--seed N]

Fifteen main paths, the SQL ones through the entry points a user calls
(``connect()`` -> ``Session.create_table`` or SQL DDL -> ``Session.sql``,
and the wire servers in front of them):

  BASELINE config 1, the filtered exact vector top-k, over n = 1,000,000
  rows of 128-dim f32 embeddings and a uniform Int32 price column:

    SELECT id, distance(emb, [q...]) AS d FROM t WHERE price < 50
    ORDER BY d LIMIT 10

  BASELINE config 2, filtered GROUP BY, over n = 100,000,000 rows of
  g Int32 uniform in [0, 256) and v Int32 uniform in [-1000, 1000):

    SELECT g, sum(v), count(), avg(v) FROM t WHERE v > -500 GROUP BY g
    ORDER BY g

  BASELINE config 4, the join count probe, as bench.py builds it: 10M build
  keys and 125M zipf-skewed probes spread over 2^31, through
  ``ops.join.build_join_table`` and ``ops.hashtable.ht_count_matches`` (the
  JAX package reaches its count kernel through these alone, no SQL does).

  Joins through SQL, scaled down from config 4 to a 10M-row fact table
  and a 1M-row dim table with config 4's key skew (the executor carries
  row pairs through host numpy, as the JAX package's does):

    SELECT count(), sum(v), sum(c) FROM f INNER JOIN d ON f.k = d.k

  BASELINE config 6, binary vectors through SQL: 16M rows of
  FixedString(32) (256 random bits each) and a tag Int32 in [0, 100):

    SELECT id, distance(bv, unhex('<64 hex>')) AS d FROM tb
    ORDER BY d LIMIT 10

  BASELINE config 1 again, with the table made by the statements a user
  types — CREATE TABLE, ten INSERT ... SELECT batches of 100,000 rows,
  OPTIMIZE, ALTER ... ADD VECTOR INDEX — then distance() and
  batch_distance() statements with nq = 10 (bench.py's config 1) and 128
  query vectors:

    SELECT id, batch_distance(emb, [[q1...], ...]) AS dist FROM tv
    WHERE price < 50 ORDER BY dist.1, dist.2 LIMIT 10 BY dist.1

  and the 23 vector goldens (tests/goldens/vector) on the card.

  BASELINE config 3, ORDER BY ... LIMIT over 100,000,000 rows of id
  UInt32, v Float32 (standard normal) and w Int32 in [0, 1000):

    SELECT id, v FROM t3 ORDER BY v DESC LIMIT 100

  then window functions over 10,000,000 rows in 1000 partitions.

  ClickBench's hits table (github.com/ClickHouse/ClickBench,
  clickhouse/create.sql) in shape, at 100,000,000 rows made on the card,
  under seven statements from its queries.sql and one that holds the uniq
  sketches, an exact quantile and K3 together:

    SELECT toHour(EventTime) AS h, count(), uniq(UserID),
    uniqCombined(UserID), quantile(0.9)(ResolutionWidth) FROM hits
    GROUP BY h ORDER BY h

  An event table shaped like URLCategories Array(UInt16) of ClickHouse's
  hits_v1 example dataset, ev (id UInt32, cats Array(UInt16)), at
  100,000,000 rows (about 400M elements) made on the card, under five
  array statements:

    SELECT c, count() FROM ev ARRAY JOIN cats AS c GROUP BY c
    ORDER BY count() DESC LIMIT 10

  BASELINE config 1 again with a metadata table meta (id UInt32, cat
  UInt16) of 1M rows: query by example, a metadata filter through IN, a
  facet join on a subquery, a CTE, UNION ALL and INTERSECT/EXCEPT:

    SELECT id, distance(emb, (SELECT emb FROM t WHERE id = 4242)) AS d
    FROM t WHERE price < 50 ORDER BY d LIMIT 10

  The MS MARCO passage corpus in shape (BEIR, Thakur et al. 2021), cut
  to 1,000,000 passages made on the card (Zipf words, lognormal lengths
  of mean 56) with 768-dim embeddings and a price Float32, under text
  and hybrid search (20 queries of 2-6 words each):

    SELECT id, HybridSearch('fusion_type=rsf')(emb, body, [q...], 'words')
    AS s FROM p WHERE price < 50 ORDER BY s DESC LIMIT 10

  Storage: ClickHouse's documented hits_v1 table (the Yandex.Metrica
  example dataset's DDL) cut to five columns, 100,000,000 rows made on
  the card and loaded by ten INSERT ... SELECT batches into

    ev (EventDate Date, CounterID UInt32, UserID UInt64, g UInt16, v Int32,
        INDEX uid UserID TYPE bloom_filter(0.025) GRANULARITY 1)
    ENGINE = MergeTree PARTITION BY EventDate ORDER BY (CounterID, EventDate)

  under a day's and a week's GROUP BY, a UserID lookup, DROP PARTITION
  and a TTL copy OPTIMIZEd; config 1 partitioned by a day column; and
  that table written as ten on-disk parts and reopened;

  ClickHouse's documented aggregated materialized view (the
  AggregatingMergeTree page's example) over the same 100M events:

    CREATE MATERIALIZED VIEW ev_counters TO ev_agg AS SELECT CounterID,
    EventDate, sumState(v) AS s, countState(v) AS c, maxState(v) AS m
    FROM ev GROUP BY CounterID, EventDate

  with a daily uniqState(UserID) view, -Merge reads, a view, joinGet,
  dictGet, IN a Set table, ALTER mutations, EXPLAIN and a row policy;

  ClickBench's load and export paths over the hits table of sql_hits:
  10M of its rows out and back in as Native and through each of
  ClickBench's load formats (TSV, CSV, JSONEachRow, RowBinary) and
  Session.import_file, its Q8 over the copies and with SAMPLE 0.1,

    SELECT AdvEngineID, count() FROM hits SAMPLE 0.1 WHERE AdvEngineID
    <> 0 GROUP BY AdvEngineID ORDER BY count() DESC

  backup and restore of 10M rows of hits and of config 1 (a top-k
  after), and a FILE-sourced dictionary beside a join on file();

  the wire servers over config 1 and the 100M-row hits table: HTTP,
  native TCP, MySQL, PostgreSQL and gRPC in threads of this process over
  one session, each answering config 1's statement and ClickBench's Q8;
  two users under row policies at once; benchmark.run_http /
  run_local load; and ``python -m myscaledb_tpu_torch server`` started
  as a user starts it, with the client and benchmark tools against it;

  and the 184 stateless goldens (tests/test_torch_goldens_stateless.py).

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

  device      the card's name and power limit
  build       nvcc builds the kernels of myscaledb_tpu_torch/csrc for sm_90a
  kernels     each kernel against its plain PyTorch version at its path's
              shapes, and its time beside its bound, the plain version's
              time and a library yardstick; for K1 also which branch each
              query count takes, the wgmma branch bit-equal to the __dp4a
              branch at nq = 10 and 128 for every metric (at d = 1152,
              where 128 queries' q8 does not fit in shared memory and the
              __dp4a branch runs), the 128-wide wgmma bit-equal to the
              16-wide one, and the entry point's query quantization
              against quantize_queries
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
  join_count  config 4: the 10M-key join build, then the count probe
              eleven times (the first a warm-up), each count equal to a
              torch.isin oracle on the card; the count kernel must launch
  sql_join    one statement per strictness (INNER ANY, INNER ALL, LEFT,
              SEMI, ANTI), each result equal to a searchsorted oracle on
              the card; an ALL join against a dim table whose keys repeat,
              its (id, c) pairs equal to the searchsorted ranges'; then the
              join feeding count()/sum() ten times after a warm-up, and
              the time K4's directory adds to a join build of the dim keys
  sql_binary  the packed sidecar build and a warm-up query timed apart,
              then config 6's statement ten times, with WHERE tag < 50 and
              under the Jaccard table setting; ids and distances equal to a
              byte-table popcount oracle over every row on the card (ties
              by id); the binary segment-min kernel must launch
  sql_ddl     config 1 through DDL: insert rows/s and system.parts (ten
              parts, one after OPTIMIZE FINAL), the index build, twenty
              distance statements (K1 in each, K2 where the certificate
              failed), ten timed
              batch_distance statements at nq = 10 and at nq = 128 (K1
              once a statement, K2 exactly in the statements whose
              certificate failed, recomputed from the sidecar; a profiler
              pass over three more at each nq), the batch
              statements at nq = 10, 32, 128 on identical rows (K2 must
              launch: its wgmma half at 32 and 128), DELETE of about 1% of
              the rows and the first query after it, DETACH/ATTACH, an
              index build of 2,097,152 rows on the background executor
              with a query right after it, DROP; every statement's rows
              equal the direct-formula oracle over the table's current
              rows
  goldens_vector  the 23 vector goldens through run_golden_text(connect()),
              each byte-identical to its .reference
  sql_topn    config 3: v DESC (bench.py's statement), v ASC, w DESC (heavy
              ties) and ORDER BY id (already ordered: read-in-order), each
              ten times after a warm-up, ids equal to a stable full sort of
              the total-order key on the card; ReadInOrderSorts moves once
              per ORDER BY id statement and never for the others; a
              profiler pass over three v DESC statements; the device time
              of topn_permutation alone (its segment prefilter) beside the
              full sort it replaced and the column's byte bound, with
              topn_sort_rows_per_sec_per_chip as bench.py defines it (rows
              over that device time); then v DESC in a session whose
              max_hbm_bytes_per_column keeps the columns in host RAM, so
              the key streams through the card in stream_chunk_rows
              chunks (StreamingTopN moves once a statement), with the
              resident table's ids
  sql_window  row_number/rank/dense_rank, running sum and avg with peers,
              whole-partition sum and max, lag/lead and ntile over 10M rows,
              each result column against an oracle on the card built from
              stable sorts, searchsorted edges and f64 prefix sums:
              integers equal, avg(f) within rtol 2e-5 or atol 2e-5 x the
              partition's sum |f| over the frame's rows
  sql_hits    each hits statement ten times after a warm-up (median, p90,
              rows/s), then a profiler pass and a count of its host
              synchronisations; rows equal to plain torch on the card
              (torch.unique counts, the LIKE pattern matched over the
              dictionary and looked up by code, minute buckets by integer
              division, the inverted-CDF element of a sort), uniqCombined
              within 5% of the exact count; K3 must launch beside the
              special aggregates
  sql_arrays  the event table's five statements (ARRAY JOIN ... GROUP BY,
              LEFT ARRAY JOIN, has(), arraySum(arrayMap(...)),
              length(arrayFilter(...))), each ten times after a warm-up
              (median, p90), rows equal to plain torch on the card (a
              bincount of the flat values, the row lengths, int64 sums,
              per-row hits through searchsorted row ids); a profiler pass,
              the host synchronisations of one statement and its peak
              device memory; K3 must launch in the ARRAY JOIN ... GROUP BY
  sql_subquery  config 1 with meta: by example (rows equal to the same
              statement with the literal vector), IN (SELECT id FROM meta
              ...), the top 1000 joined to meta and grouped, a CTE over
              the top 100, UNION ALL of two top-10s, INTERSECT and EXCEPT
              of two 1M-row sides; timed and profiled as above, ids equal
              to a direct-formula top-k on the card, facet counts equal,
              INTERSECT/EXCEPT equal to torch.isin over the sides; K1 must
              launch in each of the first five, K3 in the facet join
  sql_text    the passage table: its BM25 index build (host tokenize
              seconds, device build ms, postings bytes) timed apart, then
              TextSearch OR, AND and under WHERE price < 50, HybridSearch
              RSF and RRF under it (30 candidates a side), a non-fused
              score column over 1000 rows and ftsIndex, each over the 20
              queries after a warm-up (median, p90, busy share, host
              syncs, peak memory); BM25 against an f64 oracle from the
              generator's own (passage, word) pairs (scores within rtol
              1e-5, ids equal wherever the gap at a rank exceeds it), the
              vector half against an f64 distance top-30 and the fusion
              against numpy RSF/RRF over the oracle lists; K2 must launch
              once in every HybridSearch statement
  sql_storage (a) the ten batches timed (insert rows/s), the bloom
              index built apart, then the three statements ten times
              after a warm-up (median, p90, busy share, host syncs, peak
              memory, blocks kept of all), groups against bincount on the
              card, K3 in each GROUP BY; DROP PARTITION of the last day
              and OPTIMIZE of the TTL copy, counts checked; (b) 20 pruned
              and 20 unpruned vector statements, ids against a
              direct-formula oracle, K1 once each, build_sq8 once for the
              phase; (c) ten parts written (emb in lz) and read back
              (MB/s, bytes on disk), (b)'s statements again, rows equal
  sql_views   the ten batches into a table with no view (insert rows/s),
              then ev with the two materialized views: the ten batches
              through them timed (the last under the profiler: its
              device time), rows of ev_agg and ev_users, K3 in every
              batch; counter 62's -Merge by day, the top ten counters,
              the daily uniqMerge and finalizeAggregation, each ten times
              after a warm-up (median, p90, busy share, host syncs, peak
              memory), sums (a Float64 sumState too), counts and maxima
              equal to index_add_/bincount/scatter_reduce over the
              source, uniqMerge within
              5% of the exact (day, UserID) pairs; a view's GROUP BY g
              (K3) equal to its inlined statement and to bincount,
              joinGet and dictGet over a day grouped by name, IN a Set
              over 100M rows, a day's float sumState per counter,
              against gathers, torch.isin and sums; ALTER
              UPDATE / ADD COLUMN / MATERIALIZE / DROP COLUMN over 100M
              rows timed and exact, the views' states unchanged after
              them; EXPLAIN PLAN/ESTIMATE and a row policy checked
  sql_formats (a) SELECT * FROM hits LIMIT 10M INTO OUTFILE ... FORMAT
              Native and INSERT INTO hits_n FROM INFILE, (b) the same
              for TSV, CSV, JSONEachRow and RowBinary, with
              Session.import_file of the TSV, each copy torch.equal to
              the source column by column (strings through their
              dictionaries); every file step once under the profiler
              (seconds, rows/s, MB/s, file bytes, device against host
              seconds, host syncs, peak memory); (c) Q8 over hits, the
              Native copy, the TSV copy and with SAMPLE 0.1, ten times
              after a warm-up each (median, p90, busy share, host syncs,
              peak memory), against bincounts on the card (SAMPLE's
              through hash32 of the row ids under the same threshold), K3
              in each; (d) backup and restore of 10M rows of hits and of
              config 1 with a vector index, the restored tables equal, the restored
              top-k's rows equal the ones before the backup, K1 in it;
              (e) a FILE dictionary over the ~7,000 CounterIDs and the
              same lookup through a join on file(), a day's rows grouped
              by name against a bincount gather; the files in a temporary
              directory removed at the end
  sql_server  (a) the five protocol servers on ephemeral ports over one
              session: config 1's statement for ten query vectors (ids
              against the oracle, K1) and Q8 (K3) through each, every
              answer equal to the in-process result (HTTP also as JSON,
              JSONEachRow, Native, RowBinary); (b) two users under
              complementary row policies on hits counting at once over
              HTTP, MySQL and PostgreSQL, 50 rounds each, every count
              exact; (c) run_http at concurrency 1 and 4 over sql_sq8's
              twenty statements, Q8 at 4, run_local over the twenty, 10 s
              each with no error (QPS, p50/p90/p99, a profiled window's
              busy share, host syncs per statement, the served median less
              the in-process one), and the TCP block's bytes and time for
              a String column (its whole dictionary) beside an Int32 one;
              (d) config 1 written as parts, ``python -m
              myscaledb_tpu_torch server --data-dir`` started as a
              subprocess and timed to its first /ping and first answer,
              the client and benchmark tools run against it; a server
              thread's exception fails the phase
  goldens_stateless  every case of tests/test_torch_goldens_stateless.py
              through run_golden_text(connect()), byte-identical

Kernel times are medians of CUDA-event timings, K1 at nq = 1, 8, 9, 10,
16, 32, 64 and 128 and K2 at nq = 1, 10, 32 and 128 (the summary's
``at_other_nq``): ``ms`` is one call of the wrapper (for merge_count,
called with no index, the build of its radix directory; ``ms_with_index``
is merge_count given the directory, as the join build passes it),
``kernel_ms`` the bare launch (for segmin_f32 the query split and the
scan, for segmin_sq8 the query quantization and the scan: one entry point
each), ``plain_ms`` the plain PyTorch version and
``library_ms`` the yardstick call (torch.matmul in f32 for segmin_f32,
torch._int_mm for segmin_sq8 with the query block zero-padded to a
multiple of 8 columns, one index_add_ into G + 1 int64 slots for
group_aggregate, torch.isin and a sum for merge_count, torch.unique over
the stacked (group, key) pairs for distinct_count; none for
binary_segment_mins, since no single PyTorch call computes a popcount
distance).  distinct_count (K6) is timed at mix5's shapes: 100M rows of
the benchmark generator's UserID at G = 1 and grouped by its RegionID
(``timing_distinct_count_mix5``; ``fill_ms`` the table's fill alone).  ``bound_ms`` is the larger of the bytes over 3.35 TB/s and the
operations over the H100's peak for their type (integer operations are
counted against the f32 rate outside the tensor cores; segmin_f32's
products as three TF32 products each, at 495 TFLOP/s).  The kernels
phase line also holds, under ``derived_not_measured``, the time K1's
bound arithmetic (11 f32 operations a row and query) takes at the
non-FMA f32 rate, computed from the shapes beside ``bound_ms``, and under
``timing_segmin_sq8_d1152`` the __dp4a branch at 128 queries of d = 1152
beside the same queries 64 at a time on the wgmma branch.

All six launch counters are zeroed just before each path's run (the
twenty certified queries; the three uncertifiable statements; the ten
config-2 statements; the join build and count probes; the join statements
up to the last timed one; the ten config-6 statements; on the DDL-built
table the twenty distance statements, the ten batch statements at each
nq, and the three identical-rows statements; config 3's statements; the
window statements; each hits, array, subquery, text, storage and views
statement's timed runs; the views' ten batches; each sql_formats
statement's timed runs and the restored top-k; each protocol's run of
sql_server (a), summed) and read just after it;
each kernel must have launched in the run of its path, and the summary
reports every kernel's count on every path.  Launches made to compare a
kernel with its plain version, the profiler passes and the 10M-row
branch statements count nowhere.  Config 3's and the windows' paths
launch no kernel of the port (their JAX counterparts reach no Pallas
kernel either), the hits statements K3 and K6 (its distinct counts), the
array statements only K3, the subquery
statements K1 (K2 where the certificate fails) and K3, the HybridSearch
statements of sql_text K2 (each text statement's timed runs are zeroed
and read the same way); their counts are reported all the same.  The
last lines are the kernels summary, the nvidia-smi name/power line, and
{"ok": true, "device": {...}}.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12            # f32 outside the tensor cores
TF32_FLOPS = 495e12          # TF32 tensor cores
INT8_OPS = 1979e12           # int8 tensor cores


N, D, K = 1_000_000, 128, 10
METRICS = ("L2", "Cosine", "IP")
# K1: the int dot is exact, so the bounds differ from the plain version only
# by sqrt rounding (the kernel uses no FMA contraction in the bound).
SQ8_RTOL, SQ8_ATOL = 1e-5, 1e-5
# K1's query counts: the SQL paths' (1, 10, 32 and 128), the 16-wide
# wgmma's edges (8, 9 and 16), and 64: its time against the (row, query)
# pairs its epilogue evaluates
K1_NQ = (1, 8, 9, 10, 16, 32, 64, 128)
# K1's __dp4a branch runs where 128 queries' q8 (128 d bytes) does not fit
# the wgmma branch's shared memory: past d = 1024
K1_DP4A_D = 1152
K1_BRANCHES = ("dp4a", "wgmma")
# the entry point's query norms are sums in another order than PyTorch's
K1_QSIDE_RTOL = 1e-5
# per (row, query) pair, K1's L2 bound takes one int-to-float conversion
# and 10 f32 multiplies, adds and subtracts, kept apart (no FMA)
K1_EPILOGUE_OPS = 11
# K2: three TF32 products per term (about 2^-21 of each term) summed in
# another order than cuBLAS; under L2's cancellation (|x|^2 - 2 x.q + |q|^2
# with terms ~256) that moves the score by a few f32 ulps of 256, i.e.
# ~1e-4 absolute.
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
# BASELINE config 4 (bench.py:252-316): build keys, zipf-skewed probes,
# and the odd multiplier that spreads ids over [0, 2^31)
N4_BUILD, N4_PROBE = 10_000_000, 125_000_000
SPREAD = 2654435761
# joins through SQL: config 4's skew over a smaller fact and dim table
NJ_FACT, NJ_DIM = 10_000_000, 1_000_000
# BASELINE config 6 (bench.py:388-427): 16M rows x 256 bits
N6, NBYTES6 = 16_000_000, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name; each adds one to its
    ``launches`` where it launches its kernel."""
    from myscaledb_tpu_torch.ops.kernels.binary_scan import \
        binary_segment_mins
    from myscaledb_tpu_torch.ops.kernels.distance import segmin_f32
    from myscaledb_tpu_torch.ops.kernels.distance_q import segmin_sq8
    from myscaledb_tpu_torch.ops.kernels.group_agg import group_aggregate
    from myscaledb_tpu_torch.ops.kernels.merge_count import merge_count
    from myscaledb_tpu_torch.ops.kernels.distinct_count import \
        distinct_count
    return {"segmin_sq8": segmin_sq8, "segmin_f32": segmin_f32,
            "group_aggregate": group_aggregate, "merge_count": merge_count,
            "binary_segment_mins": binary_segment_mins,
            "distinct_count": distinct_count}


def zero_launches() -> None:
    """Every launch counter to 0: called just before a path's run."""
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    """Every launch counter, read just after a path's run."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


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
    tiles_gen = torch.Generator(device=dev).manual_seed(
        gen.initial_seed() + 1)
    # nq = 32 (batch_distance's K2 shape on the sql_ddl path) draws from a
    # generator of its own too
    nq32_gen = torch.Generator(device=dev).manual_seed(
        gen.initial_seed() + 2)
    # the query counts K1 is timed at beyond nq = 1, 10 and 128 draw from a
    # generator of their own too
    k1_gen = torch.Generator(device=dev).manual_seed(gen.initial_seed() + 3)
    report = {"segmin_f32": {"max_abs_err": 0.0, "checks": 0},
              "segmin_sq8": {"max_abs_err": 0.0, "checks": 0,
                             "branch_bit_equal": []}}
    epilogue = {}

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
        for nq in (1, 8, 9, 10, 32, 128):
            # the nq = 8, 9 cases (one and two query tiles of K2) and nq = 32
            # draw from their own generators, so the later kernels' data
            # stays as it was
            q = torch.randn(nq, d, device=dev,
                            generator=nq32_gen if nq == 32 else
                            tiles_gen if nq in (8, 9) else gen)
            for metric in METRICS:
                qa = query_aux(q, metric)
                check("segmin_f32",
                      segmin_f32(x, q, sqn, qa, mask, metric),
                      segmin_f32_plain(x, q, sqn, qa, mask, metric),
                      F32_RTOL, F32_ATOL, f"n={n} d={d} nq={nq} {metric}")
            if (n, d) != (N, D) or nq in (8, 9):
                continue
            qa = query_aux(q, "L2")
            nseg = -(-n // 128)
            nbytes = n * d * 4 + 2 * n * 4 + nq * (d + 1) * 4 + nq * nseg * 4
            # three TF32 products per multiply-add on the tensor cores
            b, by = bound_ms(nbytes, 3 * 2.0 * nq * n * d, TF32_FLOPS)
            out = torch.empty((nq, nseg), device=dev)
            qsplit = torch.empty((2, nq, d), device=dev)

            def raw_f32():   # the bare launch, for the kernel's own time
                build.check(build.library().msdb_segmin_f32(
                    x.data_ptr(), q.data_ptr(), sqn.data_ptr(),
                    qa.data_ptr(), mask.data_ptr(), qsplit.data_ptr(),
                    out.data_ptr(), n, d, nq, 0,
                    torch.cuda.current_stream().cuda_stream), "segmin_f32")
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
            nseg = n_pad // 128
            lib = build.library()
            for nq in K1_NQ:
                # nq = 8, 9, 16, 32 and 64 draw from a generator of their
                # own, so the other kernels' data stays as it was
                q = torch.randn(nq, d, device=dev,
                                generator=gen if nq in (1, 10, 128)
                                else k1_gen)
                for metric in METRICS:
                    check("segmin_sq8",
                          segmin_sq8(x8, sides, q, mv, metric),
                          segmin_sq8_plain(x8, sides, q, mv, metric),
                          SQ8_RTOL, SQ8_ATOL, f"nq={nq} {metric}")
                branch = K1_BRANCHES[lib.msdb_segmin_sq8_branch(nq, d)]
                if nq == 128:
                    # the 128-wide wgmma against the 16-wide one, which
                    # the same queries take eight at a time
                    for metric in METRICS:
                        whole = segmin_sq8(x8, sides, q, mv, metric)
                        parts = torch.cat([
                            segmin_sq8(x8, sides, q[i:i + 8], mv, metric)
                            for i in range(0, nq, 8)])
                        if not torch.equal(whole, parts):
                            raise AssertionError(
                                f"segmin_sq8 nq={nq} {metric}: the 128-wide"
                                " wgmma differs from the 16-wide one")
                        report["segmin_sq8"]["branch_bit_equal"].append(
                            f"d={d} nq=128 wgmma N=128 vs N=16 {metric}")
                # x8 row, three side fields, the mask; the query side and
                # the output
                nbytes = n_pad * (d + 16) + nq * (d + 16) + nq * nseg * 4
                b, by = bound_ms(nbytes, 2.0 * nq * n_pad * d, INT8_OPS)
                q8, qside = quantize_queries(q, "L2")
                scratch = torch.empty(nq * d + nq * 16, dtype=torch.uint8,
                                      device=dev)
                out = torch.empty((nq, nseg), device=dev)

                def raw_sq8():   # the entry point: quantization and scan
                    build.check(lib.msdb_segmin_sq8(
                        x8.data_ptr(), sides.data_ptr(), q.data_ptr(),
                        scratch.data_ptr(), mv.data_ptr(), out.data_ptr(),
                        n_pad, d, nq, 0,
                        torch.cuda.current_stream().cuda_stream),
                        "segmin_sq8")
                raw_sq8()
                # the entry point's quantization: q8 equal, the norms
                # within K1_QSIDE_RTOL
                if not torch.equal(scratch[:nq * d].view(torch.int8)
                                   .view(nq, d), q8):
                    raise AssertionError(f"segmin_sq8 nq={nq}: the "
                                         "prologue's q8 differs")
                got_side = scratch[nq * d:].view(torch.float32).view(nq, 4)
                if not torch.allclose(got_side, qside, rtol=K1_QSIDE_RTOL,
                                      atol=0.0):
                    raise AssertionError(
                        f"segmin_sq8 nq={nq}: the prologue's qside is "
                        f"{float((got_side - qside).abs().max())} away")
                # torch._int_mm takes widths that are multiples of 8: the
                # same product with the query block zero-padded to 8 / 16
                q8t = q8.T.contiguous()
                wide = -(-nq // 8) * 8
                q8t_pad = torch.nn.functional.pad(q8t, (0, wide - nq))
                lib_ms = time_ms(lambda: torch._int_mm(x8, q8t_pad))
                lib_note = (f"torch._int_mm(x8, q8.T) with q8 zero-padded "
                            f"to {wide} columns" if wide != nq
                            else "torch._int_mm(x8, q8.T)")
                t = {"branch": branch,
                     "ms": time_ms(lambda: segmin_sq8(x8, sides, q, mv,
                                                      "L2")),
                     "kernel_ms": time_ms(raw_sq8),
                     "plain_ms": time_ms(lambda: segmin_sq8_plain(
                         x8, sides, q, mv, "L2"), reps=10),
                     "library_ms": lib_ms, "library_note": lib_note,
                     "bound_ms": b, "bound_by": by}
                timings[("segmin_sq8", nq)] = t
                # the bound's f32 operations at the non-FMA rate, computed
                # beside bound_ms and not folded into it
                epilogue[f"nq={nq}"] = (n_pad * nq * K1_EPILOGUE_OPS
                                        / (F32_FLOPS / 2) * 1e3)
            del x8, sides, mv
        del x, sqn, mask
        torch.cuda.empty_cache()
    equal, d1152 = k1_branches(gen)
    report["segmin_sq8"]["branch_bit_equal"] += equal
    extra = {"timing_segmin_sq8_d1152": d1152,
             "derived_not_measured": {
                 "segmin_sq8_epilogue_ms": epilogue,
                 "how": f"n_pad x nq x {K1_EPILOGUE_OPS} f32 operations "
                        f"over {F32_FLOPS / 2:.3g} a second (the H100's "
                        "non-FMA f32 rate): computed from the shapes, not "
                        "timed"}}
    report["group_aggregate"], timings[("group_aggregate", 1)] = \
        k3_kernel(gen)
    report["merge_count"], timings[("merge_count", 1)] = k4_kernel(gen)
    report["binary_segment_mins"], k5_times = k5_kernel(gen)
    timings.update(k5_times)
    report["distinct_count"], k6_times = k6_kernel(gen)
    timings.update({("distinct_count", G): t for G, t in k6_times.items()})
    return report, timings, extra


def k1_branches(gen):
    """K1's two branches on the same inputs: at d = K1_DP4A_D, 128
    queries take the __dp4a branch and the same queries 64 or 16 at a time,
    or the first 10 alone, the wgmma branch; all bit-equal, for every
    metric.  Also times the __dp4a branch at 128 queries against the same
    queries 64 at a time on the wgmma branch."""
    from myscaledb_tpu_torch.ops.kernels import build
    from myscaledb_tpu_torch.ops.kernels.distance_q import segmin_sq8
    from myscaledb_tpu_torch.ops.vector import build_sq8

    d = K1_DP4A_D
    # a generator of its own, so the later kernels' data stays as it was
    g = torch.Generator(device="cuda").manual_seed(gen.initial_seed() + 4)
    x = torch.randn(100_003, d, device="cuda", generator=g)
    x8, sides = build_sq8(x)
    del x
    n_pad = x8.shape[0]
    mv = sides[3:4] * (torch.rand(n_pad, device="cuda", generator=g)
                       < 0.5).float()
    q = torch.randn(128, d, device="cuda", generator=g)
    lib = build.library()
    branch = {k: K1_BRANCHES[lib.msdb_segmin_sq8_branch(k, d)]
              for k in (128, 64, 16, 10)}
    if branch != {128: "dp4a", 64: "wgmma", 16: "wgmma", 10: "wgmma"}:
        raise AssertionError(f"segmin_sq8 at d={d}: branches {branch}")
    equal = []
    for metric in METRICS:
        whole = segmin_sq8(x8, sides, q, mv, metric)
        for k in (64, 16):
            parts = torch.cat([segmin_sq8(x8, sides, q[i:i + k], mv, metric)
                               for i in range(0, 128, k)])
            if not torch.equal(whole, parts):
                raise AssertionError(f"segmin_sq8 d={d} nq=128 {metric}: "
                                     f"the wgmma branch {k} queries at a "
                                     "time differs from the __dp4a branch")
        equal.append(f"d={d} nq=128 dp4a vs wgmma by 64 and by 16 {metric}")
        if not torch.equal(segmin_sq8(x8, sides, q[:10], mv, metric),
                           whole[:10]):
            raise AssertionError(f"segmin_sq8 d={d} nq=10 {metric}: the "
                                 "wgmma branch differs from the __dp4a "
                                 "branch")
        equal.append(f"d={d} nq=10 wgmma vs dp4a {metric}")
    timing = {
        "rows": n_pad, "dim": d,
        "dp4a_nq128_ms": time_ms(lambda: segmin_sq8(x8, sides, q, mv, "L2"),
                                 reps=20),
        "wgmma_by_64_ms": time_ms(lambda: [
            segmin_sq8(x8, sides, q[i:i + 64], mv, "L2")
            for i in (0, 64)], reps=20)}
    del x8, sides, mv
    torch.cuda.empty_cache()
    return equal, timing


def config4_keys(gen, n_build: int, n_probe: int):
    """bench.py's config-4 keys on the card: build key i is (i * SPREAD) &
    0x7FFFFFFF; probe ids are (u^2 * 2 n_build) for u uniform (zipf-like
    skew over twice the build range, about half of them match), spread
    the same way.  int64 products masked to 31 bits equal the JAX
    package's int32 ones."""
    dev = "cuda"
    ids = torch.arange(n_build, device=dev, dtype=torch.int64)
    build = ((ids * SPREAD) & 0x7FFFFFFF).to(torch.int32)
    u = torch.rand(n_probe, device=dev, generator=gen)
    pid = (u * u * (2 * n_build)).to(torch.int64)
    probe = ((pid * SPREAD) & 0x7FFFFFFF).to(torch.int32)
    return build, probe


def k4_kernel(gen):
    """K4 against merge_count_plain on the card: config 4's keys, then
    duplicates, invalid rows, INT32_MAX probes with and without a genuine
    INT32_MAX build key, an empty and an all-invalid build, and the radix
    directory's edge cases (index_edge_cases), each with the directory
    passed in and built by the wrapper.  Counts must be equal.  Then the
    times at config-4 shapes."""
    from myscaledb_tpu_torch.ops.kernels import build as kbuild
    from myscaledb_tpu_torch.ops.kernels.merge_count import (
        IMAX, BLOCKS_PER_SM, build_count_index, index_edge_cases,
        merge_count, merge_count_plain, prepare_build)

    dev = "cuda"
    rep = {"max_abs_err": 0, "checks": 0, "index_edge_cases": 0}

    def check(b, hm, probe, tag, index=None):
        got = merge_count(b, probe, hm, index)
        want = merge_count_plain(b, probe, hm)
        torch.cuda.synchronize()
        if int(got) != int(want):
            raise AssertionError(f"merge_count {tag}: kernel {int(got)} != "
                                 f"plain {int(want)}")
        rep["checks"] += 1

    keys = torch.randint(-1000, 1000, (100_000,), device=dev, generator=gen,
                         dtype=torch.int32)           # many duplicates
    keys[:10] = IMAX
    valid = torch.rand(100_000, device=dev, generator=gen) < 0.8
    probes = torch.randint(-1200, 1200, (1_000_003,), device=dev,
                           generator=gen, dtype=torch.int32)
    probes[::11] = IMAX
    for genuine in (True, False):
        valid[:10] = genuine
        b, hm = prepare_build(keys, valid)
        if bool(hm) != genuine:
            raise AssertionError("prepare_build: has_max is wrong")
        check(b, hm, probes, f"dups, invalid rows, genuine MAX={genuine}")
    check(*prepare_build(keys[:0]), probes, "empty build")
    check(*prepare_build(keys, torch.zeros_like(valid)), probes,
          "all-invalid build")
    for name, (bk, bv, pk) in index_edge_cases().items():
        b, hm = prepare_build(torch.from_numpy(bk).to(dev),
                              torch.from_numpy(bv).to(dev))
        pk = torch.from_numpy(pk).to(dev)
        check(b, hm, pk, f"edge case {name}", build_count_index(b))
        check(b, hm, pk[1:], f"edge case {name}, no index, unaligned")
        rep["index_edge_cases"] += 1

    build, probe = config4_keys(gen, N4_BUILD, N4_PROBE)
    b, hm = prepare_build(build)
    index = build_count_index(b)
    check(b, hm, probe, "config 4", index)
    nb, n = b.shape[0], probe.shape[0]
    out = torch.zeros((), dtype=torch.int64, device=dev)
    blocks = min(-(-n // (256 * 4)), torch.cuda.get_device_properties(0)
                 .multi_processor_count * BLOCKS_PER_SM)

    def raw_k4():   # the bare launch
        kbuild.check(kbuild.library().msdb_merge_count(
            b.data_ptr(), nb, index.starts.data_ptr(), index.lo, index.hi,
            index.shift, index.steps, probe.data_ptr(), n, hm.data_ptr(),
            out.data_ptr(), blocks, torch.cuda.current_stream().cuda_stream),
            "merge_count")
    # every probe, build key and directory entry read once, the count
    # written once; per probe a range test, the halvings and four compares
    nbytes = 4 * n + 4 * nb + 4 * (index.nbuckets + 1) + 8
    ops = float(n) * (index.steps + 5)
    bnd, by = bound_ms(nbytes, ops, F32_FLOPS)
    t = {"ms": time_ms(lambda: merge_count(b, probe, hm), reps=20),
         "ms_with_index": time_ms(lambda: merge_count(b, probe, hm, index),
                                  reps=20),
         "kernel_ms": time_ms(raw_k4, reps=20),
         "plain_ms": time_ms(lambda: merge_count_plain(b, probe, hm),
                             reps=5),
         "library_ms": time_ms(lambda: torch.isin(probe, build).sum(),
                               reps=5),
         "library_note": "torch.isin(probe, build).sum()",
         "bound_ms": bnd, "bound_by": by, "probes": n, "build_keys": nb,
         "directory": {"buckets": index.nbuckets, "shift": index.shift,
                       "steps": index.steps},
         "ms_note": "ms: the wrapper with no index, so it builds the "
                    "directory (two host syncs); ms_with_index: the "
                    "wrapper given the join build's directory"}
    del build, probe, b, keys, probes
    torch.cuda.empty_cache()
    return rep, t


def k5_kernel(gen):
    """K5 against binary_segment_mins_plain on the card, bit for bit: config
    6's shape (16M rows, 8 words; 16M is not a multiple of 16,384, so the
    last segments are a tail) and FixedString(5) (2 words) over 1,000,003
    rows, nq = 1 and 10, Hamming and Jaccard, no mask and a 50% mask.
    Then the times at config-6 shapes, nq = 1 and 10."""
    from myscaledb_tpu_torch.ops.kernels import build as kbuild
    from myscaledb_tpu_torch.ops.kernels.binary_scan import (
        SEG, SEGS_PER_STEP, QCHUNK_WORDS, binary_segment_mins,
        binary_segment_mins_plain)

    dev = "cuda"
    rep = {"max_abs_err": 0.0, "checks": 0, "bit_equal_checks": 0}
    span = SEG * SEGS_PER_STEP
    times = {}
    for n, words in ((N6, NBYTES6 // 4), (1_000_003, 2)):
        nseg = -(-n // span) * SEGS_PER_STEP
        x3 = torch.randint(-2 ** 31, 2 ** 31 - 1, (nseg, words, SEG),
                           device=dev, generator=gen, dtype=torch.int32)
        x3[0, :, :9] = 0                              # empty unions
        mask2 = (torch.rand(nseg, SEG, device=dev, generator=gen)
                 < 0.5).to(torch.uint8)
        for nq in (1, 10):
            qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (nq, words),
                               device=dev, generator=gen, dtype=torch.int32)
            for metric in ("Hamming", "Jaccard"):
                for has_mask in (False, True):
                    got = binary_segment_mins(x3, qw, mask2, metric, n,
                                              has_mask)
                    want = binary_segment_mins_plain(x3, qw, mask2, metric,
                                                     n, has_mask)
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)):
                        raise AssertionError(
                            f"binary_segment_mins n={n} words={words} "
                            f"nq={nq} {metric} mask={has_mask}: not "
                            "bit-equal to the plain version")
                    rep["checks"] += 1
                    rep["bit_equal_checks"] += 1
            if n != N6:
                continue
            out = torch.empty((nseg, nq), device=dev)
            qchunk = max(1, min(nq, QCHUNK_WORDS // words))

            def raw_k5():   # the bare launch: Hamming, no mask
                kbuild.check(kbuild.library().msdb_binary_segmin(
                    x3.data_ptr(), qw.data_ptr(), x3.data_ptr(),
                    out.data_ptr(), nseg, words, nq, n, 0, 0, qchunk,
                    torch.cuda.current_stream().cuda_stream),
                    "binary_segment_mins")
            # the packed table and the queries read once (an unmasked call
            # reads no mask bytes), the (nseg, nq) minima written once;
            # xor, popcount and add per word
            nbytes = nseg * SEG * 4 * words + 4 * nseg * nq \
                + 4 * nq * words
            bnd, by = bound_ms(nbytes, 3.0 * n * words * nq, F32_FLOPS)
            times[("binary_segment_mins", nq)] = {
                "ms": time_ms(lambda: binary_segment_mins(
                    x3, qw, mask2, "Hamming", n, False)),
                "kernel_ms": time_ms(raw_k5),
                "plain_ms": time_ms(lambda: binary_segment_mins_plain(
                    x3, qw, mask2, "Hamming", n, False), reps=5),
                "library_ms": None,
                "library_note": "none: no single PyTorch call computes a "
                                "popcount distance",
                "bound_ms": bnd, "bound_by": by, "rows": n, "words": words}
        del x3, mask2
        torch.cuda.empty_cache()
    return rep, times


def k3_kernel(gen):
    """K3 against group_aggregate_plain on the card: n in {100M,
    1,000,003}, G in {1, 17, 256}, four argument sets (the last with min
    and max lanes), a 50% and an all-false mask, int extremes; float sums
    also bit-identical between two kernel calls.  Then the times at
    config-2 shapes, and of a global min and max of one int32 column over
    100M rows (mix5's date_range) beside the scatter reductions they
    replace."""
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
                                     (v, f, None, v)),
                                    (("min", "max", "float", "int"),
                                     (v, v, f, v))):
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
    lane_arg = (ctypes.c_byte * 8)(0)
    lane_kind = (ctypes.c_byte * 8)(0)           # one int sum lane
    init = (ctypes.c_longlong * 8)(0)

    def raw_k3():   # the bare launch (both kernels of the entry point)
        build.check(build.library().msdb_group_agg(
            gid.data_ptr(), mask.data_ptr(), ptrs, 1, 0, 0, lane_arg,
            lane_kind, init, 1, n, G, nblocks, rows, part_i.data_ptr(),
            part_f.data_ptr(), out_i.data_ptr(), out_f.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "group_aggregate")

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
    t["min_max_one_group"] = k3_min_max_one_group(gen)
    return rep, t


def k3_min_max_one_group(gen):
    """SELECT min(d), max(d) over 100M int32 rows with no WHERE: K3 (one
    argument, a min and a max lane, G = 1) against the scatter reductions
    it replaces (ops/aggregate.py::partial_aggregate)."""
    from myscaledb_tpu_torch.ops import aggregate as A
    from myscaledb_tpu_torch.ops.kernels import build
    from myscaledb_tpu_torch.ops.kernels.group_agg import (
        group_aggregate, grid)

    dev, n = "cuda", N2
    gid = torch.zeros(n, dtype=torch.int32, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    v = torch.randint(0, 65536, (n,), device=dev, generator=gen,
                      dtype=torch.int32)
    nblocks, rows = grid(n)
    part_i = torch.empty((nblocks, 3, 1), dtype=torch.int64, device=dev)
    part_f = torch.empty((nblocks, 2, 1), dtype=torch.float32, device=dev)
    out_i = torch.empty((3, 1), dtype=torch.int64, device=dev)
    out_f = torch.empty((2, 1), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * 8)(v.data_ptr())
    lane_arg = (ctypes.c_byte * 8)(0, 0)
    lane_kind = (ctypes.c_byte * 8)(1, 2)
    init = (ctypes.c_longlong * 8)(2 ** 31 - 1, -2 ** 31)

    def raw():      # the bare launch (both kernels of the entry point)
        build.check(build.library().msdb_group_agg(
            gid.data_ptr(), mask.data_ptr(), ptrs, 1, 0, 0, lane_arg,
            lane_kind, init, 2, n, 1, nblocks, rows, part_i.data_ptr(),
            part_f.data_ptr(), out_i.data_ptr(), out_f.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "group_aggregate")

    raw()
    (lo, hi), _gc = A.partial_aggregate(gid, mask, (v, v), ("min", "max"), 1)
    if not (int(out_i[1, 0]) == int(lo[0]) == int(v.min())
            and int(out_i[2, 0]) == int(hi[0]) == int(v.max())):
        raise AssertionError("group_aggregate min/max lanes differ from the "
                             "scatter reductions")
    b, by = bound_ms(n * (4 + 1 + 4) + 3 * 8, 3.0 * n, F32_FLOPS)
    t = {"ms": time_ms(lambda: group_aggregate(gid, mask, (v, v),
                                               ("min", "max"), 1)),
         "kernel_ms": time_ms(raw),
         "scatter_ms": time_ms(lambda: A.partial_aggregate(
             gid, mask, (v, v), ("min", "max"), 1), reps=3),
         "scatter_note": "ops/aggregate.py::partial_aggregate, min and max "
                         "by scatter_reduce_ into G + 1 slots (the route "
                         "before the lanes)",
         "bound_ms": b, "bound_by": by}
    del gid, mask, v, part_i, part_f
    torch.cuda.empty_cache()
    return t


def k6_kernel(gen):
    """K6 (distinct_count) at mix5's shapes: the hits table's UserID and
    RegionID made by the benchmark's own generator (100M rows, UserID
    skewed over 17.6M values, rows in PRIMARY KEY order), counted at G = 1
    (count(DISTINCT UserID)) and G = 9,040 (grouped by RegionID), every
    row selected.  Each count equals the sort-based plain version; then
    the wrapper, the bare launch, the plain version and torch.unique over
    the (group, key) pairs (a yardstick the port never calls) are timed."""
    from portbench.datagen import hits as hits_gen
    from myscaledb_tpu_torch.ops.kernels import build
    from myscaledb_tpu_torch.ops.kernels.distinct_count import (
        capacity, distinct_count, distinct_count_plain)

    cfg = json.loads((Path(__file__).resolve().parent / "portbench" /
                      "configs" / "clickbench_hits_100m.json").read_text())
    cfg["tables"] = {"hits": [["UserID", "Int64"], ["RegionID", "Int32"],
                              ["CounterID", "Int32"], ["EventDate", "Date"],
                              ["EventTime", "DateTime"]]}
    cols = hits_gen.make(cfg, gen.initial_seed() + 6, "cuda")["tables"]["hits"]
    uid, region = cols["UserID"], cols["RegionID"]
    del cols
    torch.cuda.empty_cache()
    n = uid.shape[0]
    G_REGIONS = int(cfg["assumed"]["regions"])
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    cap = capacity(n)
    table = torch.empty((cap, 2), dtype=torch.int64, device="cuda")
    overflow = torch.empty(1, dtype=torch.int32, device="cuda")
    rep, times = {"checks": 0, "max_abs_err": 0.0}, {}
    for G, gid in ((1, torch.zeros(n, dtype=torch.int32, device="cuda")),
                   (G_REGIONS, region)):
        counts = torch.empty(G, dtype=torch.int64, device="cuda")

        def raw():      # the bare launch: fill, memsets and the kernel
            build.check(build.library().msdb_distinct_count(
                gid.data_ptr(), uid.data_ptr(), 8, mask.data_ptr(), n, G,
                table.data_ptr(), cap, counts.data_ptr(),
                overflow.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "distinct_count")

        def raw_fill():     # the same entry over no rows: the table's fill
            build.check(build.library().msdb_distinct_count(
                gid.data_ptr(), uid.data_ptr(), 8, mask.data_ptr(), 0, G,
                table.data_ptr(), cap, counts.data_ptr(),
                overflow.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "distinct_count")

        got = distinct_count(gid, uid, mask, G)
        raw()
        want = distinct_count_plain(gid, uid, mask, G)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(counts, want)):
            raise AssertionError(f"distinct_count G={G}: counts differ from "
                                 "the plain version")
        rep["checks"] += 1
        pairs = torch.stack((gid.long(), uid), 1)
        # key, gid and mask read once, the counts written once
        b, by = bound_ms(n * (8 + 4 + 1) + G * 8, 0.0, F32_FLOPS)
        times[G] = {
            "ms": time_ms(lambda: distinct_count(gid, uid, mask, G), reps=20),
            "kernel_ms": time_ms(raw, reps=20),
            "fill_ms": time_ms(raw_fill, reps=20),
            "plain_ms": time_ms(lambda: distinct_count_plain(
                gid, uid, mask, G), reps=3),
            "library_ms": time_ms(lambda: torch.unique(pairs, dim=0),
                                  reps=3),
            "library_note": "torch.unique(torch.stack((gid, key), 1), dim=0)",
            "bound_ms": b, "bound_by": by,
            "table_bytes": cap * 16, "distinct_tuples": int(want.sum()),
            "rows": n}
        del pairs
        torch.cuda.empty_cache()
    del uid, region, mask, table
    torch.cuda.empty_cache()
    return rep, times


def vec_sql(v: np.ndarray) -> str:
    return "[" + ",".join(repr(float(a)) for a in v) + "]"


def oracle(x, price, q, k):
    """Direct-formula L2 over every row on the card, WHERE price < 50,
    stable sort by (distance, id)."""
    dist = ((x - q[None, :]) ** 2).sum(1)
    dist = torch.where(price < 50, dist, torch.inf)
    order = torch.sort(dist, stable=True).indices[:k]
    return order.cpu().numpy(), dist[order].cpu().numpy()


def device_profiler():
    """torch.profiler over the CPU and the card.  It records the card's
    work that pool threads issue too (``worker_copy_probe``), but now and
    then loses a whole window's device events (``timed_step`` checks)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_events(prof) -> list:
    """The profile's device-side rows (kernels, copies): the CPU-side op
    rows repeat the device time of the kernels they launch."""
    return [e for e in prof.key_averages() if _dev_us(e) > 0 and (
        getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        or e.self_cpu_time_total == 0)]


def device_trace(prof) -> list:
    """The profile's device-side events (kernels, copies, fills) one by
    one: each has its card (``device_index``), its stream
    (``device_resource_id``) and its interval (``time_range``, in us)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def union_us(events) -> float:
    """Length of the union of the events' intervals (us): the time some
    kernel ran, however many ran at once."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_statements(s, statements, to_rows: bool = True):
    """Where a query's time goes: torch.profiler over a few main-path
    statements (each result read back with to_rows() unless ``to_rows`` is
    false: the window phase's 10M-row results stay on the card).  Returns
    wall time, summed device kernel time (their ratio is the device's busy
    share, with the profiler's own host overhead in the wall time) and the
    kernels that take the most device time."""
    def run():
        for stmt in statements:
            res = s.sql(stmt)
            if to_rows:
                res.to_rows()
    return profile_calls(run, len(statements))


def profile_calls(fn, n: int = 1):
    """profile_statements' reading of ``fn()``, which makes ``n`` calls:
    wall ms a call; device ms a call, the union of the device events'
    intervals, and the busy share it gives (at most 1 however many
    streams run at once); the events' summed time a call beside it; the
    top kernels by summed time."""
    with device_profiler() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = device_trace(prof)
    device_ms = union_us(events) / 1e3 / n
    # kernels whose names share their first 60 characters (two template
    # instances) are summed under that prefix
    by_name = {}
    for e in events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            e.time_range.elapsed_us() / n
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    return {"wall_ms_per_query": wall_ms,
            "device_ms_per_query": device_ms,
            "kernel_ms_summed_per_query": sum(by_name.values()) / 1e3,
            "device_busy_share": device_ms / wall_ms,
            "top_kernels_us_per_query": dict(top)}


def host_split(s, statements):
    """Where a statement's host-clock time goes, by the port's tracing
    spans (query, parse, analyze, vector_topk, materialize, sort,
    limit_by): each span's own time less its children's, in ms per
    statement, beside to_rows(), the time outside every span, and the
    whole statement.  Spans do not
    synchronize the card, so the scan's device time lands in the span
    that first waits for it (materialize's copy of the top-k ids)."""
    from myscaledb_tpu_torch.runtime.tracing import (clear_span_log,
                                                     span_log_snapshot)
    clear_span_log()
    total = to_rows = 0.0
    for stmt in statements:
        t0 = time.perf_counter()
        res = s.sql(stmt)
        t1 = time.perf_counter()
        res.to_rows()
        t2 = time.perf_counter()
        total += t2 - t0
        to_rows += t2 - t1
    spans = span_log_snapshot()
    children = {}
    for sp in spans:
        if sp.parent_span_id is not None:
            children[sp.parent_span_id] = \
                children.get(sp.parent_span_id, 0.0) + sp.end - sp.start
    own = {}
    for sp in spans:
        own[sp.name] = own.get(sp.name, 0.0) + sp.end - sp.start \
            - children.get(sp.span_id, 0.0)
    n = len(statements)
    out = {f"{name}_own_ms": v * 1e3 / n for name, v in sorted(own.items())}
    out["to_rows_ms"] = to_rows * 1e3 / n
    out["outside_spans_ms"] = (total - to_rows - sum(own.values())) * 1e3 / n
    out["statement_ms"] = total * 1e3 / n
    return out


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
    zero_launches()
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
    counts = {"sql_sq8": read_launches()}
    sq8_runs = counts["sql_sq8"]["segmin_sq8"]
    f32_runs = counts["sql_sq8"]["segmin_f32"]
    if sq8_runs < 20 or f32_runs != 0:
        raise AssertionError(f"certified path not taken: segmin_sq8 "
                             f"{sq8_runs}, segmin_f32 {f32_runs} launches")
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
          "launches": counts["sql_sq8"],
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
    zero_launches()
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
    counts["sql_f32"] = read_launches()
    emit({"phase": "sql_f32", "rows": m, "statements": out,
          "launches": counts["sql_f32"], "ids": "0..9 for each metric"})
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
    zero_launches()
    lat, per_query = [], []
    for qi in range(10):
        before = group_aggregate.launches
        t0 = time.perf_counter()
        rows = s.sql(GROUPBY_SQL).to_rows()
        lat.append((time.perf_counter() - t0) * 1e3)
        per_query.append(group_aggregate.launches - before)
        check_groupby_rows(rows, cnt, sums, f"query {qi}")
    counts = read_launches()
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
          "launches": counts,
          "group_aggregate_launches_per_query": per_query,
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
    return counts


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
    # min / max: K3's lanes; any (the value of the lowest row id): scatter
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


def phase_join_count(seed: int):
    """Config 4 as bench.py runs it: build_join_table over the 10M dim keys,
    then ht_count_matches with the 125M probes, eleven times (the first a
    warm-up); each count equal to torch.isin on the card."""
    from myscaledb_tpu_torch.ops.hashtable import ht_count_matches
    from myscaledb_tpu_torch.ops.join import build_join_table

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    build, probe = config4_keys(gen, N4_BUILD, N4_PROBE)
    want = int(torch.isin(probe, build).sum())
    # the path's own run: counts zeroed just before, read just after
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = build_join_table((build,))
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    lat = []
    for i in range(11):
        t0 = time.perf_counter()
        got = int(ht_count_matches(table, (probe,)))
        lat.append((time.perf_counter() - t0) * 1e3)
        if got != want:
            raise AssertionError(f"count probe {i}: {got} != oracle {want}")
    counts = read_launches()
    if counts["merge_count"] < 11:
        raise AssertionError(f"merge_count launched {counts['merge_count']} "
                             "times in 11 count probes")
    warm, lat = lat[0], lat[1:]
    emit({"phase": "join_count", "build_keys": N4_BUILD, "probes": N4_PROBE,
          "matches": want, "build_ms": build_ms,
          "warmup_count_ms": warm, "median_count_ms": float(np.median(lat)),
          "p90_count_ms": float(np.percentile(lat, 90)), "count_ms": lat,
          "probes_per_s": N4_PROBE / (float(np.median(lat)) / 1e3),
          "launches": counts,
          "oracle": "count equal to torch.isin(probe, build).sum()"})
    del table, build, probe
    torch.cuda.empty_cache()
    return counts


def phase_sql_join(seed: int):
    """Joins through Session.sql over a 10M-row fact and a 1M-row dim
    table, and an ALL join against a 2M-row dim table whose keys repeat;
    every result against a searchsorted oracle on the card."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.ops.kernels.merge_count import (
        build_count_index, prepare_build)

    rng = np.random.default_rng(seed + 5)
    t0 = time.perf_counter()
    dim_k = ((np.arange(NJ_DIM, dtype=np.int64) * SPREAD) & 0x7FFFFFFF) \
        .astype(np.int32)
    u = rng.random(NJ_FACT, dtype=np.float32)
    fact_k = ((((u * u * np.float32(2 * NJ_DIM)).astype(np.int64) * SPREAD)
               & 0x7FFFFFFF)).astype(np.int32)
    s = P.connect()
    # the ALL fan-out's probe and row pairs over 10M fact rows ask more
    # of the per-query budget than its 512 MiB default (the JAX
    # package's merge sort over 11M rows, ~1 GiB)
    s.settings.max_memory_bytes_per_query = 8 << 30
    s.create_table("f", {"id": np.arange(NJ_FACT, dtype=np.int64),
                         "k": fact_k,
                         "v": rng.integers(-1000, 1000, NJ_FACT,
                                           dtype=np.int32)})
    s.create_table("d", {"k": dim_k,
                         "c": rng.integers(0, 100, NJ_DIM, dtype=np.int32)})
    # each dim key drawn twice on average: 0, 1, 2, ... copies (Poisson)
    s.create_table("d2", {"k": dim_k[rng.integers(0, NJ_DIM, 2 * NJ_DIM)],
                          "c": rng.integers(0, 100, 2 * NJ_DIM,
                                            dtype=np.int32)})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    f, d, d2 = s.tables["f"], s.tables["d"], s.tables["d2"]
    fid, fk, fv = f["id"].data, f["k"].data, f["v"].data
    ds, order = torch.sort(d["k"].data)
    pos = torch.searchsorted(ds, fk).clamp(max=NJ_DIM - 1)
    found = ds[pos] == fk
    c_of = d["c"].data[order[pos]]

    def same(a, b, tag):
        if not torch.equal(a, b):
            raise AssertionError(f"sql_join {tag}: differs from the oracle")

    out = {}

    def run(name, sql):
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = s.sql(sql)
        torch.cuda.synchronize()
        after = read_launches()
        out[name] = {"statement": sql, "rows": res.n_rows,
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "launches": {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}}
        return res

    # the path's own run, from the first statement to the last timed one:
    # counts zeroed just before, read just after
    zero_launches()
    for strict in ("ANY", "ALL"):
        res = run(f"inner_{strict.lower()}", "SELECT id, c FROM f "
                  f"{strict} INNER JOIN d ON f.k = d.k")
        same(res["id"].data, fid[found], f"INNER {strict} ids")
        same(res["c"].data, c_of[found], f"INNER {strict} c")
    # LEFT ALL: the matched rows in probe order, then the unmatched ones
    # NULL-padded (the JAX package's order)
    res = run("left", "SELECT id, c FROM f LEFT JOIN d ON f.k = d.k")
    hits = int(found.sum())
    same(res["id"].data, torch.cat([fid[found], fid[~found]]), "LEFT ids")
    same(res["c"].valid, torch.arange(NJ_FACT, device=fid.device) < hits,
         "LEFT NULLs")
    same(res["c"].data[:hits], c_of[found], "LEFT c")
    res = run("semi", "SELECT id FROM f SEMI LEFT JOIN d ON f.k = d.k")
    same(res["id"].data, fid[found], "SEMI")
    res = run("anti", "SELECT id FROM f ANTI LEFT JOIN d ON f.k = d.k")
    same(res["id"].data, fid[~found], "ANTI")
    # ALL with repeated build keys: every (fact row, dim row) pair whose
    # keys are equal, from the searchsorted range of each fact key
    res = run("inner_all_fanout", "SELECT id, c FROM f ALL INNER JOIN d2 "
              "ON f.k = d2.k")
    ds2, order2 = torch.sort(d2["k"].data)
    lo = torch.searchsorted(ds2, fk)
    fan = torch.searchsorted(ds2, fk, right=True) - lo
    first = torch.repeat_interleave(torch.cumsum(fan, 0) - fan, fan)
    at = torch.repeat_interleave(lo, fan) + torch.arange(
        first.shape[0], device=fid.device) - first
    want_pairs = torch.sort(torch.repeat_interleave(fid, fan) * 100
                            + d2["c"].data[order2[at]]).values
    got_pairs = torch.sort(res["id"].data * 100 + res["c"].data).values
    same(got_pairs, want_pairs, "ALL fan-out (id, c) pairs")
    out["inner_all_fanout"]["max_fanout"] = int(fan.max())
    out["inner_all_fanout"]["fact_rows_matched"] = int((fan > 0).sum())
    del ds2, order2, lo, fan, first, at, want_pairs, got_pairs, res
    agg_sql = "SELECT count(), sum(v), sum(c) FROM f INNER JOIN d ON " \
        "f.k = d.k"
    want = [(int(found.sum()), int(fv[found].sum()),
             int(c_of[found].sum()))]
    t0 = time.perf_counter()
    if s.sql(agg_sql).to_rows() != want:                   # warm-up
        raise AssertionError("sql_join aggregate: differs from the oracle")
    first_s = time.perf_counter() - t0
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        rows = s.sql(agg_sql).to_rows()
        lat.append((time.perf_counter() - t0) * 1e3)
        if rows != want:
            raise AssertionError("sql_join aggregate: differs from the "
                                 "oracle")
    counts = read_launches()
    # outside every reported count
    breakdown = profile_statements(s, [agg_sql] * 3)
    # what K4's directory costs over the dim keys, timed alone: no
    # statement here builds it (a join of one integer key takes the
    # sorted build, ops/join.py::build_sorted), only the join count of
    # the join_count phase; host clock, median of ten after a warm-up
    dsorted, _ = prepare_build(d["k"].data)
    dir_ms = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_count_index(dsorted)
        torch.cuda.synchronize()
        dir_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "sql_join", "fact_rows": NJ_FACT, "dim_rows": NJ_DIM,
          "fanout_dim_rows": 2 * NJ_DIM,
          "matched_fact_rows": want[0][0], "load_s": load_s,
          "statements": out, "aggregate_statement": agg_sql,
          "warmup_query_s": first_s,
          "median_query_ms": float(np.median(lat)),
          "p90_query_ms": float(np.percentile(lat, 90)), "query_ms": lat,
          "probe_rows_per_s": NJ_FACT / (float(np.median(lat)) / 1e3),
          "launches": counts,
          "dim_directory_build_ms": float(np.median(dir_ms[1:])),
          "dim_directory_buckets": index.nbuckets,
          "max_memory_bytes_per_query":
              s.settings.max_memory_bytes_per_query,
          "oracle": "ids, values and NULLs equal to a searchsorted join on "
                    "the card; the fan-out's (id, c) pairs equal as "
                    "multisets; count and int sums equal",
          "profile_3_queries": breakdown})
    s.tables.clear()
    del fid, fk, fv, ds, order, pos, found, c_of, dsorted, index
    torch.cuda.empty_cache()
    return counts


def binary_oracle(raw_dev, q_dev, metric, keep, k):
    """Top-k (distance, id) over every row on the card, from a byte-table
    popcount (independent of the port's SWAR count): stable sort by
    distance, so ties keep ascending ids."""
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int32, device=raw_dev.device)
    parts = []
    for a in range(0, raw_dev.shape[0], 1 << 21):
        x = raw_dev[a:a + (1 << 21)]
        if metric == "Hamming":
            parts.append(lut[(x ^ q_dev).long()].sum(1).to(torch.float32))
            continue
        inter = lut[(x & q_dev).long()].sum(1).to(torch.float32)
        union = lut[(x | q_dev).long()].sum(1).to(torch.float32)
        parts.append(torch.where(union > 0, (union - inter) / union,
                                 torch.ones_like(union)))
    dist = torch.cat(parts)
    if keep is not None:
        dist = torch.where(keep, dist, torch.inf)
    top = torch.sort(dist, stable=True).indices[:k]
    return top.cpu().tolist(), dist[top].cpu().numpy()


def phase_sql_binary(seed: int):
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.config import TableSettings
    from myscaledb_tpu_torch.core.table import Column, Table
    from myscaledb_tpu_torch.interop import fixed_string_column
    from myscaledb_tpu_torch.sql.executor import _binary_sidecar

    rng = np.random.default_rng(seed + 6)
    t0 = time.perf_counter()
    raw = rng.integers(0, 256, (N6, NBYTES6), dtype=np.uint8)
    tag = rng.integers(0, 100, N6, dtype=np.int32)
    s = P.connect()
    s.register("tb", Table([
        Column.from_numpy("id", np.arange(N6, dtype=np.int64),
                          device="cuda"),
        Column.from_numpy("tag", tag, device="cuda"),
        fixed_string_column("bv", raw, NBYTES6, device="cuda")]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    raw_dev = torch.from_numpy(raw).cuda()
    keep = s.tables["tb"]["tag"].data < 50
    del raw
    # the packed sidecar is built on a table's first query; build it here
    # to time it on its own
    t0 = time.perf_counter()
    _binary_sidecar(s, "tb", s.tables["tb"], "bv")
    torch.cuda.synchronize()
    sidecar_s = time.perf_counter() - t0
    qs = rng.integers(0, 256, (12, NBYTES6), dtype=np.uint8)
    stmt = "SELECT id, distance(bv, unhex('{h}')) AS d FROM tb {w}" \
        "ORDER BY d LIMIT 10"

    def query(qi, where="", metric="Hamming"):
        rows = s.sql(stmt.format(h=qs[qi].tobytes().hex(), w=where)) \
            .to_rows()
        ids, dist = binary_oracle(raw_dev, torch.from_numpy(qs[qi]).cuda(),
                                  metric, keep if where else None, K)
        if [r[0] for r in rows] != ids or not np.array_equal(
                np.array([r[1] for r in rows], dtype=np.float32), dist):
            raise AssertionError(f"sql_binary query {qi} {where}{metric}: "
                                 f"rows {rows[:3]}... differ from the "
                                 f"oracle {ids[:3]}...")

    t0 = time.perf_counter()
    query(0)                                             # warm-up
    first_s = time.perf_counter() - t0
    # the main path's own run: counts zeroed just before, read just after
    zero_launches()
    lat = []
    for qi in range(1, 11):
        t0 = time.perf_counter()
        rows = s.sql(stmt.format(h=qs[qi].tobytes().hex(), w="")).to_rows()
        lat.append((time.perf_counter() - t0) * 1e3)
        ids, dist = binary_oracle(raw_dev, torch.from_numpy(qs[qi]).cuda(),
                                  "Hamming", None, K)
        if [r[0] for r in rows] != ids or [r[1] for r in rows] != \
                dist.tolist():
            raise AssertionError(f"sql_binary query {qi}: differs from the "
                                 "oracle")
    counts = read_launches()
    if counts["binary_segment_mins"] < 10:
        raise AssertionError("binary_segment_mins launched "
                             f"{counts['binary_segment_mins']} times in 10 "
                             "queries")
    # outside every reported count; twenty queries, so that the
    # profiler's own start and stop (a few hundred ms) weigh little
    breakdown = profile_statements(
        s, [stmt.format(h=qs[qi % 10 + 1].tobytes().hex(), w="")
            for qi in range(20)])
    t0 = time.perf_counter()
    query(11, where="WHERE tag < 50 ")
    filtered_ms = (time.perf_counter() - t0) * 1e3
    s.table_settings["tb"] = TableSettings(
        binary_vector_search_metric_type="Jaccard")
    t0 = time.perf_counter()
    query(11, metric="Jaccard")
    jaccard_ms = (time.perf_counter() - t0) * 1e3
    query(10, where="WHERE tag < 50 ", metric="Jaccard")
    emit({"phase": "sql_binary", "rows": N6, "bytes_per_vector": NBYTES6,
          "k": K, "queries": 10,
          "statement": stmt.format(h="<64 hex>", w=""),
          "load_s": load_s, "sidecar_build_s": sidecar_s,
          "warmup_query_s": first_s,
          "median_query_ms": float(np.median(lat)),
          "p90_query_ms": float(np.percentile(lat, 90)), "query_ms": lat,
          "rows_scanned_per_s": N6 / (float(np.median(lat)) / 1e3),
          "launches": counts,
          "where_tag_lt_50_ms_oracle_included": filtered_ms,
          "jaccard_ms_oracle_included": jaccard_ms,
          "oracle": "ids and f32 distances equal to a byte-table popcount "
                    "over every row on the card, ties by id",
          "profile_20_queries": breakdown})
    s.tables.clear()
    del raw_dev, keep
    torch.cuda.empty_cache()
    return counts


# BASELINE config 1 through DDL: the same shape as phase sql_sq8, built
# with CREATE / INSERT ... SELECT; bench.py's nq = 10 and the kernels' most
NQ_BATCH = (10, 128)
NQ_BATCH_SAME = (10, 32, 128)
N_BACKGROUND = 1 << 21          # rows of the index build the background
                                # executor takes (ddl.BACKGROUND_BUILD_ROWS)


def batch_sql(table: str, qs: np.ndarray, where="WHERE price < 50 ") -> str:
    lit = "[" + ",".join(vec_sql(q) for q in qs) + "]"
    return (f"SELECT id, batch_distance(emb, {lit}) AS dist FROM {table} "
            f"{where}ORDER BY dist.1, dist.2 LIMIT {K} BY dist.1")


def check_rows(s, table, rows, qs, tag, exact_ids=True):
    """Each query's (id, distance) rows against the direct-formula oracle
    over the table's current rows (WHERE price < 50, ties by id); ids are
    read through the table's id column, so a compacted table maps right."""
    t = s.tables[table]
    x, price, idc = t["emb"].data, t["price"].data, t["id"].data
    qs = np.atleast_2d(qs)
    for qi, q in enumerate(qs):
        got = [r for r in rows if len(r) == 2 or r[1] == qi]
        order, want_d = oracle(x, price, torch.as_tensor(q, device="cuda"),
                               K)
        want_ids = idc[torch.as_tensor(order, device="cuda")].cpu().tolist()
        got_ids = [int(r[0]) for r in got]
        if got_ids != want_ids:
            raise AssertionError(f"{tag} query {qi}: ids {got_ids} != "
                                 f"oracle {want_ids}")
        np.testing.assert_allclose([r[-1] for r in got], want_d,
                                   rtol=SQL_RTOL, err_msg=tag)


def timed_statements(s, statements):
    """Host-clock ms and rows of each statement, and how many times K2
    launched in each."""
    from myscaledb_tpu_torch.ops.kernels.distance import segmin_f32
    lat, out, k2 = [], [], []
    for sql in statements:
        before = segmin_f32.launches
        t0 = time.perf_counter()
        rows = s.sql(sql).to_rows()
        lat.append((time.perf_counter() - t0) * 1e3)
        out.append(rows)
        k2.append(segmin_f32.launches - before)
    return lat, out, k2


def certificate_held(s, table, qs) -> bool:
    """K1's certificate for one statement's queries (one verdict for all
    of them), recomputed from the table's sidecar as the scan computes it
    (WHERE price < 50, k = 10, margin 16).  Called outside every counted
    run: it launches K1."""
    from myscaledb_tpu_torch.ops.vector import _distance_scan_sq8
    from myscaledb_tpu_torch.sql.executor import _vector_sidecar
    t = s.tables[table]
    _sqn, (x8, sides) = _vector_sidecar(s, table, t, "emb")
    _d, _i, ok = _distance_scan_sq8(
        t["emb"].data, x8, sides,
        torch.as_tensor(np.atleast_2d(qs), device="cuda"),
        t["price"].data < 50, "L2", K, True, 16)
    return bool(ok)


def check_k2_where_certificate_fails(s, table, qss, k2, tag) -> int:
    """K2 launched in a statement exactly when K1's certificate failed
    for it (the scan's fallback).  Returns the statements certified."""
    held = [certificate_held(s, table, qs) for qs in qss]
    for i, (h, n2) in enumerate(zip(held, k2)):
        if n2 != (0 if h else 1):
            raise AssertionError(f"{tag} statement {i}: certificate "
                                 f"{'held' if h else 'failed'}, K2 "
                                 f"launched {n2} times")
    return sum(held)


def summary_ms(lat) -> dict:
    return {"median_ms": float(np.median(lat)),
            "p90_ms": float(np.percentile(lat, 90)), "ms": lat}


def phase_sql_ddl(seed: int):
    """Config 1 at full width through the statements a user types: CREATE,
    ten INSERT ... SELECT batches, OPTIMIZE, ADD VECTOR INDEX, distance and
    batch_distance queries, the uncertifiable batch statements, DELETE,
    DETACH/ATTACH, a background index build, DROP."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.ops.kernels.distance import segmin_f32
    from myscaledb_tpu_torch.ops.kernels.distance_q import segmin_sq8
    from myscaledb_tpu_torch.storage.background import default_executor

    rng = np.random.default_rng(seed + 10)
    s = P.connect()
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    s.create_table("src", data)
    del data
    out = {}
    s.sql("CREATE TABLE tv (id UInt32, emb Array(Float32), price Int32, "
          f"CONSTRAINT emb_len CHECK length(emb) = {D}) ENGINE = MergeTree "
          "ORDER BY id")
    # the background merge would collapse the parts at eight; hold it off
    # so system.parts shows the ten batches
    s.sql("SYSTEM STOP MERGES tv")
    step = N // 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ins = []
    for a in range(0, N, step):
        t1 = time.perf_counter()
        s.sql(f"INSERT INTO tv SELECT id, emb, price FROM src "
              f"WHERE id >= {a} AND id < {a + step}")
        torch.cuda.synchronize()
        ins.append((time.perf_counter() - t1) * 1e3)
    insert_s = time.perf_counter() - t0
    parts = s.sql("SELECT count() FROM system.parts WHERE table = 'tv'") \
        .to_rows()[0][0]
    if parts != 10 or s.tables["tv"].n_rows != N:
        raise AssertionError(f"after ten INSERTs: {parts} parts, "
                             f"{s.tables['tv'].n_rows} rows")
    s.sql("OPTIMIZE TABLE tv FINAL")
    parts_after = s.sql("SELECT count() FROM system.parts "
                        "WHERE table = 'tv'").to_rows()[0][0]
    if parts_after != 1:
        raise AssertionError(f"OPTIMIZE FINAL left {parts_after} parts")
    if s.tables["tv"]["emb"].data.data_ptr() % 16:
        raise AssertionError("the concatenated vectors are not 16-byte "
                             "aligned")
    s.sql("DROP TABLE src")
    torch.cuda.empty_cache()
    out["load"] = {"insert_s": insert_s, "insert_rows_per_s": N / insert_s,
                   "insert_batch_ms": ins, "parts_after_inserts": parts,
                   "parts_after_optimize": parts_after}

    t0 = time.perf_counter()
    s.sql("ALTER TABLE tv ADD VECTOR INDEX v emb TYPE MSTG")
    torch.cuda.synchronize()
    out["index_build_ms"] = (time.perf_counter() - t0) * 1e3
    status = s.sql("SELECT status FROM system.vector_indices "
                   "WHERE table = 'tv'").to_rows()
    if status != [("Built",)]:
        raise AssertionError(f"index status {status}")

    stmt = ("SELECT id, distance(emb, {q}) AS d FROM tv WHERE price < 50 "
            "ORDER BY d LIMIT 10")
    queries = rng.standard_normal((20, D), dtype=np.float32)
    counts = {}
    # the DDL-built table's distance statements: counts zeroed just
    # before, read just after
    zero_launches()
    lat, rows, k2 = timed_statements(s, [stmt.format(q=vec_sql(q))
                                         for q in queries])
    counts["sql_ddl"] = read_launches()
    for qi, r in enumerate(rows):
        check_rows(s, "tv", r, queries[qi], f"sql_ddl distance {qi}")
    if counts["sql_ddl"]["segmin_sq8"] != 20:
        raise AssertionError(f"distance statements: {counts['sql_ddl']}")
    held = check_k2_where_certificate_fails(s, "tv", queries, k2,
                                            "sql_ddl distance")
    out["distance"] = {**summary_ms(lat), "launches": counts["sql_ddl"],
                       "certificate_held": f"{held} of 20 statements"}

    out["batch"] = {}
    for nq in NQ_BATCH:
        qs = [rng.standard_normal((nq, D), dtype=np.float32)
              for _ in range(11)]
        s.sql(batch_sql("tv", qs[0]))                   # warm-up
        zero_launches()
        lat, rows, k2 = timed_statements(s, [batch_sql("tv", q)
                                             for q in qs[1:]])
        c = read_launches()
        counts[f"sql_ddl_batch_nq{nq}"] = c
        for i, r in enumerate(rows):
            if len(r) != nq * K:
                raise AssertionError(f"batch nq={nq}: {len(r)} rows")
            check_rows(s, "tv", r, qs[i + 1], f"sql_ddl batch nq={nq}")
        if c["segmin_sq8"] != 10:
            raise AssertionError(f"batch nq={nq}: K1 launched "
                                 f"{c['segmin_sq8']} times in 10 statements")
        held = check_k2_where_certificate_fails(s, "tv", qs[1:], k2,
                                                f"batch nq={nq}")
        # outside every reported count: where a batch statement's time goes
        breakdown = profile_statements(s, [batch_sql("tv", q)
                                           for q in qs[1:4]])
        split = host_split(s, [batch_sql("tv", q) for q in qs[1:4]])
        out["batch"][f"nq={nq}"] = {
            **summary_ms(lat), "launches": c,
            "certificate_held": f"{held} of 10 statements",
            "profile_3_statements": breakdown,
            "host_split_3_statements": split}

    # identical rows, built by DDL: the certificate cannot hold, K2 runs
    m = 1 << 16
    same = np.tile(rng.standard_normal((1, D), dtype=np.float32), (m, 1))
    s.create_table("src_same", {"id": np.arange(m, dtype=np.int64),
                                "emb": same,
                                "price": rng.integers(0, 100, m)
                                .astype(np.int32)})
    s.sql("CREATE TABLE same (id UInt32, emb Array(Float32), price Int32, "
          f"CONSTRAINT l CHECK length(emb) = {D}) ENGINE = MergeTree "
          "ORDER BY id")
    s.sql("INSERT INTO same SELECT id, emb, price FROM src_same")
    s.sql("DROP TABLE src_same")
    out["batch_same"] = {}
    zero_launches()
    for nq in NQ_BATCH_SAME:
        qs = rng.standard_normal((nq, D), dtype=np.float32)
        before = (segmin_sq8.launches, segmin_f32.launches)
        lat, rows, _ = timed_statements(s, [batch_sql("same", qs)])
        grew = (segmin_sq8.launches - before[0],
                segmin_f32.launches - before[1])
        if grew[1] < 1:
            raise AssertionError(f"identical rows nq={nq}: K2 did not "
                                 f"launch ({grew})")
        check_rows(s, "same", rows[0], qs, f"sql_ddl identical nq={nq}")
        out["batch_same"][f"nq={nq}"] = {"ms": lat[0], "sq8": grew[0],
                                         "f32": grew[1]}
    counts["sql_ddl_same"] = read_launches()
    s.sql("DROP TABLE same")

    # DELETE about 1% of the rows: the epoch moves, so the first query
    # after it rebuilds the sidecar; no deleted id may come back
    deleted = set(s.tables["tv"]["id"].data[
        s.tables["tv"]["price"].data == 7].cpu().tolist())
    s.sql("SET mutations_sync = 1")
    t0 = time.perf_counter()
    s.sql("DELETE FROM tv WHERE price = 7")
    torch.cuda.synchronize()
    delete_ms = (time.perf_counter() - t0) * 1e3
    q = rng.standard_normal((1, D), dtype=np.float32)
    lat, rows, _ = timed_statements(s, [stmt.format(q=vec_sql(q[0]))])
    check_rows(s, "tv", rows[0], q[0], "after DELETE")
    qb = rng.standard_normal((10, D), dtype=np.float32)
    _, brows, _ = timed_statements(s, [batch_sql("tv", qb)])
    check_rows(s, "tv", brows[0], qb, "batch after DELETE")
    back = {r[0] for r in rows[0] + brows[0]} & deleted
    if back or s.tables["tv"].n_rows != N - len(deleted):
        raise AssertionError(f"deleted ids came back: {sorted(back)[:5]}")
    out["delete"] = {"rows_deleted": len(deleted), "delete_ms": delete_ms,
                     "first_query_after_ms": lat[0]}

    s.sql("DETACH TABLE tv")
    s.sql("ATTACH TABLE tv")
    lat, again, _ = timed_statements(s, [stmt.format(q=vec_sql(q[0]))])
    if again[0] != rows[0]:
        raise AssertionError("rows changed across DETACH/ATTACH")
    out["after_attach_query_ms"] = lat[0]

    # an index build big enough for the background executor; the query
    # right after it either finds the build done or waits for it
    big = rng.standard_normal((N_BACKGROUND, D), dtype=np.float32)
    s.create_table("src_big", {"id": np.arange(N_BACKGROUND,
                                               dtype=np.int64),
                               "emb": big,
                               "price": rng.integers(0, 100, N_BACKGROUND)
                               .astype(np.int32)})
    del big
    s.sql("CREATE TABLE big (id UInt32, emb Array(Float32), price Int32, "
          f"CONSTRAINT l CHECK length(emb) = {D}) ENGINE = MergeTree "
          "ORDER BY id")
    s.sql("INSERT INTO big SELECT id, emb, price FROM src_big")
    s.sql("DROP TABLE src_big")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.sql("ALTER TABLE big ADD VECTOR INDEX vb emb TYPE MSTG")
    alter_ms = (time.perf_counter() - t0) * 1e3
    qg = rng.standard_normal((1, D), dtype=np.float32)
    t0 = time.perf_counter()
    grows = s.sql(stmt.format(q=vec_sql(qg[0])).replace("FROM tv",
                                                        "FROM big")).to_rows()
    first_ms = (time.perf_counter() - t0) * 1e3
    check_rows(s, "big", grows, qg[0], "query after the background build")
    if not default_executor().wait_idle(120):
        raise AssertionError("the background index build did not finish")
    bstatus = s.sql("SELECT status FROM system.vector_indices "
                    "WHERE table = 'big'").to_rows()
    if bstatus != [("Built",)]:
        raise AssertionError(f"background build status {bstatus}")
    out["background_build"] = {"rows": N_BACKGROUND, "alter_ms": alter_ms,
                               "first_query_ms": first_ms}

    for t in ("tv", "big"):
        s.sql(f"DROP TABLE {t}")
    if s.tables:
        raise AssertionError(f"tables left: {list(s.tables)}")
    del s
    torch.cuda.empty_cache()
    emit({"phase": "sql_ddl", "rows": N, "dim": D, "k": K, **out,
          "launches": counts,
          "oracle": "ids equal, distances rtol 2e-5, per query"})
    return counts


def phase_goldens_vector() -> int:
    """The 23 vector goldens through connect() on the card, each
    byte-identical to its .reference."""
    import os
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.testing import run_golden_text
    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "goldens", "vector")
    names = sorted(f[:-4] for f in os.listdir(gdir) if f.endswith(".sql"))
    t0 = time.perf_counter()
    bad = []
    for name in names:
        sql = open(os.path.join(gdir, name + ".sql")).read()
        want = open(os.path.join(gdir, name + ".reference")).read() \
            .rstrip("\n").split("\n")
        if want == [""]:
            want = []
        s = P.connect()
        if s.device.type != "cuda":
            raise AssertionError(f"connect() chose {s.device}")
        if run_golden_text(s, sql) != want:
            bad.append(name)
    emit({"phase": "goldens_vector", "cases": len(names),
          "identical": len(names) - len(bad), "differ": bad,
          "seconds": time.perf_counter() - t0})
    if bad or len(names) != 23:
        raise AssertionError(f"vector goldens: {len(names) - len(bad)} of "
                             f"{len(names)} identical; differ: {bad}")
    return len(names)


# BASELINE config 3 (bench.py:219-249): ORDER BY v DESC LIMIT 100 over 100M
# f32 rows; w is an Int32 column of heavy ties for the tie rule
N3, LIMIT3 = 100_000_000, 100
TOPN_STATEMENTS = {
    "v_desc": "SELECT id, v FROM t3 ORDER BY v DESC LIMIT 100",
    "v_asc": "SELECT id, v FROM t3 ORDER BY v ASC LIMIT 100",
    "w_desc": "SELECT id, w FROM t3 ORDER BY w DESC LIMIT 100",
    "id_read_in_order": "SELECT id FROM t3 ORDER BY id LIMIT 100",
}
# the host-resident session: every 400 MB column stays in host RAM
TOPN_HOST_BUDGET = 1 << 28
# windows: rows, partitions, v's range (peers tie), float tolerance (the
# port's f32 cumsum against an f64 oracle: rtol, or atol x the
# partition's sum of |f|)
NW, GW, VW = 10_000_000, 1000, 100
WINDOW_RTOL = 2e-5


def total_order(x: torch.Tensor) -> torch.Tensor:
    """int32 key ordering float32 values by the IEEE total order (NaN
    above +inf), written here apart from the port's encoding."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def stable_top(key: torch.Tensor, descending: bool, k: int):
    """The first k row ids of a stable full sort of ``key``: ties keep
    ascending row id in either direction."""
    return torch.sort(key, descending=descending, stable=True).indices[:k]


def timed_sql(s, stmt: str, reps: int):
    """Host-clock ms of ``Session.sql(stmt).to_rows()``, ``reps`` times
    after one warm-up, and the last run's rows."""
    s.sql(stmt).to_rows()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rows = s.sql(stmt).to_rows()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat, rows


def check_topn_rows(rows, want_ids, col, tag):
    ids = torch.as_tensor([r[0] for r in rows], device="cuda")
    if not torch.equal(ids, want_ids):
        raise AssertionError(f"{tag}: ids differ from the stable full sort")
    if col is not None:
        got = torch.as_tensor([r[1] for r in rows], dtype=col.dtype,
                              device="cuda")
        if not torch.equal(got, col[want_ids]):
            raise AssertionError(f"{tag}: values differ from the column's")


def phase_sql_topn(seed: int):
    """BASELINE config 3 at full size through SQL, the top-n prefilter's
    device time beside the full sort's and its byte bound, read-in-order
    and the host-resident (streaming) top-n."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.ops.sort import (SortKey, sort_permutation,
                                              topn_permutation)
    from myscaledb_tpu_torch.runtime import metrics as M

    rng = np.random.default_rng(seed + 7)
    t0 = time.perf_counter()
    data = {"id": np.arange(N3, dtype=np.uint32),
            "v": rng.standard_normal(N3, dtype=np.float32),
            "w": rng.integers(0, 1000, N3, dtype=np.int32)}
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = P.connect()
    s.create_table("t3", data)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    v = s.tables["t3"]["v"].data
    w = s.tables["t3"]["w"].data
    want = {"v_desc": stable_top(total_order(v), True, LIMIT3),
            "v_asc": stable_top(total_order(v), False, LIMIT3),
            "w_desc": stable_top(w, True, LIMIT3),
            "id_read_in_order": torch.arange(LIMIT3, device="cuda")}
    cols = {"v_desc": v, "v_asc": v, "w_desc": w, "id_read_in_order": None}

    # the main path's own run: counts zeroed just before, read just after
    zero_launches()
    stats, orders = {}, {}
    for name, stmt in TOPN_STATEMENTS.items():
        before = M.events_snapshot().get("ReadInOrderSorts", 0)
        lat, rows = timed_sql(s, stmt, 10)
        check_topn_rows(rows, want[name], cols[name], name)
        orders[name] = M.events_snapshot().get("ReadInOrderSorts", 0) - before
        stats[name] = summary_ms(lat)
    launches = read_launches()
    if orders["id_read_in_order"] != 11 or any(
            orders[k] for k in orders if k != "id_read_in_order"):
        raise AssertionError(f"ReadInOrderSorts moved by {orders}; want 11 "
                             "(one per statement) for ORDER BY id alone")
    breakdown = profile_statements(s, [TOPN_STATEMENTS["v_desc"]] * 3)

    # the prefilter alone (bench.py times topn_permutation), beside the
    # parent's path on the same column: a full sort, sliced
    timing = {}
    for name, key in (("v_desc", SortKey(v, False)),
                      ("v_asc", SortKey(v, True)),
                      ("w_desc", SortKey(w, False))):
        got = topn_permutation([key], LIMIT3, N3)
        if not torch.equal(got, want[name]):
            raise AssertionError(f"topn_permutation {name}: ids differ")
        full = sort_permutation([key])[:LIMIT3]
        if not torch.equal(full, want[name]):
            raise AssertionError(f"sort_permutation {name}: ids differ")
        timing[name] = {
            "topn_ms": time_ms(lambda: topn_permutation([key], LIMIT3, N3)),
            "full_sort_ms": time_ms(
                lambda: sort_permutation([key])[:LIMIT3], reps=5)}
    bound, bound_by = bound_ms(N3 * 4, 0, F32_FLOPS)
    del v, w
    s.tables.clear()
    torch.cuda.empty_cache()

    # the host-resident session: v streams through the card in
    # stream_chunk_rows chunks (StreamingTopN)
    h = P.connect()
    h.settings.max_hbm_bytes_per_column = TOPN_HOST_BUDGET
    h.create_table("t3", {"id": data["id"], "v": data["v"]})
    if not h.tables["t3"]["v"].is_host:
        raise AssertionError("v did not stay host-resident")
    before = M.events_snapshot().get("StreamingTopN", 0)
    lat, rows = timed_sql(h, TOPN_STATEMENTS["v_desc"], 5)
    streamed = M.events_snapshot().get("StreamingTopN", 0) - before
    # the same ids as the resident table's
    check_topn_rows(rows, want["v_desc"], None, "host-resident v_desc")
    if streamed != 6:
        raise AssertionError(f"StreamingTopN moved by {streamed}, want 6")
    stats["v_desc_host_resident"] = summary_ms(lat)

    median = stats["v_desc"]["median_ms"]
    emit({"phase": "sql_topn", "rows": N3, "limit": LIMIT3,
          "statements": TOPN_STATEMENTS, "gen_s": gen_s, "load_s": load_s,
          "latency": stats,
          "median_query_ms": median,
          "p90_query_ms": stats["v_desc"]["p90_ms"],
          "sql_rows_per_s": N3 / (median / 1e3),
          "topn_sort_rows_per_sec_per_chip":
              N3 / (timing["v_desc"]["topn_ms"] / 1e3),
          "device_ms": timing, "bound_ms": bound, "bound_by": bound_by,
          "read_in_order_sorts": orders,
          "streaming_topn": streamed,
          "stream_chunk_rows": h.settings.stream_chunk_rows,
          "launches": launches,
          "oracle": "ids equal a stable full sort of the total-order key "
                    "on the card, values equal the column's",
          "profile_3_queries": breakdown})
    h.tables.clear()
    torch.cuda.empty_cache()
    return launches


WINDOW_STATEMENTS = {
    "ranks": "SELECT id, row_number() OVER (PARTITION BY g ORDER BY v) AS a, "
             "rank() OVER (PARTITION BY g ORDER BY v) AS b, "
             "dense_rank() OVER (PARTITION BY g ORDER BY v) AS c FROM tw",
    "running": "SELECT id, sum(v) OVER (PARTITION BY g ORDER BY v) AS a, "
               "avg(f) OVER (PARTITION BY g ORDER BY v) AS b FROM tw",
    "whole": "SELECT id, sum(v) OVER (PARTITION BY g) AS a, "
             "max(f) OVER (PARTITION BY g) AS b FROM tw",
    "shift": "SELECT id, lag(v, 1) OVER (PARTITION BY g ORDER BY id) AS a, "
             "lead(v, 2, 0) OVER (PARTITION BY g ORDER BY id) AS b FROM tw",
    "ntile": "SELECT id, ntile(4) OVER (PARTITION BY g ORDER BY v) AS a "
             "FROM tw",
}


def window_oracle(g, v, f):
    """Every window column of WINDOW_STATEMENTS on the card, from one
    stable sort by (g, v) and one by g, searchsorted group and peer edges
    and f64 prefix sums: a construction apart from the port's."""
    n = g.shape[0]
    dev = g.device
    rows = torch.arange(n, device=dev)
    gv = g.long() * (1 << 32) + v.long()
    p = torch.sort(gv, stable=True).indices        # (g, v, id) order
    gs, ks = g[p].long(), gv[p]
    g_start = torch.searchsorted(gs, gs, right=False)
    g_end = torch.searchsorted(gs, gs, right=True) - 1
    peer_start = torch.searchsorted(ks, ks, right=False)
    peer_end = torch.searchsorted(ks, ks, right=True) - 1
    _, distinct = torch.unique_consecutive(ks, return_inverse=True)
    out = {}

    def unsort(x):
        o = torch.empty_like(x)
        o[p] = x
        return o
    out["ranks"] = {"a": unsort(rows - g_start + 1),
                    "b": unsort(peer_start - g_start + 1),
                    "c": unsort(distinct - distinct[g_start] + 1)}
    cv = torch.cumsum(v[p].long(), 0)
    cf = torch.cumsum(f[p].double(), 0)
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    base_v = torch.where(g_start > 0, cv[(g_start - 1).clamp(min=0)], 0)
    base_f = torch.where(g_start > 0, cf[(g_start - 1).clamp(min=0)], zero)
    cnt = (peer_end - g_start + 1).double()
    out["running"] = {"a": unsort(cv[peer_end] - base_v),
                      "b": unsort((cf[peer_end] - base_f) / cnt)}
    sums = torch.zeros(GW, dtype=torch.int64, device=dev).index_add_(
        0, g.long(), v.long())
    maxs = torch.full((GW,), -torch.inf, device=dev).scatter_reduce_(
        0, g.long(), f, "amax")
    out["whole"] = {"a": sums[g.long()], "b": maxs[g.long()]}
    q = torch.sort(g, stable=True).indices          # (g, id) order
    gq, vq = g[q], v[q]
    prev_ok = torch.zeros(n, dtype=torch.bool, device=dev)
    prev_ok[1:] = gq[1:] == gq[:-1]
    prev = torch.zeros_like(vq)
    prev[1:] = vq[:-1]
    nxt = torch.zeros_like(vq)
    nxt[:-2] = torch.where(gq[2:] == gq[:-2], vq[2:], 0)
    lag_ok = torch.empty_like(prev_ok)
    lag_ok[q] = prev_ok
    lag = torch.empty_like(prev)
    lag[q] = prev
    lead = torch.empty_like(nxt)
    lead[q] = nxt
    out["shift"] = {"a": (lag, lag_ok), "b": lead}
    out["ntile"] = {"a": unsort((rows - g_start) * 4
                                // (g_end - g_start + 1) + 1)}
    abs_sum = torch.zeros(GW, dtype=torch.float64, device=dev).index_add_(
        0, g.long(), f.double().abs())
    # an average's atol is its sum's over the frame's row count
    avg_atol = 2e-5 * abs_sum[g.long()] / unsort(cnt)
    return out, avg_atol


def check_window(res, want, avg_atol, name):
    for col, w in want.items():
        c = res[col]
        if name == "shift" and col == "a":
            w, ok = w
            if not torch.equal(c.valid, ok):
                raise AssertionError("lag: NULLs differ from the oracle")
            if not torch.equal(c.data[ok].long(), w[ok].long()):
                raise AssertionError("lag: values differ from the oracle")
            continue
        if c.valid is not None and not bool(c.valid.all()):
            raise AssertionError(f"{name}.{col}: unexpected NULLs")
        if name == "running" and col == "b":
            err = (c.data.double() - w).abs()
            tol = torch.maximum(WINDOW_RTOL * w.abs(), avg_atol)
            if not bool((err <= tol).all()):
                raise AssertionError(f"avg(f): error {float(err.max())} "
                                     "past rtol 2e-5 / atol 2e-5 x sum|f|")
        elif not torch.equal(c.data.to(w.dtype), w):
            raise AssertionError(f"{name}.{col}: differs from the oracle")


def phase_sql_window(seed: int):
    """Window functions over 10M rows and 1000 partitions through SQL;
    every result column checked against window_oracle on the card."""
    import myscaledb_tpu_torch as P

    rng = np.random.default_rng(seed + 8)
    s = P.connect()
    s.create_table("tw", {
        "id": np.arange(NW, dtype=np.int64),
        "g": rng.integers(0, GW, NW, dtype=np.int32),
        "v": rng.integers(0, VW, NW, dtype=np.int32),
        "f": rng.standard_normal(NW, dtype=np.float32)})
    t = s.tables["tw"]
    want, avg_atol = window_oracle(t["g"].data, t["v"].data, t["f"].data)
    zero_launches()
    stats = {}
    for name, stmt in WINDOW_STATEMENTS.items():
        s.sql(stmt)                                   # warm-up
        lat = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = s.sql(stmt)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(res["id"].data, t["id"].data):
            raise AssertionError(f"{name}: rows not in table order")
        check_window(res, want[name], avg_atol, name)
        stats[name] = summary_ms(lat)
    launches = read_launches()
    breakdown = profile_statements(s, list(WINDOW_STATEMENTS.values()),
                                   to_rows=False)
    emit({"phase": "sql_window", "rows": NW, "partitions": GW,
          "v_range": VW, "statements": WINDOW_STATEMENTS,
          "latency": stats, "launches": launches,
          "profile_5_statements": breakdown,
          "oracle": "integers equal; avg(f) within rtol 2e-5 of an f64 "
                    "oracle or atol 2e-5 x the partition's sum |f| over "
                    "the frame's rows"})
    s.tables.clear()
    torch.cuda.empty_cache()
    return launches


# ClickBench's hits table (github.com/ClickHouse/ClickBench,
# clickhouse/create.sql; 99,997,497 rows), with the columns the sql_hits
# statements read, at 100M rows made on the card from --seed
NH = 100_000_000
NH_USERS = 17_600_000            # about ClickBench's distinct UserIDs
NH_REGIONS = 9_040
NH_STRINGS = 1 << 17             # distinct URL / SearchPhrase values (cut)
JULY_2013 = 1_372_636_800        # 2013-07-01 00:00:00 UTC
HITS_STATEMENTS = {
    "distinct_users": "SELECT count(DISTINCT UserID) FROM hits",
    "distinct_phrases": "SELECT count(DISTINCT SearchPhrase) FROM hits",
    "date_range": "SELECT min(EventDate), max(EventDate) FROM hits",
    "region_users": "SELECT RegionID, count(DISTINCT UserID) AS u FROM hits "
                    "GROUP BY RegionID ORDER BY u DESC LIMIT 10",
    "url_like": "SELECT count() FROM hits WHERE URL LIKE '%google%'",
    "minute_views": "SELECT toStartOfMinute(EventTime) AS M, count() AS "
                    "PageViews FROM hits WHERE CounterID = 62 AND EventDate "
                    ">= '2013-07-14' AND EventDate <= '2013-07-15' AND "
                    "IsRefresh = 0 AND DontCountHits = 0 GROUP BY M ORDER "
                    "BY M LIMIT 10 OFFSET 1000",
    "hour_sketches": "SELECT toHour(EventTime) AS h, count(), uniq(UserID), "
                     "uniqCombined(UserID), quantile(0.9)(ResolutionWidth) "
                     "FROM hits GROUP BY h ORDER BY h",
}
HITS_HOSTS = ("www.google.com", "yandex.ru", "mail.ru", "google.ru",
              "vk.com", "news.example.org", "shop.example.com",
              "m.auto.ru", "forum.example.net", "www.avito.ru", "ok.ru",
              "docs.google.com", "images.example.com", "kinopoisk.ru",
              "video.example.tv", "wiki.example.org")
HITS_WORDS = ("weather", "news", "auto", "cheap", "flights", "moscow",
              "football", "recipes", "music", "download", "free", "online",
              "games", "maps", "train", "hotel")
# uniqCombined's HLL (2^12 registers) is within 1.6% at one standard error
HITS_SKETCH_RTOL = 0.05


def hits_table(seed: int):
    """The hits table on the card: every column drawn from one generator,
    the String columns as int32 codes into dictionaries of 2^17 values
    (no per-row Python)."""
    from myscaledb_tpu_torch.core.dictionary import StringDictionary
    from myscaledb_tpu_torch.core.table import Column, Table
    from myscaledb_tpu_torch.core.types import DataType, Field
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)

    def u():
        # f64: with f32's 24 bits, u^2 * NH_USERS would skip every other
        # user index near the top of the range
        return torch.rand(NH, generator=gen, device="cuda",
                          dtype=torch.float64)

    def ints(lo, hi):
        return torch.randint(lo, hi, (NH,), generator=gen, device="cuda")

    user_idx = (u() ** 2 * NH_USERS).long()      # skewed to small indexes
    mix = user_idx * -0x61C8864680B583EB + 0x632BE59BD9B4E019   # odd
    user_id = (mix ^ (mix >> 29)) & ((1 << 62) - 1)
    event_time = JULY_2013 + ints(0, 31 * 86400)
    counter = torch.where(u() < 0.3, 62,
                          (u() ** 3 * 7000).long() + 1).to(torch.int32)
    region = (u() ** 2 * NH_REGIONS).to(torch.int32)
    adv = torch.where(u() < 0.97, 0, ints(1, 60)).to(torch.int16)
    width = ints(320, 2561).to(torch.int16)
    refresh = (u() < 0.1).to(torch.int16)
    dont_count = (u() < 0.05).to(torch.int16)
    url_codes = (u() ** 3 * NH_STRINGS).to(torch.int32)
    phrase_codes = torch.where(u() < 0.8, 0, (u() ** 2 * (NH_STRINGS - 1))
                               .long() + 1).to(torch.int32)
    urls = [f"http://{HITS_HOSTS[i % len(HITS_HOSTS)]}/page/{i}"
            f"?id={i * 7919 % 100003}" for i in range(NH_STRINGS)]
    phrases = [""] + [f"{HITS_WORDS[i % 16]} {HITS_WORDS[i // 16 % 16]} {i}"
                      for i in range(1, NH_STRINGS)]

    def col(name, dt, data, dictionary=None):
        return Column(Field(name, dt), data, None, dictionary)
    cols = [col("UserID", DataType.INT64, user_id),
            col("EventTime", DataType.DATETIME, event_time),
            col("EventDate", DataType.DATE,
                (event_time // 86400).to(torch.int32)),
            col("CounterID", DataType.INT32, counter),
            col("RegionID", DataType.INT32, region),
            col("AdvEngineID", DataType.INT16, adv),
            col("ResolutionWidth", DataType.INT16, width),
            col("IsRefresh", DataType.INT16, refresh),
            col("DontCountHits", DataType.INT16, dont_count),
            col("URL", DataType.STRING, url_codes, StringDictionary(urls)),
            col("SearchPhrase", DataType.STRING, phrase_codes,
                StringDictionary(phrases))]
    return Table(cols, name="hits"), urls


def hits_oracles(t, urls):
    """Every statement's rows from plain torch on the card: torch.unique
    counts, the LIKE pattern matched in Python over the dictionary then
    looked up by code, minute buckets by integer division and the
    inverted-CDF element of a sort."""
    import datetime as _dt
    uid = t["UserID"].data
    et = t["EventTime"].data
    ed = t["EventDate"].data
    region = t["RegionID"].data.long()
    _, uinv = torch.unique(uid, return_inverse=True)
    nu = int(uinv.max()) + 1
    want = {"distinct_users": [(nu,)],
            "distinct_phrases": [(int(torch.unique(
                t["SearchPhrase"].data).numel()),)]}
    epoch = _dt.date(1970, 1, 1)
    want["date_range"] = [(epoch + _dt.timedelta(days=int(ed.min())),
                           epoch + _dt.timedelta(days=int(ed.max())))]
    pairs = torch.unique(region * nu + uinv)
    per_region = torch.bincount(pairs // nu, minlength=NH_REGIONS)
    present = torch.nonzero(per_region > 0).flatten()
    order = torch.sort(-per_region[present], stable=True).indices[:10]
    want["region_users"] = [(int(present[i]), int(per_region[present[i]]))
                            for i in order.tolist()]
    lut = torch.tensor(["google" in s for s in urls], device="cuda")
    want["url_like"] = [(int(lut[t["URL"].data.long()].sum()),)]
    d14 = (_dt.date(2013, 7, 14) - epoch).days
    keep = ((t["CounterID"].data == 62) & (ed >= d14) & (ed <= d14 + 1)
            & (t["IsRefresh"].data == 0) & (t["DontCountHits"].data == 0))
    minutes, views = torch.unique(et[keep] // 60 * 60, return_counts=True)
    base = _dt.datetime(1970, 1, 1)
    want["minute_views"] = [(base + _dt.timedelta(seconds=int(m)), int(c))
                            for m, c in zip(minutes[1000:1010].tolist(),
                                            views[1000:1010].tolist())]
    hour = et % 86400 // 3600
    count = torch.bincount(hour, minlength=24)
    users = torch.bincount(torch.unique(hour * nu + uinv) // nu,
                           minlength=24)
    packed = torch.sort(hour * 65536 + t["ResolutionWidth"].data.long()
                        + 32768).values
    start = torch.cumsum(count, 0) - count
    q90 = []
    for h in range(24):
        n_h = int(count[h])
        tq = n_h * 0.9 - 1.0          # np.quantile's inverted_cdf index
        j = int(np.floor(tq)) + (1 if tq - np.floor(tq) > 0 else 0)
        j = min(max(j, 0), n_h - 1)
        q90.append(float(int(packed[int(start[h]) + j]) % 65536 - 32768))
    want["hour_sketches"] = [(h, int(count[h]), int(users[h]), None, q90[h])
                             for h in range(24)]
    return want


def check_hits_rows(name, rows, want):
    if name != "hour_sketches":
        if rows != want:
            raise AssertionError(f"sql_hits {name}: {rows[:3]} != oracle "
                                 f"{want[:3]}")
        return
    if [(h, c, u, q) for h, c, u, _, q in rows] != \
            [(h, c, u, q) for h, c, u, _, q in want]:
        raise AssertionError(f"sql_hits {name}: rows differ from the oracle")
    for h, _c, u, est, _q in rows:
        if abs(est - u) > HITS_SKETCH_RTOL * u:
            raise AssertionError(f"sql_hits {name}: hour {h} uniqCombined "
                                 f"{est} vs exact {u}")


def run_statements_checked(s, statements, want, tag):
    """Each statement ten times after a warm-up (median, p90), its rows
    against the oracle's, then a profiler pass (device busy share) and a
    count of its host synchronisations; the kernel launches of its timed
    runs, zeroed just before and read just after."""
    smi = nvidia_smi_line()
    stats, totals = {}, {}
    for name, stmt in statements.items():
        zero_launches()
        lat, rows = timed_sql(s, stmt, 10)
        launches = read_launches()
        check = want[name]
        if callable(check):
            check(rows)
        elif rows != check:
            raise AssertionError(f"{tag} {name}: {rows[:3]} != oracle "
                                 f"{check[:3]}")
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
        prof = profile_statements(s, [stmt])
        syncs, sites = count_host_syncs(lambda: s.sql(stmt).to_rows())
        torch.cuda.reset_peak_memory_stats()
        s.sql(stmt).to_rows()
        stats[name] = {"median_ms": float(np.median(lat)),
                       "p90_ms": float(np.percentile(lat, 90)),
                       "device_busy_share": prof["device_busy_share"],
                       "device_ms_per_query": prof["device_ms_per_query"],
                       "top_kernels_us": prof["top_kernels_us_per_query"],
                       "host_syncs": syncs, "host_sync_sites": sites,
                       "max_memory_allocated_bytes":
                           torch.cuda.max_memory_allocated(),
                       "launches_by_path": launches,
                       "first_rows": repr(rows[:3]), "nvidia_smi": smi}
    return stats, totals


def phase_sql_hits(seed: int):
    """ClickBench-shaped statements over the 100M-row hits table: each
    statement's rows against its oracle on the card, ten timed runs after
    a warm-up (median and p90, rows/s), a profiler pass, its host
    synchronisations and the kernel launches of its runs."""
    import myscaledb_tpu_torch as P
    t0 = time.perf_counter()
    table, urls = hits_table(seed)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    s = P.connect()
    s.settings.max_memory_bytes_per_query = 32 << 30
    s.register("hits", table)
    want = hits_oracles(table, urls)
    checks = {name: (lambda rows, n=name: check_hits_rows(n, rows, want[n]))
              for name in HITS_STATEMENTS}
    stats, totals = run_statements_checked(s, HITS_STATEMENTS, checks,
                                           "sql_hits")
    for st in stats.values():
        st["rows_per_s"] = NH / (st["median_ms"] / 1e3)
    if stats["hour_sketches"]["launches_by_path"]["group_aggregate"] < 1:
        raise AssertionError("sql_hits: the count() beside the special "
                             "aggregates did not launch group_aggregate")
    emit({"phase": "sql_hits", "rows": NH, "table_gen_s": gen_s,
          "source": "ClickBench hits (clickhouse/create.sql, queries.sql)",
          "reduced": ["URL and SearchPhrase have 2^17 distinct values, not "
                      "ClickBench's ~18M and ~6M (the dictionary encoder "
                      "has no native path yet)",
                      "only the columns the statements read"],
          "statements": HITS_STATEMENTS, "per_statement": stats,
          "launches": totals,
          "oracle": "rows equal to plain torch on the card; uniqCombined "
                    f"within {HITS_SKETCH_RTOL} of the exact count"})
    s.tables.clear()
    del table
    torch.cuda.empty_cache()
    return totals


# the event table of sql_arrays: URLCategories Array(UInt16) of
# ClickHouse's hits_v1 example dataset in shape, at 100M rows
NA = 100_000_000
NA_VALUES = 256                  # category ids: one K3 group each
ARRAY_STATEMENTS = {
    "array_join_groupby": "SELECT c, count() FROM ev ARRAY JOIN cats AS c "
                          "GROUP BY c ORDER BY count() DESC LIMIT 10",
    "left_array_join_count": "SELECT count() FROM ev LEFT ARRAY JOIN "
                             "cats AS c",
    "has": "SELECT count() FROM ev WHERE has(cats, 7)",
    "array_sum_map": "SELECT sum(arraySum(arrayMap(x -> x * 2, cats))) "
                     "FROM ev",
    "filter_length": "SELECT count() FROM ev WHERE length(arrayFilter("
                     "x -> x < 16, cats)) > 0",
}


def events_table(seed: int):
    """ev (id UInt32, cats Array(UInt16)) made on the card: lengths
    uniform in 0..8, values in [0, 256) drawn skewed to small ids.  The
    Column keeps host offsets (the layout's); their device copy is the one
    cumsum made here."""
    from myscaledb_tpu_torch.core.table import Column, Table
    from myscaledb_tpu_torch.core.types import DataType, Field
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    lens = torch.randint(0, 9, (NA,), generator=gen, device="cuda")
    doff = torch.zeros(NA + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(lens, 0, out=doff[1:])
    total = int(doff[-1])
    u = torch.rand(total, generator=gen, device="cuda")
    cats = (u * u * NA_VALUES).to(torch.int32)
    ids = torch.arange(NA, device="cuda")
    cols = [Column(Field("id", DataType.UINT32), ids),
            Column(Field("cats", DataType.ARRAY, elem=DataType.UINT16),
                   cats, None, None, None, doff.cpu().numpy())]
    return Table(cols, name="ev"), doff


def arrays_oracles(flat, doff):
    """Every statement's rows from plain torch on the card: a bincount of
    the flat values, the row lengths, exact int64 sums, and per-row hits
    through row ids from searchsorted over the offsets."""
    lens = doff[1:] - doff[:-1]
    counts = torch.bincount(flat.long(), minlength=NA_VALUES)
    order = torch.sort(-counts, stable=True).indices[:10]
    rid = torch.searchsorted(doff[1:], torch.arange(flat.numel(),
                                                    device="cuda"),
                             right=True)

    def rows_with(hit):
        per_row = torch.zeros(NA, dtype=torch.int64, device="cuda")
        per_row.index_add_(0, rid[hit], torch.ones_like(rid[hit]))
        return int((per_row > 0).sum())
    want = {"array_join_groupby": [(int(c), int(counts[c]))
                                   for c in order.tolist()],
            "left_array_join_count": [(int(torch.clamp(lens, min=1)
                                           .sum()),)],
            "has": [(rows_with(flat == 7),)],
            "array_sum_map": [(2 * int(flat.sum(dtype=torch.int64)),)],
            "filter_length": [(rows_with(flat < 16),)]}
    del rid
    return want


def phase_sql_arrays(seed: int):
    """The event table at 100M rows (about 400M elements): ARRAY JOIN with
    GROUP BY (K3), LEFT ARRAY JOIN, has(), arraySum over arrayMap and a
    filter on arrayFilter's length, each checked against plain torch on
    the card."""
    import myscaledb_tpu_torch as P
    t0 = time.perf_counter()
    table, doff = events_table(seed)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    s = P.connect()
    s.settings.max_memory_bytes_per_query = 32 << 30
    s.register("ev", table)
    flat = table["cats"].data
    want = arrays_oracles(flat, doff)
    elements = int(doff[-1])
    del doff
    stats, totals = run_statements_checked(s, ARRAY_STATEMENTS, want,
                                           "sql_arrays")
    if stats["array_join_groupby"]["launches_by_path"]["group_aggregate"] \
            < 1:
        raise AssertionError("sql_arrays: ARRAY JOIN ... GROUP BY did not "
                             "launch group_aggregate")
    for st in stats.values():
        st["rows_per_s"] = NA / (st["median_ms"] / 1e3)
        st["elements_per_s"] = elements / (st["median_ms"] / 1e3)
    emit({"phase": "sql_arrays", "rows": NA, "elements": elements,
          "table_gen_s": gen_s,
          "source": "URLCategories Array(UInt16) of ClickHouse's hits_v1 "
                    "example dataset (docs: getting-started/example-"
                    "datasets/metrica)",
          "statements": ARRAY_STATEMENTS, "per_statement": stats,
          "launches": totals,
          "oracle": "rows equal to plain torch on the card (bincount, row "
                    "lengths, int64 sums, searchsorted row ids)"})
    s.tables.clear()
    del table, flat
    torch.cuda.empty_cache()
    return totals


NQ_META = 16                     # meta.cat in [0, 16)


def phase_sql_subquery(seed: int):
    """Config 1 (1M x 128, price) with a metadata table meta (id UInt32,
    cat UInt16): query by example, a metadata filter through IN, the top
    1000 joined to meta and grouped, a CTE, UNION ALL of two top-10s and
    INTERSECT/EXCEPT of two 1M-row sides, each checked against an oracle
    on the card."""
    import myscaledb_tpu_torch as P
    rng = np.random.default_rng(seed + 11)
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    meta = {"id": rng.permutation(N).astype(np.uint32),
            "cat": rng.integers(0, NQ_META, N).astype(np.uint16)}
    s = P.connect()
    s.create_table("t", data)
    s.create_table("meta", meta)
    x = s.tables["t"]["emb"].data
    price = s.tables["t"]["price"].data
    mid = s.tables["meta"]["id"].data
    mcat = s.tables["meta"]["cat"].data
    cat_of = torch.empty(N, dtype=torch.int64, device="cuda")
    cat_of[mid.long()] = mcat.long()
    qs = rng.standard_normal((2, D), dtype=np.float32)
    q0 = torch.as_tensor(qs[0], device="cuda")
    ex = 4242
    q_lit = vec_sql(data["emb"][ex])
    s.sql(f"SELECT id FROM t ORDER BY distance(emb, {q_lit}) LIMIT 1")

    def top(q, keep, k):
        dist = ((x - q[None, :]) ** 2).sum(1)
        dist = torch.where(keep, dist, torch.inf)
        ids = torch.sort(dist, stable=True).indices[:k]
        return ids, dist[ids]

    def ids_rows(want_ids, col=0):
        def check(rows):
            got = [r[col] for r in rows]
            if got != want_ids.tolist():
                raise AssertionError(f"sql_subquery: ids {got[:5]} != "
                                     f"oracle {want_ids[:5].tolist()}")
        return check

    statements = {
        "by_example": "SELECT id, distance(emb, (SELECT emb FROM t WHERE "
                      f"id = {ex})) AS d FROM t WHERE price < 50 "
                      "ORDER BY d LIMIT 10",
        "in_metadata": f"SELECT id, distance(emb, {vec_sql(qs[0])}) AS d "
                       "FROM t WHERE id IN (SELECT id FROM meta WHERE "
                       "cat = 3) ORDER BY d LIMIT 10",
        "facets": "SELECT m.cat, count(), min(c.d) FROM (SELECT id, "
                  f"distance(emb, {vec_sql(qs[0])}) AS d FROM t ORDER BY d "
                  "LIMIT 1000) AS c INNER JOIN meta AS m ON c.id = m.id "
                  "GROUP BY m.cat ORDER BY m.cat",
        "cte_top100": "WITH top AS (SELECT id, distance(emb, "
                      f"{vec_sql(qs[1])}) AS d FROM t WHERE price < 50 "
                      "ORDER BY d LIMIT 100) SELECT count(), sum(id) FROM "
                      "top",
        "union_all": f"SELECT id, distance(emb, {vec_sql(qs[0])}) AS d "
                     "FROM t WHERE price < 50 ORDER BY d LIMIT 10 UNION ALL "
                     f"SELECT id, distance(emb, {vec_sql(qs[1])}) AS d "
                     "FROM t WHERE price >= 50 ORDER BY d LIMIT 10",
        "intersect": "SELECT id FROM t WHERE price < 50 INTERSECT "
                     "SELECT id FROM meta WHERE cat < 8",
        "except": "SELECT id FROM t WHERE price < 50 EXCEPT "
                  "SELECT id FROM meta WHERE cat < 8",
    }
    cheap = price < 50
    want = {}
    literal_rows = s.sql(statements["by_example"].replace(
        f"(SELECT emb FROM t WHERE id = {ex})", q_lit)).to_rows()
    ex_ids, _ = top(x[ex], cheap, K)
    if [r[0] for r in literal_rows] != ex_ids.tolist():
        raise AssertionError("sql_subquery: the literal vector's ids differ "
                             "from the oracle's")

    def same_as_literal(rows):
        if rows != literal_rows:
            raise AssertionError("sql_subquery by_example: rows differ from "
                                 "the statement with the literal vector")
    want["by_example"] = same_as_literal
    want["in_metadata"] = ids_rows(top(q0, cat_of == 3, K)[0])
    f_ids, f_d = top(q0, torch.ones_like(cheap), 1000)
    f_cat = cat_of[f_ids]
    f_cnt = torch.bincount(f_cat, minlength=NQ_META)
    f_min = torch.full((NQ_META,), torch.inf, device="cuda").scatter_reduce(
        0, f_cat, f_d, "amin")

    def facets(rows):
        present = torch.nonzero(f_cnt).flatten().tolist()
        if [r[0] for r in rows] != present:
            raise AssertionError("sql_subquery facets: groups differ")
        for c, n, dmin in rows:
            if n != int(f_cnt[c]):
                raise AssertionError(f"sql_subquery facets: cat {c} count")
            np.testing.assert_allclose(dmin, float(f_min[c]), rtol=SQL_RTOL)
    want["facets"] = facets
    c_ids, _ = top(torch.as_tensor(qs[1], device="cuda"), cheap, 100)
    want["cte_top100"] = [(100, int(c_ids.sum()))]
    u_ids = torch.cat([top(q0, cheap, K)[0],
                       top(torch.as_tensor(qs[1], device="cuda"), ~cheap,
                           K)[0]])
    want["union_all"] = ids_rows(u_ids)
    left = torch.nonzero(cheap).flatten()
    right = mid[mcat < 8].long()
    member = torch.isin(left, right)
    want["intersect"] = [(i,) for i in left[member].tolist()]
    want["except"] = [(i,) for i in left[~member].tolist()]
    stats, totals = run_statements_checked(s, statements, want,
                                           "sql_subquery")
    for name in ("by_example", "in_metadata", "facets", "cte_top100",
                 "union_all"):
        if stats[name]["launches_by_path"]["segmin_sq8"] < 1:
            raise AssertionError(f"sql_subquery {name}: segmin_sq8 did not "
                                 "launch")
    if stats["facets"]["launches_by_path"]["group_aggregate"] < 1:
        raise AssertionError("sql_subquery facets: group_aggregate did not "
                             "launch")
    emit({"phase": "sql_subquery", "rows": N, "dim": D, "meta_rows": N,
          "statements": {k: v.replace(vec_sql(qs[0]), "[q0]")
                         .replace(vec_sql(qs[1]), "[q1]")
                         for k, v in statements.items()},
          "per_statement": stats, "launches": totals,
          "oracle": "ids equal to a direct-formula L2 top-k on the card "
                    "(ties by id), by_example equal to the literal vector's "
                    "rows, facet counts equal and min(d) within rtol 2e-5, "
                    "INTERSECT/EXCEPT equal to torch.isin over the sides"})
    s.tables.clear()
    torch.cuda.empty_cache()
    return totals


# phase sql_text: the MS MARCO passage corpus in shape (BEIR, Thakur et
# al. 2021: 8,841,823 passages, mean 55.98 words), cut to 1M passages
NT, NT_WORDS, DT = 1_000_000, 1 << 20, 768
NT_MEAN_WORDS, NT_SIGMA, NT_MAX_WORDS = 56, 0.5, 256
NT_QUERIES, KT = 20, 10
BM25_K1, BM25_B = 1.2, 0.75
# BM25 against the f64 oracle: the port scores in f32 (doc lengths over
# the f32 mean, f32 products and divisions, f32 sums over at most six
# terms), a few f32 ulps of each score
TEXT_RTOL = 1e-5
# fused scores live in [0, 1]: RSF normalizes distances of ~1.5e3 whose
# K2 error is ~1e-3 over a top-30 range of ~1e2, and BM25 scores at
# TEXT_RTOL, so the fused score moves by ~1e-5; RRF sums exact ranks
FUSION_ATOL = {"RSF": 1e-4, "RRF": 1e-7}


def text_corpus(seed: int, n: int = NT):
    """The passage table's data (``n`` passages), made on the card from
    ``seed``: 2^20
    distinct lowercase words of 3-12 letters (a word's letters are the
    base-26 digits of a distinct code, so no two words are equal), Zipf
    (s = 1.0) word draws, lognormal passage lengths of mean 56 clipped to
    [1, 256].  Returns the passages as Python strings, each token's
    (passage, word) pair on the card, the word table and the Zipf CDF."""
    g = torch.Generator(device="cuda").manual_seed(seed + 10)
    dev = "cuda"
    code = torch.randperm(NT_WORDS, generator=g, device=dev)
    need = torch.where(code < 26 ** 3, 3, torch.where(code < 26 ** 4, 4, 5))
    wlen = torch.maximum(torch.randint(3, 13, (NT_WORDS,), generator=g,
                                       device=dev), need)
    pos = torch.arange(13, device=dev)
    digit = (wlen[:, None] - 1 - pos[None, :]).clamp(min=0)
    letters = (code[:, None] // (26 ** digit.clamp(max=4))) % 26
    letters = torch.where(digit > 4, 0, letters)
    table = torch.where(pos[None, :] < wlen[:, None], 97 + letters,
                        torch.where(pos[None, :] == wlen[:, None], 32, 0)
                        ).to(torch.uint8)
    ranks = torch.arange(1, NT_WORDS + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(1.0 / ranks, 0)
    cdf /= cdf[-1].clone()
    mu = np.log(NT_MEAN_WORDS) - NT_SIGMA ** 2 / 2
    lens = torch.exp(mu + NT_SIGMA * torch.randn(
        n, generator=g, device=dev, dtype=torch.float64))
    lens = lens.round().clamp(1, NT_MAX_WORDS).to(torch.int64)
    total = int(lens.sum())
    u = torch.rand(total, generator=g, device=dev, dtype=torch.float64)
    word = torch.searchsorted(cdf, u).clamp(max=NT_WORDS - 1)
    del u
    doc = torch.repeat_interleave(torch.arange(n, device=dev), lens,
                                  output_size=total)
    # each token's letters and one space: (tokens, 13) masked to the row
    tw = wlen[word]
    flat = table[word][pos[None, :] <= tw[:, None]].cpu().numpy()
    nbytes = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, doc, tw + 1)
    ends = torch.cumsum(nbytes, 0).cpu().numpy()
    text = flat.tobytes().decode("ascii")
    del flat
    starts = np.concatenate([[0], ends[:-1]])
    passages = [text[a:b - 1] for a, b in zip(starts.tolist(),
                                              ends.tolist())]
    return (passages, doc.to(torch.int32), word.to(torch.int32), table,
            wlen, cdf, g)


def word_strings(table, wlen, ids) -> list:
    rows = table[ids].cpu().numpy()
    lens = wlen[ids].cpu().numpy()
    return [bytes(r[:n]).decode() for r, n in zip(rows, lens)]


def bm25_oracle(tok_doc, tok_word, doc_len, avg, terms, mask, operator):
    """Dense f64 BM25 (tantivy/Lucene, k1 = 1.2, b = 0.75) of the unique
    query ``terms`` (word ids) from the generator's own (passage, word)
    pairs: tf by bincount of the passages a word's tokens fall in, df the
    passages with tf > 0.  Masked-out passages score 0."""
    score = torch.zeros(NT, dtype=torch.float64, device="cuda")
    hits = torch.zeros(NT, dtype=torch.int32, device="cuda")
    norm = BM25_K1 * (1 - BM25_B + BM25_B * doc_len / avg)
    for t in terms:
        tf = torch.bincount(tok_doc[tok_word == t].to(torch.int64),
                            minlength=NT).double()
        has = tf > 0
        df = int(has.sum())
        if df == 0:
            continue
        idf = float(np.log(1 + (NT - df + 0.5) / (df + 0.5)))
        score += torch.where(has, idf * tf * (BM25_K1 + 1) / (tf + norm),
                             0.0)
        hits += has.to(torch.int32)
    if operator == "AND":
        score = torch.where(hits == len(terms), score, 0.0)
    if mask is not None:
        score = torch.where(mask, score, 0.0)
    return score


def ranked_oracle(dense, k: int, descending: bool):
    """The oracle's top-k (ids, values) of a dense f64 score, ties by id;
    for descending scores only positive ones rank, for ascending ones
    only finite ones."""
    ok = dense > 0 if descending else torch.isfinite(dense)
    key = torch.where(ok, -dense if descending else dense, torch.inf)
    order = torch.sort(key, stable=True).indices[:k]
    order = order[ok[order]]
    return order.cpu().numpy(), dense[order].cpu().numpy()


def check_ranked(tag, ids, vals, dense, k, descending, rtol, atol=0.0):
    """``ids``/``vals`` are a valid top-k of ``dense`` within the
    tolerance: as many as the oracle's, distinct, each id's oracle value
    within tolerance of the oracle's value at that rank and of the value
    the port printed (so ids are equal wherever the gap at a rank exceeds
    the tolerance)."""
    o_ids, o_vals = ranked_oracle(dense, k, descending)
    ids = np.asarray(ids, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if len(ids) != len(o_ids) or len(set(ids.tolist())) != len(ids):
        raise AssertionError(f"{tag}: {len(ids)} ids, the oracle "
                             f"{len(o_ids)}: {ids[:5]} vs {o_ids[:5]}")
    if len(ids) == 0:
        return 0.0
    true = dense[torch.as_tensor(ids, device="cuda")].cpu().numpy()
    tol = rtol * np.abs(o_vals) + atol
    err = np.maximum(np.abs(true - o_vals), np.abs(vals - true))
    if not (np.isfinite(true).all() and (err <= tol).all()):
        i = int(np.argmax(err - tol))
        raise AssertionError(f"{tag}: rank {i} id {ids[i]} value {vals[i]} "
                             f"(oracle {true[i]}), the oracle's rank {i} "
                             f"is id {o_ids[i]} at {o_vals[i]}")
    return float((np.abs(vals - true) / np.maximum(np.abs(true), 1e-30)
                  ).max())


def fusion_oracle(kind, v_ids, v_d, t_ids, t_s, weight, fusion_k):
    """RSF / RRF over the oracle's candidate lists, in f64 numpy (the
    reference's HybridSearchUtils.cpp semantics; vector lists ascending,
    L2).  Returns {id: fused score}."""
    fused = {}
    if kind == "RRF":
        for lst in (v_ids, t_ids):
            for r, i in enumerate(lst):
                fused[int(i)] = fused.get(int(i), 0.0) + 1.0 / (
                    fusion_k + r + 1)
        return fused

    def norm(x):
        x = np.asarray(x, dtype=np.float64)
        if len(x) == 0 or x.max() == x.min():
            return np.ones_like(x)
        return (x - x.min()) / (x.max() - x.min())
    for i, c in zip(v_ids, norm(v_d)):
        fused[int(i)] = fused.get(int(i), 0.0) + (1 - weight) * (1 - c)
    for i, c in zip(t_ids, norm(t_s)):
        fused[int(i)] = fused.get(int(i), 0.0) + weight * c
    return fused


def check_fused(tag, rows, fused, k, atol):
    order = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    if len(rows) != len(order):
        raise AssertionError(f"{tag}: {len(rows)} rows, oracle {len(order)}")
    for r, ((oid, oval), (gid, gval)) in enumerate(zip(order, rows)):
        true = fused.get(int(gid))
        if true is None or abs(true - oval) > atol or \
                abs(gval - true) > atol:
            raise AssertionError(f"{tag}: rank {r} id {gid} score {gval} "
                                 f"(oracle {true}); oracle rank {r} is "
                                 f"{oid} at {oval}")


def phase_sql_text(seed: int):
    """Text and hybrid search over 1M MS MARCO-shaped passages with
    768-dim embeddings: the BM25 index build timed apart, then seven
    statements x 20 queries each (after a warm-up query each), every
    result against an oracle that shares no code with the port (BM25 in
    f64 from the generator's (passage, word) pairs; an f64 distance
    top-30; RSF/RRF in numpy over those lists); median, p90, busy share,
    host syncs and peak memory of each statement; K2 must launch once in
    every HybridSearch statement."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import Column, Table
    from myscaledb_tpu_torch.core.types import DataType, Field
    from myscaledb_tpu_torch.ops.vector import distance_scan

    t0 = time.perf_counter()
    passages, tok_doc, tok_word, wtable, wlen, cdf, g = text_corpus(seed)
    gen_s = time.perf_counter() - t0
    n_tokens = int(tok_doc.shape[0])
    emb = torch.randn(NT, DT, generator=g, device="cuda")
    price = torch.rand(NT, generator=g, device="cuda") * 100
    t0 = time.perf_counter()
    body = Column.from_numpy("body", np.array(passages, dtype=object),
                             DataType.STRING, device="cuda")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del passages
    s = P.connect()
    s.register("p", Table([
        Column.from_numpy("id", np.arange(NT, dtype=np.int64),
                          device="cuda"),
        body, Column(Field("price", DataType.FLOAT32), price),
        Column(Field("emb", DataType.FLOAT32_VECTOR, vector_dim=DT), emb)]))
    t0 = time.perf_counter()
    idx = s.text_index("p", "body")
    index_s = time.perf_counter() - t0
    build = {"tokenize_s": idx.build_seconds["tokenize"],
             "device_build_ms": idx.build_seconds["device"] * 1e3,
             "index_s": index_s, "vocab": len(idx.vocab),
             "postings": int(idx.post_docs.shape[0]),
             "postings_bytes": idx.postings_bytes(),
             "tokens": idx.total_tokens}
    if idx.total_tokens != n_tokens or idx.stat_docs != NT:
        raise AssertionError(f"sql_text: the index holds {idx.total_tokens} "
                             f"tokens of {idx.stat_docs} passages, the "
                             f"generator made {n_tokens} of {NT}")

    # the queries: 2-6 words from the same Zipf law; vectors near a row
    rng = np.random.default_rng(seed + 10)
    qlens = rng.integers(2, 7, NT_QUERIES)
    u = torch.as_tensor(rng.random(int(qlens.sum())), device="cuda")
    qwords = torch.searchsorted(cdf, u).clamp(max=NT_WORDS - 1)
    wstr = word_strings(wtable, wlen, qwords)
    qwid = qwords.cpu().numpy()
    queries, at = [], 0
    for ln in qlens:
        queries.append((" ".join(wstr[at:at + ln]),
                        list(dict.fromkeys(qwid[at:at + ln].tolist()))))
        at += ln
    rows_q = rng.integers(0, NT, NT_QUERIES)
    qvecs = (emb[torch.as_tensor(rows_q, device="cuda")] + 0.5 * torch.randn(
        NT_QUERIES, DT, generator=g, device="cuda"))
    qlits = [vec_sql(v) for v in qvecs.cpu().numpy()]

    doc_len = torch.bincount(tok_doc.to(torch.int64), minlength=NT).double()
    avg = float(doc_len.sum()) / NT
    keep = price < 50
    lo_range = int(rng.integers(0, NT - 1000))
    in_range = torch.zeros(NT, dtype=torch.bool, device="cuda")
    in_range[lo_range:lo_range + 1000] = True
    settings = s.settings
    ncand = KT * settings.hybrid_search_top_k_multiple_base

    def vec_dense(qi):
        q = qvecs[qi].double()
        dist = torch.empty(NT, dtype=torch.float64, device="cuda")
        for a in range(0, NT, 1 << 17):
            xb = emb[a:a + (1 << 17)].double()
            dist[a:a + (1 << 17)] = ((xb - q[None, :]) ** 2).sum(1)
        return torch.where(keep, dist, torch.inf)

    vdense = {}
    errs = {}

    def hybrid_check(kind):
        def check(qi, rows):
            text, terms = queries[qi]
            if qi not in vdense:
                vdense[qi] = vec_dense(qi)
            v_ids, v_d = ranked_oracle(vdense[qi], ncand, False)
            t_ids, t_s = ranked_oracle(
                bm25_oracle(tok_doc, tok_word, doc_len, avg, terms, keep,
                            "OR"), ncand, True)
            fused = fusion_oracle(kind, v_ids, v_d, t_ids, t_s,
                                  settings.hybrid_search_fusion_weight,
                                  settings.hybrid_search_fusion_k)
            check_fused(f"sql_text hybrid_{kind} query {qi}", rows, fused,
                        KT, FUSION_ATOL[kind])
        return check

    def text_check(name, mask, operator):
        def check(qi, rows):
            dense = bm25_oracle(tok_doc, tok_word, doc_len, avg,
                                queries[qi][1], mask, operator)
            errs[name] = max(errs.get(name, 0.0), check_ranked(
                f"sql_text {name} query {qi}", [r[0] for r in rows],
                [r[1] for r in rows], dense, KT, True, TEXT_RTOL))
        return check

    def range_check(qi, rows):
        dense = bm25_oracle(tok_doc, tok_word, doc_len, avg, queries[qi][1],
                            None, "OR")[lo_range:lo_range + 1000]
        ids = [r[0] for r in rows]
        got = np.array([r[1] for r in rows])
        want = dense.cpu().numpy()
        if ids != list(range(lo_range, lo_range + 1000)) or not np.all(
                np.abs(got - want) <= TEXT_RTOL * np.abs(want)):
            raise AssertionError(f"sql_text score_column query {qi}: rows "
                                 "differ from the oracle")

    def fts_check(qi, rows):
        _text, terms = queries[qi]
        want = []
        for t, w in zip(terms, word_strings(wtable, wlen, torch.as_tensor(
                terms, device="cuda"))):
            sel = tok_word == t
            want.append((w, int(torch.unique(tok_doc[sel]).numel()),
                         int(sel.sum()), NT, n_tokens))
        if sorted(rows) != sorted(want):
            raise AssertionError(f"sql_text ftsindex query {qi}: {rows} != "
                                 f"{want}")

    statements = {
        "text_or": ("SELECT id, TextSearch(body, '{t}') AS s FROM p "
                    "ORDER BY s DESC LIMIT 10", text_check("text_or", None,
                                                           "OR")),
        "text_and": ("SELECT id, TextSearch('operator=AND')(body, '{t}') "
                     "AS s FROM p ORDER BY s DESC LIMIT 10",
                     text_check("text_and", None, "AND")),
        "text_filtered": ("SELECT id, TextSearch(body, '{t}') AS s FROM p "
                          "WHERE price < 50 ORDER BY s DESC LIMIT 10",
                          text_check("text_filtered", keep, "OR")),
        "hybrid_rsf": ("SELECT id, HybridSearch('fusion_type=rsf')(emb, "
                       "body, {v}, '{t}') AS s FROM p WHERE price < 50 "
                       "ORDER BY s DESC LIMIT 10", hybrid_check("RSF")),
        "hybrid_rrf": ("SELECT id, HybridSearch('fusion_type=rrf')(emb, "
                       "body, {v}, '{t}') AS s FROM p WHERE price < 50 "
                       "ORDER BY s DESC LIMIT 10", hybrid_check("RRF")),
        "score_column": (f"SELECT id, TextSearch(body, '{{t}}') AS s FROM p "
                         f"WHERE id >= {lo_range} AND id < "
                         f"{lo_range + 1000} ORDER BY id", range_check),
        "ftsindex": ("SELECT term, doc_freq, total_term_freq, total_docs, "
                     "total_tokens FROM ftsIndex(p, body, '{t}')",
                     fts_check),
    }
    smi = nvidia_smi_line()
    stats, totals = {}, {}
    for name, (tmpl, check) in statements.items():
        sqls = [tmpl.format(t=queries[qi][0], v=qlits[qi])
                for qi in range(NT_QUERIES)]
        s.sql(sqls[0]).to_rows()                      # warm-up
        zero_launches()
        lat, results = [], []
        for stmt in sqls:
            t0 = time.perf_counter()
            results.append(s.sql(stmt).to_rows())
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        for qi, rows in enumerate(results):
            check(qi, rows)
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
        if name.startswith("hybrid") and \
                launches["segmin_f32"] != NT_QUERIES:
            raise AssertionError(f"sql_text {name}: segmin_f32 launched "
                                 f"{launches['segmin_f32']} times in "
                                 f"{NT_QUERIES} statements")
        prof = profile_statements(s, sqls[:3])
        syncs, sites = count_host_syncs(lambda: s.sql(sqls[1]).to_rows())
        torch.cuda.reset_peak_memory_stats()
        s.sql(sqls[1]).to_rows()
        stats[name] = {"median_ms": float(np.median(lat)),
                       "p90_ms": float(np.percentile(lat, 90)),
                       "device_busy_share": prof["device_busy_share"],
                       "device_ms_per_query": prof["device_ms_per_query"],
                       "top_kernels_us": prof["top_kernels_us_per_query"],
                       "host_syncs": syncs, "host_sync_sites": sites,
                       "max_memory_allocated_bytes":
                           torch.cuda.max_memory_allocated(),
                       "launches_by_path": launches,
                       "statement": tmpl.format(t="<query>", v="<768 f32>"),
                       "first_rows": repr(results[0][:3]),
                       "nvidia_smi": smi}
    emit({"phase": "sql_text", "passages": NT, "tokens": n_tokens,
          "dim": DT, "queries": NT_QUERIES, "k": KT,
          "query_words": qlens.tolist(),
          "source": "MS MARCO passage corpus (BEIR, Thakur et al. 2021: "
                    "8,841,823 passages, mean 55.98 words; queries 5.96)",
          "reduced": ["8.84M passages cut to 1M for the run's time limit "
                      "(the host builds and tokenizes the strings)",
                      "words: Zipf (s = 1.0) over 2^20 made-up words of "
                      "3-12 letters; embeddings: standard normal"],
          "corpus_gen_s": gen_s, "dictionary_encode_s": encode_s,
          "index_build": build, "per_statement": stats,
          "launches": totals,
          "max_rel_err_text": errs,
          "oracle": "BM25 in f64 from the generator's (passage, word) "
                    f"pairs (rtol {TEXT_RTOL}); an f64 distance top-"
                    f"{ncand}; RSF/RRF in numpy over the oracle lists "
                    f"(atol {FUSION_ATOL})"})
    s.sql("DROP TABLE p")
    if s.tables:
        raise AssertionError(f"tables left: {list(s.tables)}")
    del emb, tok_doc, tok_word, idx
    torch.cuda.empty_cache()
    return totals


# sql_storage (a): ClickHouse's documented hits_v1 table (the DDL of the
# Yandex.Metrica example dataset in the ClickHouse docs, PARTITION BY
# toYYYYMM(EventDate)) cut to the columns the statements read; the JAX
# grammar takes column names only as a partition key, so the key is the day
NS = 100_000_000
NS_BATCHES = 10
NS_DAYS = 31
STORAGE_DDL = ("CREATE TABLE {name} (EventDate Date, CounterID UInt32, "
               "UserID UInt64, g UInt16, v Int32, INDEX uid UserID TYPE "
               "bloom_filter(0.025) GRANULARITY 1) ENGINE = MergeTree "
               "PARTITION BY EventDate ORDER BY (CounterID, EventDate){ttl}")
# sql_storage (b): config 1 with a day column over ten values
NB_DAYS = 10
PRUNED_SQL = ("SELECT id, distance(emb, {q}) AS d FROM {t} WHERE day = 3 "
              "AND price < 50 ORDER BY d LIMIT 10")
UNPRUNED_SQL = ("SELECT id, distance(emb, {q}) AS d FROM {t} WHERE "
                "price < 50 ORDER BY d LIMIT 10")


def storage_source(seed: int):
    """The source table of sql_storage (a) on the card, with the batch
    number b of each row: EventDate uniform over 31 consecutive days
    ending two days before the run's date (so that TTL EventDate +
    INTERVAL 30 DAY expires exactly the first three), UserID uniform over
    2^40 with one id placed twice, g in [0, 256), v in [-1000, 1000) as
    config 2, CounterID skewed as in sql_hits."""
    from myscaledb_tpu_torch.core.table import Column, Table
    from myscaledb_tpu_torch.core.types import DataType, Field
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    first_day = int(time.time() // 86400) - 32
    day = first_day + torch.randint(0, NS_DAYS, (NS,), generator=gen,
                                    device="cuda", dtype=torch.int32)
    u = torch.rand(NS, generator=gen, device="cuda", dtype=torch.float64)
    counter = torch.where(u < 0.3, 62, (u ** 3 * 7000).long() + 1)
    user = torch.randint(0, 1 << 40, (NS,), generator=gen, device="cuda")
    twice = (NS // 3, 2 * NS // 3)
    user[twice[1]] = user[twice[0]]
    g = torch.randint(0, 256, (NS,), generator=gen, device="cuda",
                      dtype=torch.int32)
    v = torch.randint(-1000, 1000, (NS,), generator=gen, device="cuda",
                      dtype=torch.int32)
    b = (torch.arange(NS, device="cuda") // (NS // NS_BATCHES)).to(
        torch.int32)

    def col(name, dt, data):
        return Column(Field(name, dt), data)
    t = Table([col("EventDate", DataType.DATE, day),
               col("CounterID", DataType.UINT32, counter),
               col("UserID", DataType.UINT64, user),
               col("g", DataType.UINT16, g), col("v", DataType.INT32, v),
               col("b", DataType.INT32, b)], name="src")
    return t, first_day, int(user[twice[0]])


def day_str(day: int) -> str:
    import datetime
    return str(datetime.date(1970, 1, 1) + datetime.timedelta(days=day))


def blocks_pruned(s, stmt):
    """Zone-map blocks one run of ``stmt`` prunes (zone maps and skip
    indexes; the ZonemapPrunedBlocks counter)."""
    from myscaledb_tpu_torch.runtime import metrics as M
    before = M.events_snapshot().get("ZonemapPrunedBlocks", 0)
    s.sql(stmt).to_rows()
    pruned = M.events_snapshot().get("ZonemapPrunedBlocks", 0) - before
    return pruned


def vector_oracle(x, sel, q, k):
    """Direct-formula L2 over the selected rows on the card, stable sort
    by (distance, row)."""
    dist = ((x - q[None, :]) ** 2).sum(1)
    dist = torch.where(sel, dist, torch.inf)
    order = torch.sort(dist, stable=True).indices[:k]
    return order.cpu().numpy(), dist[order].cpu().numpy()


def check_vector_rows(rows, want, tag):
    ids = np.array([r[0] for r in rows])
    if not np.array_equal(ids, want[0]):
        raise AssertionError(f"{tag}: ids {ids} != oracle {want[0]}")
    np.testing.assert_allclose(np.array([r[1] for r in rows],
                                        dtype=np.float32), want[1],
                               rtol=SQL_RTOL)


def phase_sql_storage(seed: int):
    """Storage through SQL on the card: (a) a 100M-row events table
    partitioned by day with a bloom-filter skip index, loaded by ten
    INSERT ... SELECT batches with merges stopped, under two pruned GROUP
    BY statements (K3), a bloom-pruned point lookup, DROP PARTITION and a
    TTL copy OPTIMIZEd; (b) config 1 partitioned by a day column, 20
    pruned and 20 unpruned vector statements (K1 once each, one SQ8
    sidecar build for the phase); (c) that table written as ten on-disk
    parts, reopened with open_table and queried again, rows equal."""
    import shutil
    import tempfile
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import BLOCK_ROWS, Table
    from myscaledb_tpu_torch.sql import executor
    from myscaledb_tpu_torch.storage.codecs import default_codec
    from myscaledb_tpu_torch.storage.skip_index import sidecar_for
    from myscaledb_tpu_torch.storage.table_store import TableStore, open_table
    smi = nvidia_smi_line()
    out = {"nvidia_smi": smi}
    totals = {}

    # (a) the partitioned events table
    s = P.connect()
    src, first_day, dup_user = storage_source(seed)
    s.register("src", src)
    s.sql(STORAGE_DDL.format(name="ev", ttl=""))
    s.sql("SYSTEM STOP MERGES ev")
    torch.cuda.synchronize()
    ins = []
    t0 = time.perf_counter()
    for i in range(NS_BATCHES):
        t1 = time.perf_counter()
        s.sql("INSERT INTO ev SELECT EventDate, CounterID, UserID, g, v "
              f"FROM src WHERE b = {i}")
        torch.cuda.synchronize()
        ins.append((time.perf_counter() - t1) * 1e3)
    insert_s = time.perf_counter() - t0
    ev = s.tables["ev"]
    if ev.n_rows != NS:
        raise AssertionError(f"sql_storage: {ev.n_rows} rows after the "
                             "inserts")
    nblocks = -(-NS // BLOCK_ROWS)
    t0 = time.perf_counter()
    idx = s._table_skip_indexes["ev"][0]
    sidecar_for(s, ev, "UserID", idx)
    torch.cuda.synchronize()
    index_ms = (time.perf_counter() - t0) * 1e3
    sday, sg, sv, suser = (src["EventDate"].data, src["g"].data,
                           src["v"].data, src["UserID"].data)
    d1, d7, d31 = first_day, first_day + 6, first_day + 30
    statements = {
        "day_groupby": "SELECT g, count(), sum(v), avg(v) FROM ev WHERE "
                       f"EventDate = '{day_str(d7)}' GROUP BY g ORDER BY g",
        "week_groupby": "SELECT g, count(), sum(v), avg(v) FROM ev WHERE "
                        f"EventDate BETWEEN '{day_str(d1)}' AND "
                        f"'{day_str(d7)}' GROUP BY g ORDER BY g",
        "user_lookup": "SELECT count(), sum(v) FROM ev WHERE UserID = "
                       f"{dup_user}"}
    masks = {"day_groupby": sday == d7,
             "week_groupby": (sday >= d1) & (sday <= d7)}

    def check_groups(name):
        cnt, sums = groupby_oracle(sg, sv, masks[name], G2)

        def check(rows):
            check_groupby_rows([(r[0], r[2], r[1], r[3]) for r in rows],
                               cnt, sums, f"sql_storage {name}")
        return check
    hit = suser == dup_user
    want_user = [(int(hit.sum()), int(sv[hit].long().sum()))]
    if want_user[0][0] < 2:
        raise AssertionError("sql_storage: the repeated UserID is missing")
    checks = {"day_groupby": check_groups("day_groupby"),
              "week_groupby": check_groups("week_groupby"),
              "user_lookup": want_user}
    stats, launches = run_statements_checked(s, statements, checks,
                                             "sql_storage")
    for name, stmt in statements.items():
        pruned = blocks_pruned(s, stmt)
        stats[name]["blocks_kept"] = nblocks - pruned
        stats[name]["blocks_all"] = nblocks
        if pruned <= 0:
            raise AssertionError(f"sql_storage {name}: no block pruned")
    for name in ("day_groupby", "week_groupby"):
        if stats[name]["launches_by_path"]["group_aggregate"] < 10:
            raise AssertionError(f"sql_storage {name}: K3 launched "
                                 f"{stats[name]['launches_by_path']}")
    for k, c in launches.items():
        totals[k] = totals.get(k, 0) + c
    s.sql("DROP TABLE src")
    del src, sday, sg, sv, suser, hit, masks
    torch.cuda.empty_cache()

    # DROP PARTITION of the last day, then the count
    want_left = NS - int((s.tables["ev"]["EventDate"].data == d31).sum())
    t0 = time.perf_counter()
    s.sql(f"ALTER TABLE ev DROP PARTITION '{day_str(d31)}'")
    torch.cuda.synchronize()
    drop_ms = (time.perf_counter() - t0) * 1e3
    left = s.sql("SELECT count() FROM ev").to_rows()[0][0]
    if left != want_left:
        raise AssertionError(f"sql_storage: {left} rows after DROP "
                             f"PARTITION, want {want_left}")

    # a copy under TTL EventDate + INTERVAL 30 DAY: OPTIMIZE expires the
    # first three days
    s.sql(STORAGE_DDL.format(name="evt",
                             ttl=" TTL EventDate + INTERVAL 30 DAY"))
    s.sql("SYSTEM STOP MERGES evt")
    s.sql("INSERT INTO evt SELECT * FROM ev")
    s.sql("DROP TABLE ev")
    torch.cuda.empty_cache()
    dates = s.tables["evt"]["EventDate"].data
    want_removed = int((dates <= d1 + 2).sum())
    del dates
    t0 = time.perf_counter()
    s.sql("OPTIMIZE TABLE evt FINAL")
    torch.cuda.synchronize()
    optimize_ms = (time.perf_counter() - t0) * 1e3
    after = s.sql("SELECT count(), min(EventDate) FROM evt").to_rows()[0]
    if left - after[0] != want_removed or \
            str(after[1]) != day_str(d1 + 3):
        raise AssertionError(f"sql_storage: OPTIMIZE left {after}, "
                             f"removed {left - after[0]} of "
                             f"{want_removed}")
    s.sql("DROP TABLE evt")
    torch.cuda.empty_cache()
    out["events"] = {
        "rows": NS, "batches": NS_BATCHES,
        "source": "ClickHouse docs, Yandex.Metrica example dataset: "
                  "hits_v1 DDL (PARTITION BY toYYYYMM(EventDate))",
        "reduced": ["partition key is the day, not toYYYYMM(EventDate): "
                    "the JAX grammar takes column names only",
                    "only the columns the statements read"],
        "insert_s": insert_s, "insert_rows_per_s": NS / insert_s,
        "insert_batch_ms": ins, "bloom_index_build_ms": index_ms,
        "statements": statements, "per_statement": stats,
        "drop_partition_ms": drop_ms,
        "rows_after_drop_partition": left,
        "optimize_ttl_ms": optimize_ms, "ttl_rows_removed": want_removed,
        "launches": launches}

    # (b) config 1 partitioned by day
    builds = []
    real_build = executor.build_sq8

    def counted_build(x):
        builds.append(tuple(x.shape))
        if len(builds) > 1:
            raise AssertionError("sql_storage: build_sq8 ran again: "
                                 f"{builds}")
        return real_build(x)
    rng = np.random.default_rng(seed + 12)
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "day": rng.integers(0, NB_DAYS, N).astype(np.uint8),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    s.create_table("src1", data)
    s.sql("CREATE TABLE tp (id UInt32, price Int32, day UInt8, emb "
          f"Array(Float32), CONSTRAINT c CHECK length(emb) = {D}) "
          "ENGINE = MergeTree PARTITION BY day ORDER BY id")
    s.sql("SYSTEM STOP MERGES tp")
    # one bulk INSERT: the batch is clustered by day, so a day's rows
    # fill about two of the 16 blocks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.sql("INSERT INTO tp SELECT id, price, day, emb FROM src1")
    torch.cuda.synchronize()
    tp_insert_s = time.perf_counter() - t0
    step = N // 10
    s.sql("DROP TABLE src1")
    x = torch.as_tensor(data["emb"], device="cuda")
    price = torch.as_tensor(data["price"], device="cuda")
    day = torch.as_tensor(data["day"], device="cuda")
    qs = rng.standard_normal((41, D), dtype=np.float32)
    sels = {"pruned": (day == 3) & (price < 50), "unpruned": price < 50}
    wants = {kind: [vector_oracle(x, sels[kind], torch.as_tensor(
        q, device="cuda"), K) for q in qs[1:]] for kind in sels}
    del x
    torch.cuda.empty_cache()

    def run_vector(table, tag):
        res = {}
        s.sql(PRUNED_SQL.format(q=vec_sql(qs[0]), t=table))     # warm-up
        for kind, sql in (("pruned", PRUNED_SQL),
                          ("unpruned", UNPRUNED_SQL)):
            stmts = [sql.format(q=vec_sql(q), t=table) for q in qs[1:21]] \
                if kind == "pruned" else \
                [sql.format(q=vec_sql(q), t=table) for q in qs[21:]]
            zero_launches()
            lat, rows, k2 = timed_statements(s, stmts)
            c = read_launches()
            ws = wants[kind][:20] if kind == "pruned" else wants[kind][20:]
            for i, (r, w) in enumerate(zip(rows, ws)):
                check_vector_rows(r, w, f"sql_storage {tag} {kind} {i}")
            if c["segmin_sq8"] != 20:
                raise AssertionError(f"sql_storage {tag} {kind}: {c}")
            pruned = blocks_pruned(s, stmts[0])
            res[kind] = {**summary_ms(lat), "launches": c,
                         "k2_statements": sum(1 for n in k2 if n),
                         "blocks_kept": -(-N // BLOCK_ROWS) - pruned,
                         "blocks_all": -(-N // BLOCK_ROWS)}
            for k_, v_ in c.items():
                totals[k_] = totals.get(k_, 0) + v_
        return res

    executor.build_sq8 = counted_build
    try:
        out["partitioned_config1"] = {
            "rows": N, "dim": D, "days": NB_DAYS,
            "insert_s": tp_insert_s, "insert_rows_per_s": N / tp_insert_s,
            **run_vector("tp", "partitioned")}
        if len(builds) != 1:
            raise AssertionError(f"sql_storage: build_sq8 ran {builds}")
        out["partitioned_config1"]["build_sq8_runs"] = len(builds)
    finally:
        executor.build_sq8 = real_build

    # (c) the same table as ten parts on disk (about one day each, the
    # rows being clustered by day), reopened
    tmp = tempfile.mkdtemp(prefix="msdb_parts_")
    try:
        tp = s.tables["tp"]
        store = TableStore(os.path.join(tmp, "tp"), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in range(0, N, step):
            store.insert(tp.take(torch.arange(a, a + step, device="cuda")),
                         codec_overrides={"emb": "lz"})
        write_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(r, f))
                   for r, _d, fs in os.walk(tmp) for f in fs)
        raw = sum(c.data.numel() * physical_dtype_np(c).itemsize
                  for c in tp.columns.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = open_table(os.path.join(tmp, "tp"), device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        if len(store.parts()) != 10 or loaded.n_rows != N:
            raise AssertionError(f"sql_storage parts: {len(store.parts())}"
                                 f" parts, {loaded.n_rows} rows")
        s.register("tparts", loaded)
        s.sql("DROP TABLE tp")
        torch.cuda.empty_cache()
        codecs_used = {c.name: "lz" if c.name == "emb" else
                       default_codec(physical_dtype_np(c))
                       for c in loaded.columns.values()}
        out["parts"] = {"parts": 10, "codecs": codecs_used,
                        "bytes_on_disk": disk, "raw_bytes": raw,
                        "write_s": write_s, "write_mb_per_s":
                            raw / write_s / 1e6,
                        "read_s": read_s, "read_mb_per_s":
                            raw / read_s / 1e6,
                        **run_vector("tparts", "parts")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        s.tables.clear()
        torch.cuda.empty_cache()
    emit({"phase": "sql_storage", **out, "launches": totals,
          "oracle": "groups equal to bincount/index_add_ on the card; the "
                    "lookup's count and sum; counts after DROP PARTITION "
                    "and OPTIMIZE; vector ids equal to a direct-formula "
                    "oracle, distances rtol 2e-5"})
    return totals


# sql_views: ClickHouse's documented aggregated materialized view (the
# AggregatingMergeTree page, "Example of an Aggregated Materialized View":
# sumState(Sign) AS Visits, uniqState(UserID) AS Users ... GROUP BY
# CounterID, StartDate) over sql_storage's 100M hits_v1-shaped events
VIEWS_EV = ("CREATE TABLE {name} (EventDate Date, CounterID UInt32, "
            "UserID UInt64, g UInt16, v Int32) ENGINE = MergeTree "
            "ORDER BY (CounterID, EventDate)")
VIEWS_DDL = [
    "CREATE TABLE ev_agg (CounterID UInt32, EventDate Date, "
    "s AggregateFunction(sum, Int32), c AggregateFunction(count, Int32), "
    "m AggregateFunction(max, Int32), h AggregateFunction(sum, Float64)) "
    "ENGINE = AggregatingMergeTree ORDER BY (CounterID, EventDate)",
    "CREATE MATERIALIZED VIEW ev_counters TO ev_agg AS SELECT CounterID, "
    "EventDate, sumState(v) AS s, countState(v) AS c, maxState(v) AS m, "
    "sumState(v * 0.5) AS h FROM ev GROUP BY CounterID, EventDate",
    "CREATE TABLE ev_users (EventDate Date, u AggregateFunction(uniq, "
    "UInt64), s AggregateFunction(sum, Int32)) ENGINE = "
    "AggregatingMergeTree ORDER BY EventDate",
    "CREATE MATERIALIZED VIEW ev_daily TO ev_users AS SELECT EventDate, "
    "uniqState(UserID) AS u, sumState(v) AS s FROM ev GROUP BY EventDate"]
# uniqMerge against the exact distinct count: PERF.md's uniq gate
VIEWS_UNIQ_RTOL = 0.05


def _views_insert(s, table: str, profile_last: bool = False):
    """Ten 10M-row INSERT ... SELECT batches of src into ``table``, each
    timed to a synchronize; the last one under the profiler when
    ``profile_last`` (its device time against its wall time)."""
    ms, prof = [], None
    for i in range(NS_BATCHES):
        stmt = (f"INSERT INTO {table} SELECT EventDate, CounterID, UserID, "
                f"g, v FROM src WHERE b = {i}")
        torch.cuda.synchronize()
        if profile_last and i == NS_BATCHES - 1:
            prof = profile_statements(s, [stmt], to_rows=False)
            continue
        t0 = time.perf_counter()
        s.sql(stmt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, prof


def phase_sql_views(seed: int):
    """Views through SQL on the card over sql_storage's 100M source
    events: (a) ev with two materialized views into AggregatingMergeTree
    tables (-State combinators; K3 for the 31 days' sums); (b) ten
    10M-row INSERT ... SELECT batches through both views, against the same
    batches into a table with no view; (c) -Merge reads, uniqMerge and
    finalizeAggregation against torch oracles over the source; (d) a view
    (K3) against its inlined statement, joinGet over a Join table,
    dictGet over a HASHED dictionary and IN a Set table; (e) ALTER UPDATE,
    ADD/MATERIALIZE/DROP COLUMN over 100M rows, exact, with the views'
    states unchanged; (f) EXPLAIN PLAN/ESTIMATE and a row policy."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import BLOCK_ROWS, Table
    smi = nvidia_smi_line()
    s = P.connect()
    s.settings.max_memory_bytes_per_query = 32 << 30
    src, first_day, _dup = storage_source(seed)
    s.register("src", src)
    sday, sctr, suser, sg, sv = (src["EventDate"].data, src["CounterID"].data,
                                 src["UserID"].data, src["g"].data,
                                 src["v"].data)
    out = {"nvidia_smi": smi, "rows": NS, "batches": NS_BATCHES,
           "source": "ClickHouse docs, AggregatingMergeTree: Example of an "
                     "Aggregated Materialized View (sumState(Sign), "
                     "uniqState(UserID) GROUP BY CounterID, StartDate), "
                     "over hits_v1",
           "reduced": ["uniqState(UserID) grouped by EventDate, not by "
                       "(CounterID, EventDate): each uniq state holds "
                       "4096 HLL registers",
                       "sumState(v) over Int32 v in place of Sign; five "
                       "columns of hits_v1"]}
    totals = {}

    # (b0) the same batches into a table with no view, for the insert rate
    s.sql(VIEWS_EV.format(name="ev_plain"))
    plain_ms, _ = _views_insert(s, "ev_plain")
    s.sql("DROP TABLE ev_plain")
    torch.cuda.empty_cache()

    # (a) the views, (b) the inserts through them
    s.sql(VIEWS_EV.format(name="ev"))
    for stmt in VIEWS_DDL:
        s.sql(stmt)
    zero_launches()
    ins_ms, ins_prof = _views_insert(s, "ev", profile_last=True)
    launches = read_launches()
    if s.tables["ev"].n_rows != NS:
        raise AssertionError(f"sql_views: {s.tables['ev'].n_rows} rows")
    if launches["group_aggregate"] < NS_BATCHES - 1:
        raise AssertionError(f"sql_views inserts: K3 launched {launches}")
    for k, c in launches.items():
        totals[k] = totals.get(k, 0) + c
    nb = NS_BATCHES - 1
    out["insert"] = {
        "batch_ms": ins_ms, "rows_per_s": nb * (NS // NS_BATCHES)
        / (sum(ins_ms) / 1e3),
        "no_view_batch_ms": plain_ms[:nb],
        "no_view_rows_per_s": nb * (NS // NS_BATCHES)
        / (sum(plain_ms[:nb]) / 1e3),
        "profiled_last_batch": ins_prof,
        "ev_agg_rows": s.tables["ev_agg"].n_rows,
        "ev_users_rows": s.tables["ev_users"].n_rows,
        "launches": launches}

    # (c) the reads, against oracles over the source
    day0 = first_day
    hit62 = sctr == 62

    def per_day(mask):
        d = (sday - day0).long()
        cnt = torch.bincount(d[mask], minlength=NS_DAYS)
        sm = torch.zeros(NS_DAYS, dtype=torch.int64, device="cuda") \
            .index_add_(0, d[mask], sv[mask].long())
        mx = torch.full((NS_DAYS,), -2 ** 31, dtype=torch.int64,
                        device="cuda").scatter_reduce_(
            0, d[mask], sv[mask].long(), "amax")
        return [(day_str(day0 + i), int(sm[i]), int(cnt[i]), int(mx[i]),
                 int(sm[i]) / 2) for i in range(NS_DAYS) if int(cnt[i])]
    want62 = per_day(hit62)
    ctr = sctr.long()
    nctr = int(ctr.max()) + 1
    csum = torch.zeros(nctr, dtype=torch.int64, device="cuda") \
        .index_add_(0, ctr, sv.long())
    ccnt = torch.bincount(ctr, minlength=nctr)
    cmax = torch.full((nctr,), -2 ** 31, dtype=torch.int64,
                      device="cuda").scatter_reduce_(0, ctr, sv.long(),
                                                     "amax")
    want_totals = torch.sort(csum, descending=True).values[:10].tolist()
    per_ctr = torch.stack([csum, ccnt, cmax], 1).cpu().numpy()
    pairs = torch.unique((sday - day0).long() * (1 << 41) + suser)
    exact_users = torch.bincount(pairs >> 41, minlength=NS_DAYS)
    del pairs
    dsum = torch.zeros(NS_DAYS, dtype=torch.int64, device="cuda") \
        .index_add_(0, (sday - day0).long(), sv.long())
    want_fin = [(day_str(day0 + i), float(dsum[i])) for i in range(NS_DAYS)]

    def check_top(rows):
        if [r[1] for r in rows] != want_totals:
            raise AssertionError(f"sql_views top10: {rows}")
        for c, total, cnt, mx in rows:
            if tuple(per_ctr[c]) != (total, cnt, mx):
                raise AssertionError(f"sql_views top10 counter {c}: "
                                     f"{(total, cnt, mx)} != oracle "
                                     f"{tuple(per_ctr[c])}")

    def check_users(rows):
        if len(rows) != NS_DAYS:
            raise AssertionError(f"sql_views users: {len(rows)} days")
        for i, (d, est) in enumerate(rows):
            exact = int(exact_users[i])
            if str(d) != day_str(day0 + i) or \
                    abs(est - exact) > VIEWS_UNIQ_RTOL * exact:
                raise AssertionError(f"sql_views users {d}: uniqMerge "
                                     f"{est} against exact {exact}")
    reads = {
        "merge_counter62": "SELECT EventDate, sumMerge(s), countMerge(c), "
                           "maxMerge(m), sumMerge(h) FROM ev_agg WHERE "
                           "CounterID = 62 GROUP BY EventDate ORDER BY "
                           "EventDate",
        "merge_top10": "SELECT CounterID, sumMerge(s) AS total, "
                       "countMerge(c), maxMerge(m) FROM ev_agg GROUP BY "
                       "CounterID ORDER BY total DESC LIMIT 10",
        "uniq_merge_daily": "SELECT EventDate, uniqMerge(u) FROM ev_users "
                            "GROUP BY EventDate ORDER BY EventDate",
        "finalize_daily": "SELECT EventDate, sum(finalizeAggregation(s)) "
                          "FROM ev_users GROUP BY EventDate ORDER BY "
                          "EventDate"}
    checks = {"merge_counter62": want62,
              "merge_top10": check_top, "uniq_merge_daily": check_users,
              "finalize_daily": want_fin}

    def rows_of(rows):
        return [tuple(str(x) if i == 0 and not isinstance(x, (int, float))
                      else x for i, x in enumerate(r)) for r in rows]
    stats, launches = run_statements_checked(
        s, reads, {k: (v if callable(v) else (lambda rows, w=v, k=k:
                                              _views_equal(k, rows_of(rows),
                                                           w)))
                   for k, v in checks.items()}, "sql_views")
    for k, c in launches.items():
        totals[k] = totals.get(k, 0) + c
    out["reads"] = stats
    out["uniq_merge_rel_err"] = [
        abs(e - int(exact_users[i])) / int(exact_users[i]) for i, (_d, e)
        in enumerate(s.sql(reads["uniq_merge_daily"]).to_rows())]

    # (d) a view against its inlined statement, joinGet, dictGet, IN a Set
    s.sql("CREATE VIEW ev_62 AS SELECT EventDate, g, v FROM ev WHERE "
          "CounterID = 62")
    ids = torch.unique(ctr)
    names = {int(c): f"counter_{int(c)}" for c in ids.cpu().tolist()}
    keys = np.asarray(sorted(names), dtype=np.int64)
    cnames = {"CounterID": keys.astype(np.uint32),
              "name": [names[int(k)] for k in keys]}
    s.create_table("counters_src", cnames)
    s.sql("CREATE TABLE counters (CounterID UInt32, name String) ENGINE = "
          "Join(ANY, LEFT, CounterID)")
    s.sql("INSERT INTO counters SELECT CounterID, name FROM counters_src")
    s.sql("CREATE DICTIONARY counter_dict (CounterID UInt64, name String) "
          "PRIMARY KEY CounterID SOURCE(TABLE 'counters_src') "
          "LAYOUT(HASHED())")
    s.sql("CREATE TABLE counters_set (CounterID UInt32) ENGINE = Set")
    s.sql("INSERT INTO counters_set SELECT CounterID FROM counters_src "
          "WHERE CounterID % 3 = 0")
    cnt62, sums62 = groupby_oracle(sg, sv, hit62, G2)
    dsel = sday == day0 + 6
    day_counts = torch.bincount(ctr[dsel], minlength=nctr)
    want_names = sorted((names[c], int(day_counts[c]))
                        for c in torch.nonzero(day_counts).flatten()
                        .cpu().tolist())
    set_ids = torch.as_tensor(keys[keys % 3 == 0], device="cuda")
    want_in = [(int(torch.isin(ctr, set_ids).sum()),)]
    want_fstate = [(int(sv[dsel].long().sum()) / 2,
                    int((day_counts > 0).sum()))]
    view_sql = "SELECT g, sum(v), count() FROM ev_62 GROUP BY g ORDER BY g"
    inline_sql = ("SELECT g, sum(v), count() FROM ev WHERE CounterID = 62 "
                  "GROUP BY g ORDER BY g")

    def check_g(rows):
        check_groupby_rows([(g, sm, c, float(np.float64(sm) / np.float64(c)))
                            for g, sm, c in rows], cnt62, sums62,
                           "sql_views view")
    lookups = {
        "view_groupby": view_sql, "inline_groupby": inline_sql,
        "joinget_day": "SELECT joinGet('counters', 'name', CounterID) AS n, "
                       f"count() FROM ev WHERE EventDate = "
                       f"'{day_str(day0 + 6)}' GROUP BY n ORDER BY n",
        "dictget_day": "SELECT dictGet('counter_dict', 'name', CounterID) "
                       f"AS n, count() FROM ev WHERE EventDate = "
                       f"'{day_str(day0 + 6)}' GROUP BY n ORDER BY n",
        "in_set": "SELECT count() FROM ev WHERE CounterID IN counters_set",
        # float -State partials on the card: one day's ~3.2M rows into
        # one sumState per counter
        "float_state_day": "SELECT sum(finalizeAggregation(st)), count() "
                           "FROM (SELECT CounterID, sumState(v * 0.5) AS st "
                           f"FROM ev WHERE EventDate = '{day_str(day0 + 6)}' "
                           "GROUP BY CounterID)"}
    lstats, launches = run_statements_checked(
        s, lookups, {"view_groupby": check_g, "inline_groupby": check_g,
                     "joinget_day": want_names, "dictget_day": want_names,
                     "in_set": want_in, "float_state_day": want_fstate},
        "sql_views")
    if lstats["view_groupby"]["launches_by_path"]["group_aggregate"] < 10:
        raise AssertionError("sql_views: K3 not launched by the view's "
                             f"GROUP BY: {lstats['view_groupby']}")
    if s.sql(view_sql).to_rows() != s.sql(inline_sql).to_rows():
        raise AssertionError("sql_views: the view's rows differ from the "
                             "inlined statement's")
    for k, c in launches.items():
        totals[k] = totals.get(k, 0) + c
    out["lookups"] = lstats
    out["counters"] = len(keys)

    # (e) mutations over the 100M rows, exact against the source
    n62 = int(hit62.sum())
    want_sum = int(sv.long().sum()) + n62
    mut = {}

    def timed(stmt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.sql(stmt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    mut["update_ms"] = timed("ALTER TABLE ev UPDATE v = v + 1 WHERE "
                             "CounterID = 62")
    mut["update_rows"] = n62
    got = s.sql("SELECT sum(v), count() FROM ev").to_rows()[0]
    if got != (want_sum, NS):
        raise AssertionError(f"sql_views UPDATE: {got} != {(want_sum, NS)}")
    mut["add_column_ms"] = timed("ALTER TABLE ev ADD COLUMN v2 Int64 "
                                 "DEFAULT v * 2")
    mut["materialize_ms"] = timed("ALTER TABLE ev MATERIALIZE COLUMN v2")
    mut["add_column_rows"] = NS
    got = s.sql("SELECT sum(v2) FROM ev").to_rows()[0][0]
    if got != 2 * want_sum:
        raise AssertionError(f"sql_views ADD COLUMN: {got}")
    mut["drop_column_ms"] = timed("ALTER TABLE ev DROP COLUMN v2")
    if "v2" in s.tables["ev"].column_names:
        raise AssertionError("sql_views: v2 still there")
    # the views saw inserts only: their states keep the source's values
    after = rows_of(s.sql(reads["merge_counter62"]).to_rows())
    _views_equal("merge_counter62 after UPDATE", after, want62)
    live = s.sql("SELECT EventDate, sum(v) FROM ev WHERE CounterID = 62 "
                 "GROUP BY EventDate ORDER BY EventDate").to_rows()
    if [(str(d), x) for d, x in live] != [(d, a + b) for d, a, b, _m, _h
                                          in want62]:
        raise AssertionError("sql_views: ev after UPDATE differs")
    out["mutations"] = mut

    # (f) EXPLAIN and a row policy, for correctness only
    plan = [r[0] for r in s.sql(
        "EXPLAIN PLAN SELECT CounterID, count() FROM ev WHERE CounterID = "
        "62 GROUP BY CounterID").to_rows()]
    if not any(ln.lstrip().startswith("Aggregate") for ln in plan) or \
            not any("Scan (ev)" in ln for ln in plan):
        raise AssertionError(f"sql_views EXPLAIN PLAN: {plan}")
    est = s.sql("EXPLAIN ESTIMATE SELECT * FROM ev WHERE CounterID = 62"
                ).to_rows()
    if est[0][:3] != ("ev", NS, -(-NS // BLOCK_ROWS)):
        raise AssertionError(f"sql_views EXPLAIN ESTIMATE: {est}")
    s.sql("CREATE USER analyst")
    s.sql("GRANT SELECT ON ev TO analyst")
    s.sql("CREATE ROW POLICY p62 ON ev USING CounterID = 62 TO analyst")
    s.current_user = "analyst"
    got = s.sql("SELECT count(), sum(v) FROM ev").to_rows()[0]
    s.current_user = "default"
    s.sql("DROP ROW POLICY p62 ON ev")
    want_pol = (n62, int(sv[hit62].long().sum()) + n62)
    if got != want_pol:
        raise AssertionError(f"sql_views row policy: {got} != {want_pol}")
    out["explain_plan"] = plan
    out["explain_estimate"] = est
    for stmt in ("DROP TABLE ev_62", "DROP TABLE ev_counters",
                 "DROP TABLE ev_daily", "DROP DICTIONARY counter_dict"):
        s.sql(stmt)
    s.tables.clear()
    del src, sday, sctr, suser, sg, sv, ctr, hit62
    torch.cuda.empty_cache()
    emit({"phase": "sql_views", **out, "launches": totals,
          "oracle": "per-day and per-counter int64 sums, counts and maxima "
                    "by index_add_/bincount/scatter_reduce over the "
                    "source; exact distinct (day, UserID) pairs by "
                    "torch.unique, uniqMerge within 5%; view rows equal "
                    "the inlined statement's and bincount; joinGet/dictGet "
                    "counts by name from a gather of the counters; IN a "
                    "Set equal to torch.isin; ALTER results exact"})
    return totals


# ClickBench's load and export paths over the hits table of sql_hits: the
# file formats, INTO OUTFILE / FROM INFILE, SAMPLE, backup and restore and
# a FILE-sourced dictionary (ROADMAP item 10.3)
NF_TEXT = 10_000_000             # rows of (b)'s text and row formats
NF_NATIVE = 10_000_000           # rows of (a)'s Native trip and (d)'s backup
TEXT_FORMATS = ("TSV", "CSV", "JSONEachRow", "RowBinary")
HITS_COLUMNS = ("UserID Int64, EventTime DateTime, EventDate Date, "
                "CounterID Int32, RegionID Int32, AdvEngineID Int16, "
                "ResolutionWidth Int16, IsRefresh Int16, DontCountHits Int16, "
                "URL String, SearchPhrase String")
Q8_SQL = ("SELECT AdvEngineID, count() FROM {t} {sample}WHERE AdvEngineID "
          "<> 0 GROUP BY AdvEngineID ORDER BY count() DESC")
SAMPLE_FRACTION = 0.1
DICT_DAY = "2013-07-15"


# the least time a step's copies between the host and the card can take:
# H100's host link, PCIe Gen5 x16, 64 GB/s each way (NVIDIA's data sheet
# gives 128 GB/s for both ways together)
HOST_LINK_BYTES_PER_S = 64e9


def table_bytes(t, rows=None) -> int:
    """The bytes of a table's columns (data and validity), or of its
    first ``rows`` rows: what a file step moves across the host link."""
    n = sum(c.data.nbytes + (0 if c.valid is None else c.valid.nbytes)
            for c in t.columns.values())
    return n if rows is None else n * rows // t.n_rows


def worker_copy_probe(mib: int = 256) -> dict:
    """Whether ``device_profiler`` sees the card's work that pool threads
    issue (the file readers and writers work on thread pools): one
    pageable upload of ``mib`` MiB from a worker thread under the
    profiler, timed there with CUDA events too.  Reported beside the
    steps; a profile that lost its window reads 0 here too."""
    from concurrent.futures import ThreadPoolExecutor
    host = np.ones(mib << 18, dtype=np.float32)

    def upload():
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        out = torch.from_numpy(host).to("cuda")
        t1.record()
        t1.synchronize()
        return out, t0.elapsed_time(t1)
    upload()                                    # warm the staging path
    with device_profiler() as prof:
        with ThreadPoolExecutor(1) as pool:
            _, event_ms = pool.submit(upload).result()
        torch.cuda.synchronize()
    prof_ms = sum(_dev_us(e) for e in device_events(prof)) / 1e3
    return {"bytes": host.nbytes, "event_ms": event_ms,
            "profiler_ms": prof_ms,
            "profiler_sees_worker_threads": prof_ms >= 0.5 * event_ms}


def timed_step(fn, rows: int, moved_bytes: int, path=None):
    """One run of a file step under the profiler with PyTorch's sync debug
    mode on: its seconds and rows/s, the host synchronisations, the peak
    device memory and, where it has a file, the file's bytes and MB/s.
    The device time (copies and kernels) against the host's is given only
    where the profile's copies take at least the time ``moved_bytes``
    take over the host link (a profile that lost its window reads less);
    else null, with the profile's reading beside it.  One run: each step
    moves up to 100M rows through the host."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with device_profiler() as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    events = device_events(prof)
    prof_s = sum(_dev_us(e) for e in events) / 1e6
    copy_s = sum(_dev_us(e) for e in events if "Memcpy" in e.key) / 1e6
    floor_s = moved_bytes / HOST_LINK_BYTES_PER_S
    dev_s = prof_s if copy_s >= floor_s else None
    st = {"runs": 1, "seconds": wall, "median_s": wall, "p90_s": wall,
          "rows": rows, "rows_per_s": rows / wall, "device_s": dev_s,
          "host_s": None if dev_s is None else wall - dev_s,
          "device_busy_share": None if dev_s is None else dev_s / wall,
          "profile_device_s": prof_s, "profile_copy_s": copy_s,
          "copy_floor_s": floor_s, "moved_bytes": moved_bytes,
          "host_syncs": sum(1 for w in caught
                            if "synchroniz" in str(w.message)),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if path is not None:
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(path) for f in fs) \
            if os.path.isdir(path) else os.path.getsize(path)
        st.update(file_bytes=size, mb_per_s=size / 1e6 / wall)
    return out, st


def same_table(tag, got, want, n=None):
    """``got`` equals the first ``n`` rows of ``want`` column by column on
    the card: the data by torch.equal, a String column by its strings
    (each dictionary value of ``got`` looked up in ``want``'s)."""
    for name, wc in want.columns.items():
        gc = got[name]
        wd = wc.data if n is None else wc.data[:n]
        if wc.dictionary is None:
            if not torch.equal(gc.data, wd):
                raise AssertionError(f"sql_formats {tag}: column {name} "
                                     "differs")
            continue
        lut = torch.tensor([wc.dictionary.index[v]
                            for v in gc.dictionary.values],
                           dtype=torch.int64, device=wd.device)
        if not torch.equal(lut[gc.data.long()], wd.long()):
            raise AssertionError(f"sql_formats {tag}: column {name}'s "
                                 "strings differ")


def q8_oracle(adv: torch.Tensor):
    """Q8's rows from a bincount of AdvEngineID on the card, as a set, with
    the counts the statement's order must not increase along."""
    cnt = torch.bincount(adv.long(), minlength=64)
    ids = torch.nonzero(cnt).flatten().tolist()
    return sorted((a, int(cnt[a])) for a in ids if a != 0)


def check_q8(tag, rows, want):
    counts = [c for _, c in rows]
    if sorted(rows) != want or counts != sorted(counts, reverse=True):
        raise AssertionError(f"sql_formats {tag}: {rows[:3]} != oracle "
                             f"{want[:3]}")


def phase_sql_formats(seed: int):
    """ClickBench's load and export paths over the 100M-row hits table:
    (a) a Native round trip of its first 10M rows through INTO OUTFILE
    and FROM INFILE; (b) its load formats (TSV, CSV, JSONEachRow,
    RowBinary) on 10M rows, out and back, and Session.import_file of the
    TSV; (c) ClickBench's Q8 over the source, the Native copy and the TSV
    copy, and with SAMPLE 0.1 (K3); (d) backup and restore of a 10M-row
    copy of hits and of config 1's vector table, then a fused top-k over
    the restored one (K1); (e) a FILE-sourced dictionary and the same
    lookup through a join on file().  Every copy equals its source on the
    card; files go to a temporary directory removed at the end."""
    import shutil
    import tempfile
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.ops.hash import hash32
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    table, _urls = hits_table(seed)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    s = P.connect()
    s.settings.max_memory_bytes_per_query = 32 << 30
    s.register("hits", table)
    probe = worker_copy_probe()
    text_b = table_bytes(table, NF_TEXT)
    native_b = table_bytes(table, NF_NATIVE)
    tmp = tempfile.mkdtemp(prefix="sql_formats_")
    steps, totals = {}, {}
    try:
        # (a) Native at 10M rows
        path = os.path.join(tmp, "hits.native")
        _, steps["native_write"] = timed_step(lambda: s.sql(
            f"SELECT * FROM hits LIMIT {NF_NATIVE} INTO OUTFILE '{path}' "
            "FORMAT Native"), NF_NATIVE, native_b, path)
        s.sql(f"CREATE TABLE hits_n ({HITS_COLUMNS}) ENGINE = MergeTree "
              "ORDER BY (CounterID, EventDate)")
        _, steps["native_read"] = timed_step(lambda: s.sql(
            f"INSERT INTO hits_n FROM INFILE '{path}' FORMAT Native"),
            NF_NATIVE, native_b, path)
        same_table("native", s.tables["hits_n"], table, NF_NATIVE)
        for c in ("URL", "SearchPhrase"):
            if s.tables["hits_n"][c].dictionary.values != \
                    table[c].dictionary.values:
                raise AssertionError(f"sql_formats native: {c}'s "
                                     "dictionary differs")
        os.unlink(path)

        # (b) ClickBench's load formats at 10M rows
        for fmt in TEXT_FORMATS:
            path = os.path.join(tmp, f"hits.{fmt.lower()}")
            _, steps[f"{fmt}_write"] = timed_step(lambda: s.sql(
                f"SELECT * FROM hits LIMIT {NF_TEXT} INTO OUTFILE "
                f"'{path}' FORMAT {fmt}"), NF_TEXT, text_b, path)
            name = f"hits_{fmt.lower()}"
            s.sql(f"CREATE TABLE {name} ({HITS_COLUMNS}) ENGINE = Memory")
            _, steps[f"{fmt}_read"] = timed_step(lambda: s.sql(
                f"INSERT INTO {name} FROM INFILE '{path}' FORMAT {fmt}"),
                NF_TEXT, text_b, path)
            same_table(fmt, s.tables[name], table, NF_TEXT)
            if fmt == "TSV":
                s.sql(f"CREATE TABLE hits_imp ({HITS_COLUMNS}) "
                      "ENGINE = Memory")
                _, steps["TSV_import_file"] = timed_step(
                    lambda: s.import_file("hits_imp", path, "TSV"),
                    NF_TEXT, text_b, path)
                same_table("import_file", s.tables["hits_imp"], table,
                           NF_TEXT)
                s.drop_table("hits_imp")
            else:
                s.drop_table(name)
            os.unlink(path)

        # (c) Q8 over the source, the copies and a 10% SAMPLE (K3)
        adv = table["AdvEngineID"].data
        keep = hash32(torch.arange(NH, dtype=torch.int64, device="cuda")) \
            < int(SAMPLE_FRACTION * 0xFFFFFFFF)
        want_full = q8_oracle(adv)
        statements = {
            "q8_hits": Q8_SQL.format(t="hits", sample=""),
            "q8_native_copy": Q8_SQL.format(t="hits_n", sample=""),
            "q8_tsv_copy": Q8_SQL.format(t="hits_tsv", sample=""),
            "q8_sample": Q8_SQL.format(
                t="hits", sample=f"SAMPLE {SAMPLE_FRACTION} ")}
        wants = {"q8_hits": want_full,
                 "q8_native_copy": q8_oracle(adv[:NF_NATIVE]),
                 "q8_tsv_copy": q8_oracle(adv[:NF_TEXT]),
                 "q8_sample": q8_oracle(adv[keep])}
        del keep
        checks = {k: (lambda rows, k=k: check_q8(k, rows, wants[k]))
                  for k in statements}
        stats, totals = run_statements_checked(s, statements, checks,
                                               "sql_formats")
        for k, st in stats.items():
            st["rows_per_s"] = {"q8_tsv_copy": NF_TEXT,
                                "q8_native_copy": NF_NATIVE}.get(k, NH) / \
                (st["median_ms"] / 1e3)
            if st["launches_by_path"]["group_aggregate"] < 1:
                raise AssertionError(f"sql_formats {k}: group_aggregate "
                                     "did not launch")
        s.drop_table("hits_n")
        s.drop_table("hits_tsv")

        # (d) backup and restore: 10M rows of hits, then config 1 with a
        # top-k (K1)
        s.register("hits_b", table.head(NF_NATIVE))
        bdir = os.path.join(tmp, "backup_hits")
        _, steps["backup_hits"] = timed_step(
            lambda: s.backup(bdir, ["hits_b"]), NF_NATIVE, native_b, bdir)
        s.drop_table("hits_b")
        s2 = P.connect()
        _, steps["restore_hits"] = timed_step(lambda: s2.restore(bdir),
                                              NF_NATIVE, native_b, bdir)
        same_table("restore", s2.tables["hits_b"], table, NF_NATIVE)
        del s2
        shutil.rmtree(bdir)
        torch.cuda.empty_cache()
        rng = np.random.default_rng(seed + 13)
        s.create_table("t", {"id": np.arange(N, dtype=np.int64),
                             "price": rng.integers(0, 100, N)
                             .astype(np.int32),
                             "emb": rng.standard_normal((N, D),
                                                        dtype=np.float32)})
        s.sql("ALTER TABLE t ADD VECTOR INDEX vi emb TYPE MSTG")
        q = rng.standard_normal(D, dtype=np.float32)
        topk = (f"SELECT id, distance(emb, {vec_sql(q)}) AS d FROM t "
                "WHERE price < 50 ORDER BY d LIMIT 10")
        before = s.sql(topk).to_rows()
        bdir = os.path.join(tmp, "backup_config1")
        t_b = table_bytes(s.tables["t"])
        _, steps["backup_config1"] = timed_step(
            lambda: s.backup(bdir, ["t"]), N, t_b, bdir)
        s3 = P.connect()
        _, steps["restore_config1"] = timed_step(lambda: s3.restore(bdir),
                                                 N, t_b, bdir)
        same_table("restore config 1", s3.tables["t"], s.tables["t"])
        if s3.sql("SELECT name, status FROM system.vector_indices")\
                .to_rows() != [("vi", "Built")]:
            raise AssertionError("sql_formats: the index registration was "
                                 "not restored")
        s3.sql(topk).to_rows()          # builds the restored sidecar
        zero_launches()
        after = s3.sql(topk).to_rows()
        topk_launches = read_launches()
        if after != before:
            raise AssertionError(f"sql_formats: top-k after restore {after[:3]}"
                                 f" != before {before[:3]}")
        if topk_launches["segmin_sq8"] < 1:
            raise AssertionError("sql_formats: the restored top-k did not "
                                 "launch segmin_sq8")
        for k, c in topk_launches.items():
            totals[k] = totals.get(k, 0) + c
        del s3
        s.drop_table("t")
        shutil.rmtree(bdir)
        torch.cuda.empty_cache()

        # (e) a FILE-sourced dictionary and file() over the CounterIDs
        counters = torch.unique(table["CounterID"].data).cpu().numpy()
        s.create_table("cnames", {"CounterID": counters.astype(np.int32),
                                  "name": [f"counter {c}" for c in
                                           counters]})
        cpath = os.path.join(tmp, "counters.csv")
        s.sql(f"SELECT * FROM cnames INTO OUTFILE '{cpath}' FORMAT CSV")
        s.sql(f"CREATE DICTIONARY counters (CounterID Int32, name String) "
              f"PRIMARY KEY CounterID SOURCE(FILE(path '{cpath}' format "
              f"'CSV')) LAYOUT(HASHED())")
        import datetime as _dt
        day = (_dt.date.fromisoformat(DICT_DAY) - _dt.date(1970, 1, 1)).days
        sel = table["EventDate"].data == day
        per = torch.bincount(table["CounterID"].data[sel].long(),
                             minlength=int(counters.max()) + 1)
        want = sorted((f"counter {c}", int(per[c]))
                      for c in torch.nonzero(per).flatten().tolist())
        lookups = {
            "dictget_by_name": (
                f"SELECT dictGet('counters', 'name', CounterID) AS name, "
                f"count() FROM hits WHERE EventDate = '{DICT_DAY}' "
                f"GROUP BY name"),
            # as a user writes it: the executor joins before the WHERE,
            # so all 100M rows go through the join's host row pairs
            "file_join_where": (
                f"SELECT f.name, count() FROM hits AS h INNER JOIN (SELECT "
                f"* FROM file('{cpath}', 'CSV', 'CounterID Int32, name "
                f"String')) AS f ON h.CounterID = f.CounterID WHERE "
                f"h.EventDate = '{DICT_DAY}' GROUP BY f.name"),
            # the day's rows first, in a subquery
            "file_join_by_name": (
                f"SELECT f.name, count() FROM (SELECT CounterID FROM hits "
                f"WHERE EventDate = '{DICT_DAY}') AS h INNER JOIN (SELECT * "
                f"FROM file('{cpath}', 'CSV', 'CounterID Int32, name "
                f"String')) AS f ON h.CounterID = f.CounterID "
                f"GROUP BY f.name")}

        def check_names(rows, k):
            if sorted(rows) != want:
                raise AssertionError(f"sql_formats {k}: {sorted(rows)[:3]} "
                                     f"!= oracle {want[:3]}")
        lstats, ltotals = run_statements_checked(
            s, lookups, {k: (lambda rows, k=k: check_names(rows, k))
                         for k in lookups}, "sql_formats")
        for k, c in ltotals.items():
            totals[k] = totals.get(k, 0) + c
        stats.update(lstats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text_read = min(steps[f"{f}_read"]["rows_per_s"] for f in TEXT_FORMATS)
    emit({"phase": "sql_formats", "rows": NH, "text_rows": NF_TEXT,
          "table_gen_s": gen_s,
          "source": "ClickBench hits (clickhouse/create.sql; the load is "
                    "INSERT INTO hits FORMAT TSV), queries.sql Q8; "
                    "ClickHouse's SAMPLE clause documentation (SAMPLE 0.1)",
          "reduced": [f"(b) TSV, CSV, JSONEachRow and RowBinary at "
                      f"{NF_TEXT} of the {NH} rows: the slowest read ran "
                      f"{text_read:.0f} rows/s, {NH / text_read:.1f} s for "
                      "all of them, per format and direction",
                      f"(a) Native and (d) hits' backup at {NF_NATIVE} of "
                      f"the {NH} rows: at 100M rows they took ~145 s of the "
                      "script's time limit",
                      "URL and SearchPhrase have 2^17 distinct values (as "
                      "sql_hits)", "only sql_hits' eleven columns"],
          "steps": steps, "per_statement": stats,
          "restored_topk_launches": topk_launches, "launches": totals,
          "device_split_probe": probe,
          "nvidia_smi": smi,
          "oracle": "copies torch.equal to the source column by column "
                    "(strings through their dictionaries); Q8 against a "
                    "bincount, SAMPLE against hash32 of the row ids under "
                    "the same threshold; the restored top-k equal to the "
                    "one before the backup; lookups against a bincount "
                    "gather"})
    s.tables.clear()
    del table
    torch.cuda.empty_cache()
    return totals


SERVE_S = 10.0                   # each load run of sql_server (c)
PROFILE_S = 2.0                  # its profiled window
POLICY_ROUNDS = 50               # each user's rounds per protocol in (b)


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def start_servers(s, failures: list) -> dict:
    """The HTTP, native TCP, MySQL, PostgreSQL and gRPC servers over one
    session, each on an ephemeral port in a thread of this process (so the
    statements they run count the launches here).  A handler's exception
    is appended to ``failures``, which fails the phase."""
    import threading
    import traceback
    from myscaledb_tpu_torch.runtime.grpc_server import serve_grpc
    from myscaledb_tpu_torch.runtime.mysql_server import serve_mysql
    from myscaledb_tpu_torch.runtime.pg_server import serve_pg
    from myscaledb_tpu_torch.runtime.server import make_server
    from myscaledb_tpu_torch.runtime.tcp_server import serve_tcp
    http = make_server(s, "127.0.0.1", 0)
    threading.Thread(target=http.serve_forever, daemon=True).start()
    servers = {"http": http, "tcp": serve_tcp(s, port=0),
               "mysql": serve_mysql(s, "127.0.0.1", 0),
               "pg": serve_pg(s, "127.0.0.1", 0),
               "grpc": serve_grpc(s, port=0)}
    for name, srv in servers.items():
        srv.handle_error = (lambda req, addr, name=name: failures.append(
            f"{name} server: {traceback.format_exc()}"))
    return servers


def http_body(port: int, sql: str, fmt: str = "TSV") -> bytes:
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/",
                                 data=sql.encode(), headers={"X-Format": fmt})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def wire_check(proto: str, servers: dict, sql: str, ref, tag: str) -> None:
    """The statement's answer through ``proto`` equals the in-process
    result ``ref``: HTTP's TSV bytes, the TCP block's columns, the MySQL
    and PostgreSQL cells (ch_cells), gRPC's Result output."""
    from myscaledb_tpu_torch.runtime.formats import ch_cells
    from myscaledb_tpu_torch.runtime.server import render
    from myscaledb_tpu_torch.runtime.tcp_server import TcpClient
    from myscaledb_tpu_torch.runtime.grpc_server import parse_message
    from tools import wire_clients as W
    port = servers[proto].server_address[1]
    if proto == "http":
        ok = http_body(port, sql) == render(ref, "TSV")[0]
    elif proto == "tcp":
        c = TcpClient(port=port, timeout=60)
        try:
            n, cols = c.query(sql)
        finally:
            c.close()
        ok = n == ref.n_rows and list(cols) == ref.column_names and all(
            (cols[k][0] == ref[k].dictionary.decode(ref[k].to_numpy())
             if ref[k].dictionary is not None
             else np.array_equal(cols[k][0], ref[k].to_numpy()))
            for k in cols)
    elif proto in ("mysql", "pg"):
        cls = W.MySQLClient if proto == "mysql" else W.PGClient
        c = cls("127.0.0.1", port, timeout=60)
        try:
            _names, rows = c.query(sql)
        finally:
            c.close()
        ok = rows == ch_cells(ref)
    else:
        (r,), _h, trailers = W.grpc_call(port, [W.query_info(sql)],
                                         timeout=60)
        out = parse_message(r)
        ok = 7 not in out and trailers["grpc-status"] == "0" and \
            out.get(1, [b""])[-1] == render(ref, "TSV")[0]
    if not ok:
        raise AssertionError(f"sql_server {proto} {tag}: the served answer "
                             "differs from the in-process result")


# the one kernel each launch of a served path's wrapper runs on the card
SERVED_KERNELS = {"segmin_sq8": ("segmin_sq8_wgmma", "segmin_sq8_dp4a"),
                  "group_aggregate": ("group_agg_partial",)}


def served_window(fn):
    """One profiled window of served traffic: wall seconds and the card's
    busy share (device time of every thread's work over wall time).  The
    share is given only where the profile holds every K1 and K3 run that
    the launch counters saw in the window (a profile that lost its window,
    or part of it, holds fewer); else null, with the profile's reading
    beside it."""
    zero_launches()
    with device_profiler() as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = read_launches()
    events = device_events(prof)
    prof_s = sum(_dev_us(e) for e in events) / 1e6
    seen = {k: sum(e.count for e in events if any(p in e.key for p in pats))
            for k, pats in SERVED_KERNELS.items()}
    want = {k: launched[k] for k in SERVED_KERNELS}
    whole = seen == want and any(want.values())
    return out, {"wall_s": wall, "profile_device_s": prof_s,
                 "kernel_runs_profiled": seen, "kernel_launches": want,
                 "device_s": prof_s if whole else None,
                 "device_busy_share": prof_s / wall if whole else None}


def phase_sql_server(seed: int):
    """The wire servers and the CLI over config 1 (1M x 128 with its SQ8
    sidecar) and the 100M-row hits table on the card: (a) the HTTP, TCP,
    MySQL, PostgreSQL and gRPC servers in threads of this process over one
    session, each answering config 1's statement for ten query vectors
    (K1; ids equal to the oracle) and ClickBench's Q8 (K3), every answer
    equal to the in-process result, HTTP also in JSON, JSONEachRow, Native
    and RowBinary; (b) two users under complementary row policies on hits
    querying at once over HTTP, MySQL and PostgreSQL, every count exact;
    (c) benchmark.run_http at concurrency 1 and 4 over the twenty
    statements of sql_sq8, Q8 at concurrency 4, run_local over the twenty,
    each for 10 s with no error (QPS, p50/p90/p99, a profiled window's
    busy share, host syncs per statement, the served median less the
    in-process one); the TCP block's cost of a String column's whole
    dictionary; (d) ``python -m myscaledb_tpu_torch server`` over config 1
    written as parts, timed to its first /ping and first answer, then the
    client and benchmark tools against it."""
    import shutil
    import tempfile
    import threading
    import urllib.request
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.runtime import benchmark
    from myscaledb_tpu_torch.runtime.server import render, result_to_json
    from myscaledb_tpu_torch.runtime.tcp_server import TcpClient, \
        encode_block
    from myscaledb_tpu_torch.storage.table_store import TableStore
    from tools import wire_clients as W
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    # config 1 as sql_sq8 makes it (the same generator order, so the same
    # twenty statements)
    rng = np.random.default_rng(seed)
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    queries = rng.standard_normal((21, D), dtype=np.float32)
    s = P.connect()
    s.settings.max_memory_bytes_per_query = 32 << 30
    s.create_table("t", data)
    del data
    hits, _urls = hits_table(seed)
    s.register("hits", hits)
    x, price = s.tables["t"]["emb"].data, s.tables["t"]["price"].data
    stmt = ("SELECT id, distance(emb, {q}) AS d FROM t WHERE price < 50 "
            "ORDER BY d LIMIT 10")
    stmts = [stmt.format(q=vec_sql(queries[i])) for i in range(1, 21)]
    q8 = Q8_SQL.format(t="hits", sample="")
    want_ids = [oracle(x, price, torch.as_tensor(queries[i], device="cuda"),
                       K)[0] for i in range(1, 21)]
    want_q8 = q8_oracle(hits["AdvEngineID"].data)
    refs = {}
    for i, sql in enumerate(stmts[:10]):
        refs[sql] = s.sql(sql)
        got = np.array([r[0] for r in refs[sql].to_rows()])
        if not np.array_equal(got, want_ids[i]):
            raise AssertionError(f"sql_server in-process {i}: ids {got} "
                                 f"!= oracle {want_ids[i]}")
    refs[q8] = s.sql(q8)
    rows = refs[q8].to_rows()
    counts = [c for _, c in rows]
    if sorted(rows) != want_q8 or counts != sorted(counts, reverse=True):
        raise AssertionError(f"sql_server in-process q8: {rows[:3]}")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    failures: list = []
    servers = start_servers(s, failures)
    tmp = tempfile.mkdtemp(prefix="sql_server_")
    proc = logs = None
    out = {"phase": "sql_server", "rows": N, "dim": D, "hits_rows": NH,
           "setup_s": setup_s, "nvidia_smi": smi}
    try:
        # (a) every protocol: ten config-1 statements and Q8, counted
        launches, totals, wire_s = {}, {}, {}
        for proto in servers:
            zero_launches()
            t1 = time.perf_counter()
            for i, sql in enumerate(list(refs)):
                wire_check(proto, servers, sql, refs[sql],
                           "q8" if sql == q8 else f"config1 {i}")
            wire_s[proto] = time.perf_counter() - t1
            launches[proto] = read_launches()
            if launches[proto]["segmin_sq8"] < 10 or \
                    launches[proto]["group_aggregate"] < 1:
                raise AssertionError(f"sql_server {proto}: launches "
                                     f"{launches[proto]}")
            for k, c in launches[proto].items():
                totals[k] = totals.get(k, 0) + c
        port = servers["http"].server_address[1]
        for sql in (stmts[0], q8):
            for fmt in ("JSON", "JSONEachRow", "Native", "RowBinary"):
                want = result_to_json(refs[sql]).encode() if fmt == "JSON" \
                    else render(refs[sql], fmt.upper())[0]
                if http_body(port, sql, fmt) != want:
                    raise AssertionError(f"sql_server http {fmt}: bytes "
                                         "differ from the in-process "
                                         "result's")
        out["wire"] = {"statements_per_protocol": len(refs),
                       "seconds": wire_s, "launches": launches,
                       "http_formats": ["TSV", "JSON", "JSONEachRow",
                                        "Native", "RowBinary"],
                       "checks": "ids equal the oracle; every protocol's "
                                 "answer equals the in-process result"}

        # (b) two users, complementary row policies, at once
        cid = hits["CounterID"].data
        want_user = {"u62": int((cid == 62).sum()),
                     "urest": int((cid != 62).sum())}
        for user, cond in (("u62", "CounterID = 62"),
                           ("urest", "CounterID != 62")):
            s.sql(f"CREATE USER {user}")
            s.sql(f"GRANT SELECT ON hits TO {user}")
            s.sql(f"CREATE ROW POLICY p_{user} ON hits USING {cond} "
                  f"TO {user}")
        count_sql = "SELECT count() FROM hits"
        wrong, errors = [], []

        def rounds(proto, user):
            try:
                if proto == "http":
                    for _ in range(POLICY_ROUNDS):
                        req = urllib.request.Request(
                            f"http://127.0.0.1:{port}/",
                            data=count_sql.encode(),
                            headers={"X-ClickHouse-User": user})
                        with urllib.request.urlopen(req, timeout=60) as r:
                            n = int(r.read())
                        if n != want_user[user]:
                            wrong.append((proto, user, n))
                    return
                cls = W.MySQLClient if proto == "mysql" else W.PGClient
                c = cls("127.0.0.1", servers[proto].server_address[1],
                        user=user, timeout=60)
                try:
                    for _ in range(POLICY_ROUNDS):
                        n = int(c.query(count_sql)[1][0][0])
                        if n != want_user[user]:
                            wrong.append((proto, user, n))
                finally:
                    c.close()
            except Exception as e:                        # noqa: BLE001
                errors.append(f"{proto} {user}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=rounds, args=(p, u))
                   for p in ("http", "mysql", "pg") for u in want_user]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        policy_s = time.perf_counter() - t1
        if errors or wrong or any(th.is_alive() for th in threads):
            raise AssertionError(f"sql_server row policies: errors "
                                 f"{errors[:3]}, wrong counts {wrong[:3]}")
        for user in want_user:
            s.sql(f"DROP ROW POLICY p_{user} ON hits")
        n_stmts = 6 * POLICY_ROUNDS
        out["row_policies"] = {"statements": n_stmts, "seconds": policy_s,
                               "statements_per_s": n_stmts / policy_s,
                               "counts": want_user, "wrong": 0}

        # (c) served traffic
        url = f"http://127.0.0.1:{port}/"
        inproc = {}
        for name, batch in (("config1", stmts), ("q8", [q8])):
            lat = []
            for sql in batch * (1 if name == "config1" else 10):
                t1 = time.perf_counter()
                s.sql(sql).to_rows()
                lat.append((time.perf_counter() - t1) * 1e3)
            inproc[name] = float(np.median(lat))
        runs = {}
        for name, fn, base in (
                ("http_c1", lambda d: benchmark.run_http(stmts, d, url, 1),
                 "config1"),
                ("http_c4", lambda d: benchmark.run_http(stmts, d, url, 4),
                 "config1"),
                ("http_q8_c4", lambda d: benchmark.run_http([q8], d, url, 4),
                 "q8"),
                ("local", lambda d: benchmark.run_local(stmts, d, session=s),
                 "config1")):
            res = fn(SERVE_S)
            prof_res, window = served_window(lambda: fn(PROFILE_S))
            if res["errors"] or prof_res["errors"] or not res["queries"]:
                raise AssertionError(f"sql_server {name}: {res['errors']} "
                                     f"errors in {res['queries']} queries")
            one = (lambda sql: http_body(port, sql)) if name != "local" \
                else (lambda sql: s.sql(sql))
            batch = [q8] * 5 if base == "q8" else stmts[:5]
            syncs, _sites = count_host_syncs(lambda: [one(q) for q in batch])
            own, _sites = count_host_syncs(
                lambda: [s.sql(q).to_rows() for q in batch])
            lat = res["latency_ms"]
            runs[name] = {"seconds": SERVE_S, "queries": res["queries"],
                          "errors": res["errors"], "qps": res["qps"],
                          "p50_ms": lat["p50"], "p90_ms": lat["p90"],
                          "p99_ms": lat["p99"], "mean_ms": lat["mean"],
                          "in_process_median_ms": inproc[base],
                          "served_minus_in_process_ms":
                              lat["p50"] - inproc[base],
                          "profiled_window": window,
                          "host_syncs_per_statement": syncs / len(batch),
                          "in_process_host_syncs_per_statement":
                              own / len(batch)}
        # the same load from a client in a process of its own (the
        # runs above share this interpreter with the server's threads)
        for conc in (1, 4):
            r = subprocess.run(
                [sys.executable, "-m", "myscaledb_tpu_torch", "benchmark",
                 "--url", url, "-c", str(conc), "-d", "5"]
                + [a for q in stmts for a in ("-q", q)],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=300)
            if r.returncode:
                raise AssertionError(f"sql_server external client: rc "
                                     f"{r.returncode}\n{r.stderr[-3000:]}")
            res = json.loads(r.stdout)
            if res["errors"] or not res["queries"]:
                raise AssertionError(f"sql_server external client: {res}")
            lat = res["latency_ms"]
            runs[f"http_c{conc}_external_client"] = {
                "seconds": 5.0, "queries": res["queries"],
                "errors": res["errors"], "qps": res["qps"],
                "p50_ms": lat["p50"], "p90_ms": lat["p90"],
                "p99_ms": lat["p99"], "mean_ms": lat["mean"],
                "in_process_median_ms": inproc["config1"],
                "served_minus_in_process_ms": lat["p50"] - inproc["config1"]}
        out["served"] = runs
        # the front end's parts at concurrency 1: the HTTP round trip of a
        # statement with no table against its in-process time, and TSV
        # rendering against to_rows() over config 1's twenty statements
        split = {}
        for name, fn in (
                ("select1_http", lambda: http_body(port, "SELECT 1")),
                ("select1_in_process", lambda: s.sql("SELECT 1").to_rows()),
                ("config1_render_tsv",
                 lambda: [render(s.sql(q), "TSV") for q in stmts]),
                ("config1_to_rows",
                 lambda: [s.sql(q).to_rows() for q in stmts])):
            lat = []
            for _ in range(5 if name.startswith("config1") else 50):
                t1 = time.perf_counter()
                fn()
                lat.append((time.perf_counter() - t1) * 1e3 /
                           (len(stmts) if name.startswith("config1") else 1))
            split[f"{name}_ms"] = float(np.median(lat))
        out["front_end_split"] = split

        # the TCP block carries a String column's whole dictionary
        tcp = {}
        for name, sql in (("int_column", "SELECT CounterID FROM hits "
                                         "LIMIT 10"),
                          ("string_column", "SELECT URL FROM hits LIMIT 10")):
            ref = s.sql(sql)
            block = encode_block(ref)
            c = TcpClient(port=servers["tcp"].server_address[1], timeout=60)
            try:
                lat = []
                for _ in range(5):
                    t1 = time.perf_counter()
                    c.query(sql)
                    lat.append((time.perf_counter() - t1) * 1e3)
            finally:
                c.close()
            tcp[name] = {"block_bytes": len(block),
                         "dictionary_values": len(
                             ref[ref.column_names[0]].dictionary.values)
                         if ref[ref.column_names[0]].dictionary is not None
                         else 0,
                         "median_ms": float(np.median(lat))}
        out["tcp_dictionary_cost"] = tcp

        # (d) the server as users start it, over config 1 written as parts
        t1 = time.perf_counter()
        TableStore(os.path.join(tmp, "data", "t"), device="cuda").insert(
            s.tables["t"], codec_overrides={"emb": "lz"})
        write_s = time.perf_counter() - t1
        repo = os.path.dirname(os.path.abspath(__file__))
        hport, tport = free_port(), free_port()
        logs = [open(os.path.join(tmp, f"server.{k}"), "w")
                for k in ("out", "err")]
        t1 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "myscaledb_tpu_torch", "server",
             "--data-dir", os.path.join(tmp, "data"), "--port", str(hport),
             "--tcp-port", str(tport),
             "--user-files", os.path.join(tmp, "user_files")],
            cwd=repo, stdout=logs[0], stderr=logs[1])

        def server_log():
            return open(os.path.join(tmp, "server.err")).read()[-4000:]
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"sql_server: the server exited "
                                     f"{proc.returncode}:\n{server_log()}")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{hport}/ping", timeout=5) as r:
                    if r.read() == b"Ok.\n":
                        break
            except OSError:
                pass
            if time.perf_counter() - t1 > 300:
                raise AssertionError(f"sql_server: no /ping in 300 s:\n"
                                     f"{server_log()}")
            time.sleep(0.05)
        ping_s = time.perf_counter() - t1
        body = http_body(hport, stmts[0]).decode()
        first_s = time.perf_counter() - t1
        ids = np.array([int(ln.split("\t")[0]) for ln in body.splitlines()])
        if not np.array_equal(ids, want_ids[0]):
            raise AssertionError(f"sql_server subprocess: ids {ids} != "
                                 f"oracle {want_ids[0]}")
        tools = {}
        for name, argv in (
                ("client", ["client", "--port", str(hport), "-q", stmts[1]]),
                ("benchmark", ["benchmark", "--url",
                               f"http://127.0.0.1:{hport}/", "-d", "5",
                               "-q", stmts[2], "-q", stmts[3]])):
            t2 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "myscaledb_tpu_torch"]
                               + argv, cwd=repo, capture_output=True,
                               text=True, timeout=300)
            tools[name] = {"rc": r.returncode,
                           "seconds": time.perf_counter() - t2}
            if r.returncode:
                raise AssertionError(f"sql_server {name}: rc {r.returncode}"
                                     f"\n{r.stderr[-3000:]}\n{server_log()}")
            if name == "client":
                ids = np.array([int(ln.split("\t")[0])
                                for ln in r.stdout.splitlines()])
                if not np.array_equal(ids, want_ids[1]):
                    raise AssertionError(f"sql_server client: ids {ids}")
            else:
                summ = json.loads(r.stdout)
                if summ["errors"] or not summ["queries"]:
                    raise AssertionError(f"sql_server benchmark: {summ}")
                tools[name].update(qps=summ["qps"],
                                   p50_ms=summ["latency_ms"]["p50"],
                                   p99_ms=summ["latency_ms"]["p99"],
                                   queries=summ["queries"])
        c = TcpClient(port=tport, timeout=60)
        try:
            n, cols = c.query("SELECT count() FROM t")
        finally:
            c.close()
        if int(cols["count()"][0][0]) != N:
            raise AssertionError(f"sql_server subprocess tcp: {cols}")
        out["subprocess"] = {"parts_write_s": write_s,
                             "seconds_to_ping": ping_s,
                             "seconds_to_first_answer": first_s,
                             "tools": tools, "tcp_count": N}
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
        for f in logs or ():
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise AssertionError("sql_server: a server thread failed:\n"
                             + "\n".join(failures)[-4000:])
    out["launches"] = totals
    emit(out)
    return totals


def _views_equal(name, rows, want) -> None:
    if rows != want:
        raise AssertionError(f"sql_views {name}: {rows[:3]} != oracle "
                             f"{want[:3]}")


def physical_dtype_np(c):
    from myscaledb_tpu_torch.core.types import physical_dtype
    return np.dtype(np.int32) if c.dictionary is not None else \
        np.dtype(physical_dtype(c.dtype))


def phase_goldens_stateless() -> int:
    """Every case of tests/test_torch_goldens_stateless.py's CASES through
    run_golden_text(connect()) on the card, each byte-identical to its
    .reference."""
    import ast
    import os
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.testing import run_golden_text
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    tree = ast.parse(open(os.path.join(
        root, "test_torch_goldens_stateless.py")).read())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "CASES")
    gdir = os.path.join(root, "goldens", "stateless")
    t0 = time.perf_counter()
    bad = []
    for name in names:
        sql = open(os.path.join(gdir, name + ".sql")).read()
        want = open(os.path.join(gdir, name + ".reference")).read() \
            .rstrip("\n").split("\n")
        if want == [""]:
            want = []
        s = P.connect()
        if s.device.type != "cuda":
            raise AssertionError(f"connect() chose {s.device}")
        if run_golden_text(s, sql) != want:
            bad.append(name)
    emit({"phase": "goldens_stateless", "cases": len(names),
          "identical": len(names) - len(bad), "differ": bad,
          "seconds": time.perf_counter() - t0})
    if bad:
        raise AssertionError(f"stateless goldens: {len(names) - len(bad)} "
                             f"of {len(names)} identical; differ: {bad}")
    return len(names)


# BASELINE config 5 (bench.py:319-345): 2M rows a shard of 768-dim f32
# embeddings, 10 queries, k = 10, 256 groups, 1M dim keys, fact keys in
# [0, 2M), vals = 1, the mask all true
N5_PER_SHARD, D5, NQ5, K5, G5, N5_DIM = 2_000_000, 768, 10, 10, 256, \
    1_000_000
DIST_SHARDS = 8
# the cut if the card cannot hold 8 shards' embeddings beside the rest
N5_SHARDS_CUT = 4
# config 5's bytes a fact row streams (bench.py): the embedding, the join
# key's exchange (read, write, read) and gid/vals
BYTES5_PER_ROW = D5 * 4 + 12 + 8
DIST_REPS = 5                    # timed runs of each distributed statement
# config 5's overlapped steps run back to back, each held bit-equal to
# the serial parts
OVERLAP_STEPS = 20
# before each of those steps every side stream spins this many cycles
# (~0.1 s at the H100's clocks, longer than the host takes to queue a
# step), so the scratch that follows the step comes before the join
# branch reads its inputs
SIDE_HOLD_CYCLES = 200_000_000
DIST_TEXT_QUERIES = 5
# sql_text's passages cut for this phase: two index builds (the table's,
# the shards') took 60 s of the phase at 1M passages; at 600k each of the
# 8 shards keeps 75,000 rows, past the 2^16 from which its scan takes K2
NT_DIST = 600_000
DIST_INSERT_ROWS = 10_000_000


def config5_step_parts(mesh, x, q, fact, dim, gid, mask, vals, sqn):
    """The fused step's parts run one at a time on the current streams
    and timed apart (CUDA events on device 0, median of 3 after a
    warm-up): the join exchange, the shard scans, the top-k merge, the
    shard join counts with their psum, the group partials and their
    merge.  Shard bodies against merge/exchange.  Returns the times and
    the serial order's five outputs (top-k distances and ids, join count,
    group states, group count), which the overlapped step must equal."""
    from myscaledb_tpu_torch.ops.aggregate import partial_aggregate_matmul
    from myscaledb_tpu_torch.parallel.mesh import psum, row_slices
    from myscaledb_tpu_torch.parallel.ops import (_merge_agg_states,
                                                  _merge_distance_topk,
                                                  _shard_distance_topk)
    from myscaledb_tpu_torch.parallel.shuffle import (_all_pair_count,
                                                      _exchange)
    nsh = mesh.size
    n_loc = x.shape[0] // nsh
    fks, dks = row_slices(mesh, fact), row_slices(mesh, dim)
    ones_f = [torch.ones_like(f, dtype=torch.bool) for f in fks]
    ones_d = [torch.ones_like(d, dtype=torch.bool) for d in dks]
    xs, sqs = row_slices(mesh, x), row_slices(mesh, sqn)
    gids, masks, vs = (row_slices(mesh, gid), row_slices(mesh, mask),
                       row_slices(mesh, vals))
    box = {}

    def exchange():
        box["f"] = _exchange(mesh, fks, [], ones_f, n_loc)
        box["d"] = _exchange(mesh, dks, [], ones_d,
                             max(dim.shape[0] // nsh, 1))

    def scans():
        box["s"] = [_shard_distance_topk(xs[p], q, None, "L2", K5, 32768, p,
                                         n_loc, sqs[p]) for p in range(nsh)]

    def topk_merge():
        box["topk"] = _merge_distance_topk([a for a, _ in box["s"]],
                                           [b for _, b in box["s"]], K5,
                                           "L2")

    def join_counts():
        (fk, _, fv), (dk, _, dv) = box["f"], box["d"]
        box["cnt"] = psum([_all_pair_count(fk[p], fv[p], dk[p], dv[p])
                           for p in range(nsh)])

    def partials():
        box["a"] = [partial_aggregate_matmul(gids[p], masks[p], (vs[p],),
                                             ("sum",), G5)
                    for p in range(nsh)]

    def agg_merge():
        box["agg"] = _merge_agg_states(("sum",), [a for a, _ in box["a"]],
                                       [b for _, b in box["a"]])
    out = {}
    for name, fn in (("exchange", exchange), ("shard_scans", scans),
                     ("topk_merge", topk_merge),
                     ("shard_join_counts_psum", join_counts),
                     ("shard_group_partials", partials),
                     ("group_merge", agg_merge)):
        out[name + "_ms"] = time_ms(fn, reps=3)
    out["shard_bodies_ms"] = out["shard_scans_ms"] + \
        out["shard_join_counts_psum_ms"] + out["shard_group_partials_ms"]
    out["merge_and_exchange_ms"] = out["exchange_ms"] + \
        out["topk_merge_ms"] + out["group_merge_ms"]
    out["sum_of_parts_ms"] = sum(v for k, v in out.items()
                                 if k.endswith("_ms") and k not in (
                                     "shard_bodies_ms",
                                     "merge_and_exchange_ms"))
    return out, (*box["topk"], box["cnt"], *box["agg"])


def config5_embeddings(mesh, n_loc: int, seed: int):
    """Config 5's embeddings as one tensor per shard on the shard's card,
    shard p's rows drawn by a generator seeded for p alone: the same
    values on any mesh of as many shards, and as the slices of
    ``config5_embeddings_whole``."""
    parts = []
    for p in range(mesh.size):
        dev = mesh.device(p)
        g = torch.Generator(device=dev).manual_seed(seed * 1000 + p)
        parts.append(torch.empty(n_loc, D5, device=dev).normal_(generator=g))
    return parts


def config5_embeddings_whole(nsh: int, n_loc: int, seed: int, device):
    """The rows of ``config5_embeddings`` over ``nsh`` shards as one
    tensor on ``device`` (each shard's slice drawn by its generator)."""
    x = torch.empty(nsh * n_loc, D5, device=device)
    for p in range(nsh):
        g = torch.Generator(device=device).manual_seed(seed * 1000 + p)
        x[p * n_loc:(p + 1) * n_loc].normal_(generator=g)
    return x


def config5_small_columns(n: int, seed: int, device):
    """Config 5's join keys, dim keys and group ids (one generator), vals
    = 1 and the mask all true, as whole tensors on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed + 15)
    fact = torch.randint(0, 2 * N5_DIM, (n,), generator=g, device=device,
                         dtype=torch.int32)
    dim = torch.randint(0, 2 * N5_DIM, (N5_DIM,), generator=g,
                        device=device, dtype=torch.int32)
    gid = torch.randint(0, G5, (n,), generator=g, device=device,
                        dtype=torch.int32)
    q = torch.randn(NQ5, D5, generator=g, device=device)
    vals = torch.ones(n, dtype=torch.int32, device=device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    return fact, dim, gid, q, vals, mask


def sync_cards() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def outputs_equal(a, b) -> bool:
    """Two fused-step outputs (distances, ids, count, states, group
    count) bit-equal, avg's (sum, count) states part by part."""
    def flat(out):
        dd, ii, cnt, states, gc = out
        parts = [dd, ii, cnt, gc]
        for st in states:
            parts += list(st) if isinstance(st, tuple) else [st]
        return parts
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        x.device == y.device and torch.equal(x, y) for x, y in zip(fa, fb))


def keys_step(m, x, q, args, sqn, fks, dks):
    """One fused step of config 5 given the key columns' parts."""
    from myscaledb_tpu_torch.parallel.pipeline import fused_topk_join_agg
    return fused_topk_join_agg(m, x, q, "L2", K5, fks, dks, args["gid"],
                               args["mask"], args["vals"], ("sum",), G5,
                               x_sqnorm=sqn)


@contextlib.contextmanager
def in_pools(pools: dict):
    """Allocations on each card routed to its private pool."""
    with contextlib.ExitStack() as stack:
        for dev, pool in pools.items():
            stack.enter_context(torch.cuda.use_mem_pool(pool, dev))
        yield


def traced_step(step, tries: int = 3):
    """One step's device events from torch.profiler.  A step runs first
    inside the window (a trace can miss its window's first events), then
    a marker kernel (``torch.cuda._sleep``, ``spin_kernel``), then the
    traced step: the events that start after the marker ends.  Tried
    again, at most ``tries`` times, where the trace lacks the marker or
    K2."""
    for _ in range(tries):
        with device_profiler() as prof:
            step()
            sync_cards()
            torch.cuda._sleep(1000)
            sync_cards()
            step()
            sync_cards()
        events = device_trace(prof)
        marks = [e.time_range.end for e in events
                 if "spin_kernel" in e.name]
        if marks:
            events = [e for e in events if e.time_range.start >= max(marks)]
            if any("segmin_f32_kernel" in e.name for e in events):
                return events
    raise AssertionError(f"config 5: {tries} traces of a step lack the "
                         "marker or K2")


def config5_overlap(m, x, q, args, sqn, serial, tag: str) -> dict:
    """The overlapped step's checks on mesh ``m``.  (1) OVERLAP_STEPS
    steps back to back with no synchronize between them.  Before each,
    every side stream spins SIDE_HOLD_CYCLES, so the step's join branch
    reads its inputs late.  Each step gets fresh copies of the key
    columns, made in a private pool of each card and dropped as the step
    returns; then scratch of the same sizes is allocated in those pools
    on the current streams and filled with -1, and scratch the size of
    the exchange buffers beside it.  A copy the join branch
    still reads must not be handed out again: no scratch block may start
    inside one (``freed_too_early``), and every step's five outputs must
    be torch.equal to ``serial``, the parts run one at a time.  (2) One
    traced step: K2 and K3 on one stream a card, the join branch's sorts
    on another; ``overlap_ms``, the step's summed device time less the
    union of its events' intervals."""
    from myscaledb_tpu_torch.parallel.mesh import row_slices
    pools = {d: torch.cuda.MemPool() for d in dict.fromkeys(m.devices)}
    outs, early = [], 0
    for _ in range(OVERLAP_STEPS):
        for side in m.side_streams().values():
            with torch.cuda.stream(side):
                torch.cuda._sleep(SIDE_HOLD_CYCLES)
        with in_pools(pools):
            fks = [t.clone() for t in row_slices(m, args["fact"])]
            dks = [t.clone() for t in row_slices(m, args["dim"])]
        spans = [(t.data_ptr(), t.data_ptr() + t.nbytes) for t in fks + dks]
        outs.append(keys_step(m, x, q, args, sqn, fks, dks))
        sizes = [(t.numel(), t.dtype, t.device) for t in fks + dks]
        del fks, dks
        with in_pools(pools):
            scratch = [torch.empty(n, dtype=dt, device=dev).fill_(-1)
                       for n, dt, dev in sizes]
        early += sum(any(a <= t.data_ptr() < b for a, b in spans)
                     for t in scratch)
        # and the exchange buffers' sizes (keys and flags) on each card
        scratch += [torch.empty(m.size * n + 1, dtype=dt,
                                device=dev).fill_(-1)
                    for n, _, dev in sizes for dt in (torch.int32,
                                                      torch.int8)]
        del scratch
    sync_cards()
    if early:
        raise AssertionError(f"config 5 {tag}: {early} scratch blocks "
                             "handed out while the join branch read them")
    bad = [i for i, o in enumerate(outs) if not outputs_equal(o, serial)]
    if bad:
        raise AssertionError(f"config 5 {tag}: overlapped steps {bad} "
                             "differ from the serial parts")
    del outs
    events = traced_step(lambda: keys_step(m, x, q, args, sqn, args["fact"],
                                           args["dim"]))
    scan = {(e.device_index, e.device_resource_id) for e in events
            if "segmin_f32_kernel" in e.name or "group_agg" in e.name}
    if len(scan) != m.n_cards:
        raise AssertionError(f"config 5 {tag}: K2 and K3 ran on streams "
                             f"{sorted(scan)}, want one a card")
    branch = [e for e in events
              if (e.device_index, e.device_resource_id) not in scan]
    if not any("sort" in e.name.lower() for e in branch):
        raise AssertionError(f"config 5 {tag}: no sort of the join "
                             "branch ran beside K2's stream")
    streams = {}
    for e in events:
        key = f"cuda:{e.device_index}/stream {e.device_resource_id}"
        streams[key] = streams.get(key, 0) + 1
    summed = sum(e.time_range.elapsed_us() for e in events)
    union = union_us(events)
    return {"steps_bit_equal_to_serial": OVERLAP_STEPS,
            "freed_too_early": early,
            "events_per_stream": streams,
            "scan_streams": len(scan),
            "join_branch_events": len(branch),
            "traced_kernel_ms_summed": summed / 1e3,
            "traced_device_union_ms": union / 1e3,
            "overlap_ms": (summed - union) / 1e3}


def phase_config5(seed: int, smi: str):
    """BASELINE config 5 at bench.py's shapes on an 8-shard mesh (4 if the
    card cannot hold 8 shards' embeddings) and on a 1-shard mesh over the
    same rows: each shard's rows a tensor of their own on its card, so
    the two layouts are made one after the other from the same per-shard
    generators (the card holds one copy of the embeddings).  The fused
    step is checked against oracles on the card (ids equal to the
    one-device scan's, distances within rtol 2e-5, the join count equal
    to a searchsorted count, group sums and counts equal to a bincount);
    its median over DIST_REPS runs after a warm-up, the time the host
    takes to queue a step (``host_queue_ms``), rows/s, K2 and K3
    launches a step, host syncs a step (0 on 8 shards, at most 1 on 1),
    the step's parts run one at a time and timed apart, and
    config5_overlap's checks of the overlapped step against those
    parts' outputs."""
    from myscaledb_tpu_torch.ops.vector import distance_scan
    from myscaledb_tpu_torch.parallel.mesh import (RowSplit, make_mesh,
                                                   shard_rows)
    from myscaledb_tpu_torch.parallel.ops import sqnorm_rows
    from myscaledb_tpu_torch.parallel.pipeline import fused_topk_join_agg
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    nsh = DIST_SHARDS
    reduced = []
    # the embeddings, their norms and ~8 GiB of exchange and sort buffers
    if N5_PER_SHARD * nsh * (D5 * 4 + 16) + (8 << 30) > free:
        reduced.append(f"{N5_SHARDS_CUT} shards, not {nsh}: "
                       f"{free / 2 ** 30:.1f} GiB free of "
                       f"{total / 2 ** 30:.1f}")
        nsh = N5_SHARDS_CUT
    n = N5_PER_SHARD * nsh
    t0 = time.perf_counter()
    mesh = make_mesh(nsh, device="cuda:0")
    fact, dim, gid, q, vals, mask = config5_small_columns(n, seed, "cuda:0")
    x1 = config5_embeddings_whole(nsh, N5_PER_SHARD, seed, "cuda:0")
    sqn1 = sqnorm_rows(x1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    # oracles on the card, outside every counted run
    ld, li = distance_scan(x1, q, "L2", K5, x_sqnorm=sqn1)
    sd = torch.sort(dim.long()).values
    want_cnt = int((torch.searchsorted(sd, fact.long(), right=True)
                    - torch.searchsorted(sd, fact.long())).sum())
    del sd
    want_gc = torch.bincount(gid.long(), minlength=G5)
    # each shard's rows summed, to hold the per-shard draw to the whole
    slice_sums = [float(x1[p * N5_PER_SHARD:(p + 1) * N5_PER_SHARD]
                        .double().sum()) for p in range(nsh)]

    def check(out, tag):
        dd, ii, cnt, states, gc = out
        if not torch.equal(ii, li):
            raise AssertionError(f"config 5 {tag}: ids differ from the "
                                 "one-device scan")
        torch.testing.assert_close(dd, ld, rtol=SQL_RTOL, atol=0)
        if int(cnt) != want_cnt:
            raise AssertionError(f"config 5 {tag}: join count {int(cnt)} "
                                 f"!= {want_cnt}")
        if not (torch.equal(states[0], want_gc)
                and torch.equal(gc, want_gc)):
            raise AssertionError(f"config 5 {tag}: group sums/counts "
                                 "differ from the bincount")

    def run(m, x, sqn):
        tag = f"{m.size}_shards"
        args = {k: (t if m.size == 1 else shard_rows(m, t)) for k, t in
                (("fact", fact), ("dim", dim), ("gid", gid),
                 ("vals", vals), ("mask", mask))}

        def step():
            return fused_topk_join_agg(m, x, q, "L2", K5, args["fact"],
                                       args["dim"], args["gid"],
                                       args["mask"], args["vals"], ("sum",),
                                       G5, x_sqnorm=sqn)
        check(step(), tag)                          # warm-up
        torch.cuda.synchronize()
        # the path's own run: counts zeroed just before, read just after
        zero_launches()
        lat, queued = [], []
        for _ in range(DIST_REPS):
            t0 = time.perf_counter()
            out = step()
            queued.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            check(out, tag)
        launches = read_launches()
        for k2k3 in ("segmin_f32", "group_aggregate"):
            if launches[k2k3] != DIST_REPS * m.size:
                raise AssertionError(
                    f"config 5 {tag}: {k2k3} launched {launches[k2k3]} "
                    f"times in {DIST_REPS} steps, want {m.size} a step")
        syncs, sync_sites = count_host_syncs(step)
        if syncs > (0 if m.size > 1 else 1):
            raise AssertionError(f"config 5 {tag}: {syncs} host syncs a "
                                 f"step ({sync_sites})")
        prof = profile_calls(step)
        med = float(np.median(lat))
        parts, serial = config5_step_parts(m, x, q, args["fact"],
                                           args["dim"], args["gid"],
                                           args["mask"], args["vals"], sqn)
        check(serial, tag + " serial parts")
        overlap = config5_overlap(m, x, q, args, sqn, serial, tag)
        return {
            **summary_ms(lat), "launches": launches,
            "launches_per_step": {k: v / DIST_REPS
                                  for k, v in launches.items() if v},
            "host_syncs_per_step": syncs, "host_sync_sites": sync_sites,
            "host_queue_ms": float(np.median(queued)),
            "distributed_pipeline_rows_per_sec_per_chip": n / (med / 1e3),
            "device_busy_share": prof["device_busy_share"],
            "device_ms_per_step": prof["device_ms_per_query"],
            "kernel_ms_summed_per_step": prof["kernel_ms_summed_per_query"],
            "top_kernels_us": prof["top_kernels_us_per_query"],
            "parts": parts, "overlap": overlap}, launches

    runs = {}
    m1 = make_mesh(1, device="cuda:0")
    runs["1_shards"], _ = run(m1, RowSplit([x1]), RowSplit([sqn1]))
    del x1, sqn1
    torch.cuda.empty_cache()
    parts = config5_embeddings(mesh, N5_PER_SHARD, seed)
    got_sums = [float(t.double().sum()) for t in parts]
    if got_sums != slice_sums:
        raise AssertionError("config 5: the per-shard draw differs from "
                             "the whole table's slices")
    x = RowSplit(parts)
    sqn = RowSplit([sqnorm_rows(t) for t in parts])
    runs[f"{nsh}_shards"], counts = run(mesh, x, sqn)
    bound = n * BYTES5_PER_ROW / HBM_BYTES_PER_S * 1e3
    out = {"shards": nsh, "rows": n, "dim": D5, "queries": NQ5, "k": K5,
           "groups": G5, "dim_keys": N5_DIM, "table_gen_s": gen_s,
           "embedding_bytes": n * D5 * 4, "reduced": reduced,
           "layout": "each shard's rows a tensor of their own on its card "
                     "(parallel/mesh.py RowSplit); the 1-shard run first, "
                     "then the same rows drawn again as 8 parts",
           "source": "BASELINE config 5 (bench.py:319-345): 2M rows a "
                     "shard, d = 768, nq = 10, k = 10, 256 groups, 1M dim "
                     "keys in [0, 2M)",
           "bound_ms": bound, "bound_by": "bytes",
           "bound_note": f"{BYTES5_PER_ROW} bytes a fact row (bench.py's "
                         "count) over 3.35 TB/s",
           "global_view_layout_median_ms": {
               f"{DIST_SHARDS}_shards": 77.081, "1_shards": 21.988,
               "note": "the earlier layout's run (one global tensor with "
                       "per-shard views; NVIDIA H100 80GB HBM3, 700.00 W; "
                       "PERF.md section 6)"},
           "runs": runs, "nvidia_smi": smi,
           "oracle": "ids equal to the one-device distance_scan, "
                     "distances rtol 2e-5; join count equal to a "
                     "searchsorted count; group sums and counts equal to "
                     "a bincount"}
    del x, sqn, parts, fact, dim, gid, vals, mask, ld, li
    torch.cuda.empty_cache()
    return out, counts


def phase_multi_card(seed: int, smi: str):
    """Where two or more cards are visible: config 5 as bench.py defines
    it, one shard a card (``make_mesh()``) at 2M rows a shard, and
    sql_distributed's config-1 and GROUP BY statements over ``make_mesh()``,
    each held equal (ids, join count, integer states, rows) to the same
    data on a one-card mesh of as many logical shards; on each mesh
    config5_overlap's checks (one side stream a card) and no host sync a
    step.  On one card it says so and runs nothing."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import Table
    from myscaledb_tpu_torch.parallel.mesh import (RowSplit, make_mesh,
                                                   shard_rows)
    from myscaledb_tpu_torch.parallel.ops import sqnorm_rows
    from myscaledb_tpu_torch.parallel.pipeline import fused_topk_join_agg
    cards = torch.cuda.device_count()
    if cards < 2:
        return {"ran": False, "cards": cards,
                "reason": f"needs two cards, {cards} visible: not run"}
    wide = make_mesh()
    narrow = make_mesh(cards, device="cuda:0")
    n = N5_PER_SHARD * cards
    fact, dim, gid, q, vals, mask = config5_small_columns(n, seed, "cuda:0")
    out = {"ran": True, "cards": cards, "rows": n, "nvidia_smi": smi,
           "peer_access": [[torch.cuda.can_device_access_peer(a, b)
                            if a != b else None for b in range(cards)]
                           for a in range(cards)]}
    results = {}
    for tag, m in (("one_shard_a_card", wide),
                   ("one_card_logical_shards", narrow)):
        parts = config5_embeddings(m, N5_PER_SHARD, seed)
        x = RowSplit(parts)
        sqn = RowSplit([sqnorm_rows(t) for t in parts])
        args = [shard_rows(m, t) for t in (fact, dim, gid, mask, vals)]

        def step(m=m, x=x, sqn=sqn, args=args):
            return fused_topk_join_agg(m, x, q, "L2", K5, args[0], args[1],
                                       args[2], args[3], args[4], ("sum",),
                                       G5, x_sqnorm=sqn)
        step()
        for d in range(cards):
            torch.cuda.synchronize(d)
        zero_launches()
        lat = []
        for _ in range(DIST_REPS):
            t0 = time.perf_counter()
            res = step()
            for d in range(cards):
                torch.cuda.synchronize(d)
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        for k2k3 in ("segmin_f32", "group_aggregate"):
            if launches[k2k3] != DIST_REPS * m.size:
                raise AssertionError(
                    f"multi-card config 5 {tag}: {k2k3} launched "
                    f"{launches[k2k3]} times in {DIST_REPS} steps, want "
                    f"{m.size} a step")
        syncs, sync_sites = count_host_syncs(step)
        if syncs:
            raise AssertionError(f"multi-card config 5 {tag}: {syncs} host "
                                 f"syncs a step ({sync_sites})")
        _, serial = config5_step_parts(m, x, q, *args, sqn)
        keys = dict(zip(("fact", "dim", "gid", "mask", "vals"), args))
        overlap = config5_overlap(m, x, q, keys, sqn, serial,
                                  f"multi-card {tag}")
        med = float(np.median(lat))
        results[tag] = res
        out[tag] = {**summary_ms(lat), "launches": launches,
                    "host_syncs_per_step": syncs,
                    "distributed_pipeline_rows_per_sec_per_chip":
                        n / (med / 1e3) / (cards if m is wide else 1),
                    "devices": [str(d) for d in m.devices],
                    "overlap": overlap}
        del parts, x, sqn, args, keys, serial
        torch.cuda.empty_cache()
    a, b = results["one_shard_a_card"], results["one_card_logical_shards"]
    if not torch.equal(a[1].cpu(), b[1].cpu()):
        raise AssertionError("multi-card config 5: ids differ from the "
                             "one-card mesh")
    torch.testing.assert_close(a[0].cpu(), b[0].cpu(), rtol=SQL_RTOL, atol=0)
    if int(a[2]) != int(b[2]) or not torch.equal(a[3][0].cpu(),
                                                 b[3][0].cpu()) \
            or not torch.equal(a[4].cpu(), b[4].cpu()):
        raise AssertionError("multi-card config 5: join count or group "
                             "states differ from the one-card mesh")
    # config 1 and GROUP BY statements over make_mesh()
    rng = np.random.default_rng(seed)
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    s = P.connect()
    s.create_table("t", data)
    for name, m in (("tw", wide), ("tn", narrow)):
        s.register(name, Table(list(s.tables["t"].columns.values())))
        s.distribute(name, m)
    queries = rng.standard_normal((5, D), dtype=np.float32)
    stmts = [f"SELECT id, distance(emb, {vec_sql(qv)}) AS d FROM {{t}} "
             "WHERE price < 50 ORDER BY d LIMIT 10" for qv in queries]
    stmts += ["SELECT price % 10 AS b, count(), sum(price), min(id), "
              "max(id) FROM {t} WHERE price > 20 GROUP BY b ORDER BY b",
              "SELECT id % 100000 AS b, count(), sum(price) FROM {t} "
              "GROUP BY b ORDER BY b LIMIT 20",
              "SELECT id, price FROM {t} WHERE price < 3 ORDER BY price "
              "DESC, id LIMIT 15"]
    sql = []
    for st in stmts:
        got = s.sql(st.format(t="tw")).to_rows()
        want = s.sql(st.format(t="tn")).to_rows()
        if "distance" in st:
            vector_rows_equal("multi-card config 1")(got, want)
        else:
            rows_equal("multi-card GROUP BY")(got, want)
        t0 = time.perf_counter()
        s.sql(st.format(t="tw")).to_rows()
        sql.append({"statement": st.format(t="t")[:80],
                    "ms_one_shard_a_card": (time.perf_counter() - t0) * 1e3})
    out["sql"] = sql
    out["check"] = ("config 5 ids, join count and integer group states "
                    "equal to the one-card mesh of as many shards, "
                    "distances rtol 2e-5; SQL rows equal (distances rtol "
                    "2e-5)")
    s.tables.clear()
    torch.cuda.empty_cache()
    return out


def dist_pair(s, stmt_local, stmt_dist, compare, reps=DIST_REPS,
              to_rows=True):
    """One statement on the undistributed table and on the distributed
    one: ``reps`` timed runs of each after a warm-up (host clock; with
    ``to_rows`` false a synchronize in place of to_rows()), the results
    held equal by ``compare(dist, local)``, then a profiler pass (busy
    share) and the host syncs of one run of each; the launch counts of
    the distributed runs (warm-up included), zeroed just before and read
    just after."""
    def run(stmt):
        res = s.sql(stmt)
        if to_rows:
            return res.to_rows()
        torch.cuda.synchronize()
        return res

    def timed(stmt):
        res = run(stmt)
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = run(stmt)
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat, res
    lat_l, res_l = timed(stmt_local)
    zero_launches()
    lat_d, res_d = timed(stmt_dist)
    launches = read_launches()
    compare(res_d, res_l)
    out = {"launches_distributed": {k: v for k, v in launches.items() if v}}
    for tag, stmt, lat in (("undistributed", stmt_local, lat_l),
                           ("distributed", stmt_dist, lat_d)):
        prof = profile_statements(s, [stmt], to_rows=to_rows)
        syncs, _ = count_host_syncs(lambda st=stmt: run(st))
        out[tag] = {**summary_ms(lat),
                    "device_busy_share": prof["device_busy_share"],
                    "device_ms_per_query": prof["device_ms_per_query"],
                    "host_syncs": syncs}
    out["distributed_over_undistributed"] = \
        out["distributed"]["median_ms"] / out["undistributed"]["median_ms"]
    return out, launches


def rows_equal(tag):
    def check(got, want):
        if got != want:
            raise AssertionError(f"sql_distributed {tag}: {got[:3]} != "
                                 f"undistributed {want[:3]}")
    return check


def vector_rows_equal(tag):
    """ids equal, distances within rtol 2e-5: the shards' scans sum in
    other shapes than the one-device scan (ROADMAP section 3)."""
    def check(got, want):
        if [r[0] for r in got] != [r[0] for r in want]:
            raise AssertionError(f"sql_distributed {tag}: ids differ")
        np.testing.assert_allclose([r[1] for r in got],
                                   [r[1] for r in want], rtol=SQL_RTOL,
                                   atol=0)
    return check


def tables_equal(tag):
    """Two join results equal as multisets of rows on the card: both
    sorted by their unique id column (a shuffle join's rows come in its
    shards' received order, a LEFT join's unmatched rows after the
    matched ones undistributed and among them broadcast), then each
    column's NULLs equal and its values equal where not NULL."""
    def check(got, want):
        if got.n_rows != want.n_rows or \
                got.column_names != want.column_names:
            raise AssertionError(f"sql_distributed {tag}: {got.n_rows} "
                                 f"rows {got.column_names} != "
                                 f"{want.n_rows} {want.column_names}")
        got = got.take(torch.sort(got["id"].data).indices)
        want = want.take(torch.sort(want["id"].data).indices)
        for name in want.column_names:
            a, b = got[name], want[name]
            ones = torch.ones(a.data.shape[0], dtype=torch.bool,
                              device=a.data.device)
            va = ones if a.valid is None else a.valid
            vb = ones if b.valid is None else b.valid
            if not torch.equal(va, vb) or \
                    not torch.equal(a.data[va], b.data[vb]):
                raise AssertionError(f"sql_distributed {tag}: column "
                                     f"{name} differs")
    return check


def add_counts(totals, launches):
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def dist_config1(seed, mesh):
    """Config 1 (1M x 128, WHERE price < 50, k = 10) distributed: sql_sq8's
    statement over 20 query vectors on both tables; K2 in every shard."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import Table
    rng = np.random.default_rng(seed)
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    s = P.connect()
    s.create_table("t", data)
    s.register("td", Table(list(s.tables["t"].columns.values())))
    s.distribute("td", mesh)
    x, price = s.tables["t"]["emb"].data, s.tables["t"]["price"].data
    stmt = ("SELECT id, distance(emb, {q}) AS d FROM {t} WHERE price < 50 "
            "ORDER BY d LIMIT 10")
    queries = rng.standard_normal((20, D), dtype=np.float32)
    s.sql(stmt.format(q=vec_sql(queries[0]), t="t")).to_rows()
    s.sql(stmt.format(q=vec_sql(queries[0]), t="td")).to_rows()
    lat = {"t": [], "td": []}
    rows = {"t": [], "td": []}

    def run(t):
        for qv in queries:
            t0 = time.perf_counter()
            rows[t].append(s.sql(stmt.format(q=vec_sql(qv), t=t)).to_rows())
            lat[t].append((time.perf_counter() - t0) * 1e3)
    run("t")
    zero_launches()
    run("td")
    launches = read_launches()
    for qv, got, want in zip(queries, rows["td"], rows["t"]):
        vector_rows_equal("config 1")(got, want)
        want_ids, want_d = oracle(x, price, torch.as_tensor(qv,
                                                            device="cuda"), K)
        if [r[0] for r in got] != want_ids.tolist():
            raise AssertionError("sql_distributed config 1: ids differ from "
                                 "the oracle")
    if launches["segmin_f32"] != 20 * mesh.size:
        raise AssertionError(f"sql_distributed config 1: segmin_f32 "
                             f"launched {launches['segmin_f32']} times over "
                             f"20 statements of {mesh.size} shards, not "
                             f"once a shard and statement")
    qs = [stmt.format(q=vec_sql(qv), t=t) for qv in queries[:3]
          for t in ("t", "td")]
    prof = {t: profile_statements(s, qs[i::2]) for i, t in
            enumerate(("t", "td"))}
    syncs = {t: count_host_syncs(lambda t=t: s.sql(qs[0 if t == "t" else 1])
                                 .to_rows())[0] for t in ("t", "td")}
    out = {"rows": N, "dim": D, "k": K, "queries": 20,
           "statement": stmt.format(q="[...]", t="td"),
           "undistributed": {**summary_ms(lat["t"]),
                             "device_busy_share":
                                 prof["t"]["device_busy_share"],
                             "host_syncs": syncs["t"]},
           "distributed": {**summary_ms(lat["td"]),
                           "device_busy_share":
                               prof["td"]["device_busy_share"],
                           "host_syncs": syncs["td"]},
           "launches": launches,
           "check": "ids equal to the undistributed table's and the "
                    "oracle's, distances rtol 2e-5"}
    s.tables.clear()
    torch.cuda.empty_cache()
    return out, launches


def dist_hits(seed, mesh):
    """The 100M-row hits table and its distributed twin (sharing its
    columns): sql_hits' seven statements, Q8, ClickBench's Q16 (17.6M
    UserID groups: the shuffle GROUP BY) and an ORDER BY ... LIMIT 100
    (per-shard top-n), each against the undistributed table; then a
    10M-row INSERT ... SELECT into the distributed table, count() and
    sum() against the oracle."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import Table
    from myscaledb_tpu_torch.runtime import metrics as M
    t0 = time.perf_counter()
    table, _urls = hits_table(seed)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    s = P.connect()
    s.settings.max_memory_bytes_per_query = 32 << 30
    s.register("hits", table)
    s.register("hits_d", Table(list(table.columns.values())))
    s.distribute("hits_d", mesh)
    statements = dict(HITS_STATEMENTS)
    statements["q8"] = Q8_SQL.format(t="hits", sample="")
    statements["q16_users"] = ("SELECT UserID, count() AS c FROM hits "
                               "GROUP BY UserID ORDER BY c DESC, UserID "
                               "LIMIT 10")
    statements["topn_100"] = ("SELECT UserID, EventTime, URL FROM hits "
                              "WHERE URL LIKE '%google%' ORDER BY EventTime "
                              "LIMIT 100")
    per, totals = {}, {}
    for name, stmt in statements.items():
        events = M.events_snapshot()
        per[name], launches = dist_pair(
            s, stmt, stmt.replace("FROM hits", "FROM hits_d"),
            rows_equal(f"hits {name}"))
        after = M.events_snapshot()
        per[name]["distributed_events"] = {
            k: after.get(k, 0) - events.get(k, 0)
            for k in ("DistributedTopNQueries", "DistributedShuffleGroupBy")}
        add_counts(totals, launches)
    if not per["q16_users"]["distributed_events"]["DistributedShuffleGroupBy"]:
        raise AssertionError("sql_distributed hits q16_users: the shuffle "
                             "GROUP BY did not run")
    if not per["topn_100"]["distributed_events"]["DistributedTopNQueries"]:
        raise AssertionError("sql_distributed hits topn_100: the per-shard "
                             "top-n did not run")
    # distributed INSERT of a 10M-row batch
    width = table["ResolutionWidth"].data
    want = [(NH + DIST_INSERT_ROWS,
             int(width.sum(dtype=torch.int64)) +
             int(width[:DIST_INSERT_ROWS].sum(dtype=torch.int64)))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.sql(f"INSERT INTO hits_d SELECT * FROM hits LIMIT {DIST_INSERT_ROWS}")
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    got = s.sql("SELECT count(), sum(ResolutionWidth) FROM hits_d").to_rows()
    if got != want:
        raise AssertionError(f"sql_distributed hits insert: {got} != {want}")
    td = s.tables["hits_d"]
    out = {"rows": NH, "table_gen_s": gen_s, "statements": statements,
           "per_statement": per, "launches": totals,
           "insert": {"rows": DIST_INSERT_ROWS, "seconds": insert_s,
                      "rows_per_s": DIST_INSERT_ROWS / insert_s,
                      "padded_rows_after": td.n_rows,
                      "real_rows_after": td.real_rows,
                      "count_sum": got[0]},
           "check": "rows equal to the undistributed table's; after the "
                    "INSERT count() and sum(ResolutionWidth) equal to the "
                    "columns' own"}
    s.tables.clear()
    del table, td, width
    torch.cuda.empty_cache()
    return out, totals


def dist_joins(seed, mesh):
    """sql_join's fact (10M) and dim (1M) tables: each statement on the
    undistributed pair, with the fact table distributed and the dim under
    the broadcast threshold (broadcast), and with both distributed and the
    threshold under 1M (shuffle); the results' rows equal (a shuffle's as
    a multiset: its rows come in received order)."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import Table
    from myscaledb_tpu_torch.runtime.tracing import (clear_span_log,
                                                     span_log_snapshot)
    rng = np.random.default_rng(seed + 5)
    dim_k = ((np.arange(NJ_DIM, dtype=np.int64) * SPREAD) & 0x7FFFFFFF) \
        .astype(np.int32)
    u = rng.random(NJ_FACT, dtype=np.float32)
    fact_k = ((((u * u * np.float32(2 * NJ_DIM)).astype(np.int64) * SPREAD)
               & 0x7FFFFFFF)).astype(np.int32)
    s = P.connect()
    s.settings.max_memory_bytes_per_query = 8 << 30
    s.create_table("f", {"id": np.arange(NJ_FACT, dtype=np.int64),
                         "k": fact_k,
                         "v": rng.integers(-1000, 1000, NJ_FACT,
                                           dtype=np.int32)})
    s.create_table("d", {"k": dim_k,
                         "c": rng.integers(0, 100, NJ_DIM, dtype=np.int32)})
    for src, dst in (("f", "fd"), ("d", "dd")):
        s.register(dst, Table(list(s.tables[src].columns.values())))
        s.distribute(dst, mesh)
    shuffle_thr = NJ_DIM // 2
    statements = {
        "inner_any": "SELECT id, c FROM {f} ANY INNER JOIN {d} "
                     "ON {f}.k = {d}.k",
        "inner_all": "SELECT id, c FROM {f} ALL INNER JOIN {d} "
                     "ON {f}.k = {d}.k",
        "left": "SELECT id, c FROM {f} LEFT JOIN {d} ON {f}.k = {d}.k",
        "semi": "SELECT id FROM {f} SEMI LEFT JOIN {d} ON {f}.k = {d}.k",
        "anti": "SELECT id FROM {f} ANTI LEFT JOIN {d} ON {f}.k = {d}.k",
        "aggregate": "SELECT count(), sum(v), sum(c) FROM {f} INNER JOIN "
                     "{d} ON {f}.k = {d}.k"}
    per, totals = {}, {}
    for name, stmt in statements.items():
        local = stmt.format(f="f", d="d")
        agg = name == "aggregate"
        for strategy, f, d, extra in (
                ("broadcast", "fd", "d", ""),
                ("shuffle", "fd", "dd", " SETTINGS "
                 f"distributed_broadcast_join_threshold = {shuffle_thr}")):
            dist = stmt.format(f=f, d=d) + extra
            check = rows_equal(f"join {name} {strategy}") if agg else \
                tables_equal(f"join {name} {strategy}")
            clear_span_log()
            per[f"{name}_{strategy}"], launches = dist_pair(
                s, local, dist, check, reps=3, to_rows=agg)
            spans = {sp.name for sp in span_log_snapshot()}
            if f"{strategy}_join" not in spans:
                raise AssertionError(f"sql_distributed join {name}: the "
                                     f"{strategy} join did not run")
            add_counts(totals, launches)
    out = {"fact_rows": NJ_FACT, "dim_rows": NJ_DIM,
           "broadcast_threshold": s.settings
           .distributed_broadcast_join_threshold,
           "shuffle_threshold_set": shuffle_thr, "statements": statements,
           "per_statement": per, "launches": totals,
           "check": "rows equal as multisets (sorted by the unique id), "
                    "NULLs equal; the aggregate's rows equal"}
    s.tables.clear()
    torch.cuda.empty_cache()
    return out, totals


def dist_text(seed, mesh):
    """sql_text's passage table (cut to NT_DIST passages) and its
    distributed twin: TextSearch OR
    and AND and under WHERE price < 50 with rows and scores bit-equal to
    the undistributed table's, HybridSearch RRF bit-equal and RSF with ids
    equal and scores within its fusion tolerance; the per-shard BM25
    indexes built apart (timed)."""
    import myscaledb_tpu_torch as P
    from myscaledb_tpu_torch.core.table import Column, Table
    from myscaledb_tpu_torch.core.types import DataType, Field
    from myscaledb_tpu_torch.text.distributed import _shard_indexes
    t0 = time.perf_counter()
    passages, tok_doc, tok_word, wtable, wlen, cdf, g = text_corpus(
        seed, NT_DIST)
    del tok_doc, tok_word
    emb = torch.randn(NT_DIST, DT, generator=g, device="cuda")
    price = torch.rand(NT_DIST, generator=g, device="cuda") * 100
    body = Column.from_numpy("body", np.array(passages, dtype=object),
                             DataType.STRING, device="cuda")
    del passages
    cols = [Column.from_numpy("id", np.arange(NT_DIST, dtype=np.int64),
                              device="cuda"),
            body, Column(Field("price", DataType.FLOAT32), price),
            Column(Field("emb", DataType.FLOAT32_VECTOR, vector_dim=DT),
                   emb)]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    s = P.connect()
    s.register("p", Table(cols))
    s.register("pd", Table(list(cols)))
    s.distribute("pd", mesh)
    t0 = time.perf_counter()
    s.text_index("p", "body")
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = _shard_indexes(s, "pd", s.tables["pd"], "body")
    shards_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 16)
    u = torch.as_tensor(rng.random(4 * DIST_TEXT_QUERIES), device="cuda")
    words = word_strings(wtable, wlen, torch.searchsorted(cdf, u)
                         .clamp(max=NT_WORDS - 1))
    texts = [" ".join(words[4 * i:4 * i + 4])
             for i in range(DIST_TEXT_QUERIES)]
    qvecs = [vec_sql(v) for v in (emb[torch.as_tensor(
        rng.integers(0, NT_DIST, DIST_TEXT_QUERIES), device="cuda")] + 0.5)
        .cpu().numpy()]
    kinds = {
        "text_or": ("SELECT id, TextSearch(body, '{w}') AS s FROM {t} "
                    "ORDER BY s DESC LIMIT 10", rows_equal),
        "text_and": ("SELECT id, TextSearch('operator=AND')(body, '{w}') "
                     "AS s FROM {t} ORDER BY s DESC LIMIT 10", rows_equal),
        "text_where": ("SELECT id, TextSearch(body, '{w}') AS s FROM {t} "
                       "WHERE price < 50 ORDER BY s DESC LIMIT 10",
                       rows_equal),
        "hybrid_rrf": ("SELECT id, HybridSearch('fusion_type=rrf')(emb, "
                       "body, {v}, '{w}') AS s FROM {t} WHERE price < 50 "
                       "ORDER BY s DESC LIMIT 10", rows_equal),
        "hybrid_rsf": ("SELECT id, HybridSearch('fusion_type=rsf')(emb, "
                       "body, {v}, '{w}') AS s FROM {t} WHERE price < 50 "
                       "ORDER BY s DESC LIMIT 10", None)}
    per, totals = {}, {}
    for name, (stmt, make_check) in kinds.items():
        lat = {"p": [], "pd": []}
        rows = {"p": [], "pd": []}

        def run(t):
            for w, v in zip(texts, qvecs):
                sql = stmt.format(w=w, v=v, t=t)
                s.sql(sql).to_rows()                  # warm-up
                t0 = time.perf_counter()
                rows[t].append(s.sql(sql).to_rows())
                lat[t].append((time.perf_counter() - t0) * 1e3)
        run("p")
        zero_launches()
        run("pd")
        launches = read_launches()
        bit_equal = rows["pd"] == rows["p"]
        for got, want in zip(rows["pd"], rows["p"]):
            if make_check is not None:
                make_check(f"text {name}")(got, want)
            else:
                # RSF normalizes distances the shards' scans sum in other
                # shapes (ROADMAP section 3)
                if [r[0] for r in got] != [r[0] for r in want]:
                    raise AssertionError(f"sql_distributed text {name}: "
                                         "ids differ")
                np.testing.assert_allclose(
                    [r[1] for r in got], [r[1] for r in want],
                    atol=FUSION_ATOL["RSF"], rtol=0)
        # each distributed statement (warm-up and timed) scans every shard
        # once with K2 where it fuses vectors, and TextSearch never
        want_k2 = 2 * DIST_TEXT_QUERIES * mesh.size \
            if name.startswith("hybrid") else 0
        if launches["segmin_f32"] != want_k2:
            raise AssertionError(f"sql_distributed text {name}: segmin_f32 "
                                 f"launched {launches['segmin_f32']} times, "
                                 f"not {want_k2}")
        add_counts(totals, launches)
        one = {t: stmt.format(w=texts[0], v=qvecs[0], t=t)
               for t in ("p", "pd")}
        per[name] = {"bit_equal": bool(bit_equal), "launches": launches}
        for tag, t in (("undistributed", "p"), ("distributed", "pd")):
            prof = profile_statements(s, [one[t]])
            per[name][tag] = {
                **summary_ms(lat[t]),
                "device_busy_share": prof["device_busy_share"],
                "host_syncs": count_host_syncs(
                    lambda sql=one[t]: s.sql(sql).to_rows())[0]}
    out = {"passages": NT_DIST,
           "reduced": [f"{NT_DIST} of sql_text's {NT} passages: two "
                       "index builds took 60 s of the phase at 1M; a "
                       "shard's 75,000 rows still take K2"], "dim": DT, "queries": DIST_TEXT_QUERIES,
           "table_gen_s": gen_s, "undistributed_index_s": index_s,
           "shard_indexes_s": shards_s,
           "shard_docs": [ix.n_docs for ix in shards],
           "per_statement": per, "launches": totals,
           "check": "TextSearch and HybridSearch RRF rows and scores "
                    "bit-equal to the undistributed table's; RSF ids "
                    f"equal, scores within {FUSION_ATOL['RSF']}"}
    s.tables.clear()
    del emb, price, body, cols, shards
    torch.cuda.empty_cache()
    return out, totals


def phase_sql_distributed(seed: int):
    """Distribution on the card, 8 logical shards on one device: (a) the
    dry run of every distributed path at small shapes; (b) BASELINE
    config 5's fused step (phase_config5); (c) SQL over distributed
    tables against their undistributed copies in the same run: config 1,
    the hits table (with a distributed INSERT), sql_join's joins
    (broadcast and shuffle) and sql_text's text and hybrid search."""
    from myscaledb_tpu_torch.parallel.dryrun import dryrun_multichip
    from myscaledb_tpu_torch.parallel.mesh import make_mesh
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dry = dryrun_multichip(DIST_SHARDS)
    dry["seconds"] = time.perf_counter() - t0
    config5, counts = phase_config5(seed, smi)
    # each part's line as it ends; the phase line repeats them all
    emit({"phase": "sql_distributed.config5", **config5})
    multi = phase_multi_card(seed, smi)
    emit({"phase": "sql_distributed.multi_card", **multi})
    mesh = make_mesh(DIST_SHARDS)
    sql, totals = {}, {}
    for name, fn in (("config1", dist_config1), ("hits", dist_hits),
                     ("joins", dist_joins), ("text", dist_text)):
        t0 = time.perf_counter()
        sql[name], launches = fn(seed, mesh)
        sql[name]["seconds"] = time.perf_counter() - t0
        emit({"phase": f"sql_distributed.{name}", **sql[name]})
        add_counts(totals, launches)
    emit({"phase": "sql_distributed", "shards": DIST_SHARDS,
          "mesh": f"{DIST_SHARDS} shards on {mesh.n_cards} card(s), each "
                  "shard's rows a tensor of their own on its card "
                  "(parallel/mesh.py)",
          "dryrun": dry, "config5": config5, "multi_card": multi,
          "sql": sql,
          "sql_launches": totals, "launches": counts,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
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
    emit({"device_count": torch.cuda.device_count()})

    from concurrent.futures import ThreadPoolExecutor
    from myscaledb_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the host library (c++) compiles beside the kernels (nvcc)
        host = pool.submit(build.host_library)
        build.build()
        build.library()
        host_lib = host.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(build.library_path().name),
          "host_library": host_lib.name,
          "ptxas": ptxas_summary(build.BUILD_LOG)})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    report, timings, extra = phase_kernels(gen)
    emit({"phase": "kernels", "rows": N, "dim": D, **extra,
          "tolerance": {"segmin_sq8": [SQ8_RTOL, SQ8_ATOL],
                        "segmin_f32": [F32_RTOL, F32_ATOL],
                        "group_aggregate": [K3_RTOL, K3_ATOL],
                        "merge_count": "equal counts",
                        "binary_segment_mins": "bit-equal"},
          "checks": report,
          "timing_L2_50pct_mask": {f"{k}/nq={nq}": v
                                   for (k, nq), v in timings.items()
                                   if k not in ("group_aggregate",
                                                "distinct_count")},
          "timing_distinct_count_mix5": {
              f"G={G}": t for (k, G), t in timings.items()
              if k == "distinct_count"},
          "timing_group_aggregate_config2": timings[("group_aggregate", 1)],
          "timing_merge_count_config4": timings[("merge_count", 1)],
          "timing_binary_segment_mins_config6": {
              f"nq={nq}": timings[("binary_segment_mins", nq)]
              for nq in (1, 10)},
          "kernels": ["segmin_sq8", "segmin_f32", "group_aggregate",
                      "merge_count", "binary_segment_mins",
                      "distinct_count"]})

    counts = phase_sql(args.seed)
    counts["sql_groupby"] = phase_groupby(args.seed)
    counts["join_count"] = phase_join_count(args.seed)
    counts["sql_join"] = phase_sql_join(args.seed)
    counts["sql_binary"] = phase_sql_binary(args.seed)
    counts.update(phase_sql_ddl(args.seed))
    phase_goldens_vector()
    counts["sql_topn"] = phase_sql_topn(args.seed)
    counts["sql_window"] = phase_sql_window(args.seed)
    counts["sql_hits"] = phase_sql_hits(args.seed)
    counts["sql_arrays"] = phase_sql_arrays(args.seed)
    counts["sql_subquery"] = phase_sql_subquery(args.seed)
    counts["sql_text"] = phase_sql_text(args.seed)
    counts["sql_storage"] = phase_sql_storage(args.seed)
    counts["sql_views"] = phase_sql_views(args.seed)
    counts["sql_formats"] = phase_sql_formats(args.seed)
    counts["sql_server"] = phase_sql_server(args.seed)
    counts["sql_distributed"] = phase_sql_distributed(args.seed)
    phase_goldens_stateless()

    summary = []
    # each kernel's launches come from the run of the path that takes it:
    # K1 from the certified main path (sql_sq8), K2 from the path where the
    # certificate fails (sql_f32), K3 from config 2's statement
    # (sql_groupby), K4 from config 4's count probe (join_count), K5 from
    # config 6's statement (sql_binary), K6 from the hits statements'
    # distinct counts (sql_hits); every path's counts of it are printed
    # beside
    for name, path, src, replaces in (
            ("segmin_sq8", "sql_sq8", "myscaledb_tpu_torch/csrc/segmin_sq8.cu",
             "myscaledb_tpu/ops/pallas/distance_q.py:103"),
            ("segmin_f32", "sql_f32", "myscaledb_tpu_torch/csrc/segmin_f32.cu",
             "myscaledb_tpu/ops/pallas/distance.py:77"),
            ("group_aggregate", "sql_groupby",
             "myscaledb_tpu_torch/csrc/group_agg.cu",
             "myscaledb_tpu/ops/pallas/group_agg.py:190"),
            ("merge_count", "join_count",
             "myscaledb_tpu_torch/csrc/merge_count.cu",
             "myscaledb_tpu/ops/pallas/merge_count.py:259"),
            ("binary_segment_mins", "sql_binary",
             "myscaledb_tpu_torch/csrc/binary_scan.cu",
             "myscaledb_tpu/ops/pallas/binary_scan.py:79"),
            ("distinct_count", "sql_hits",
             "myscaledb_tpu_torch/csrc/distinct_count.cu",
             "none: the sorts of myscaledb_tpu/sql/agg_fns.py's distinct "
             "counts")):
        if counts[path][name] < 1:
            raise AssertionError(f"{name} never launched on path {path}")
        t = timings[(name, 1)]          # each path scans one query
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "path": path,
                        "launches": counts[path][name],
                        "launches_by_path": {p: c[name]
                                             for p, c in counts.items()},
                        "max_abs_err": report[name]["max_abs_err"],
                        "ms": t["ms"], "kernel_ms": t["kernel_ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        "library_note": t.get("library_note"),
                        "at_other_nq": {
                            f"nq={nq}": {k: v for k, v in tt.items()
                                         if k != "library_note"}
                            for (kn, nq), tt in sorted(timings.items())
                            if kn == name and nq != 1}})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
