"""The aggregation slice end to end on the CPU: one data dict into
myscaledb_tpu.connect() and myscaledb_tpu_torch.connect(device="cpu"), the
same SQL through both, compared on to_rows() and sql_tsv().

Covers the range (small integer keys), dictionary (strings) and hash
(wide, multi-column and float keys) group-id paths, K3 (G <= 256) and the
matmul path (G > 256, per-argument validity), the scatter path
(min/max/any, wide and unsigned sums), HAVING, ORDER BY an aggregate, the
-If combinators, ROLLUP/CUBE/GROUPING SETS/WITH TOTALS, DISTINCT, a
host-resident table (streaming aggregation) and result types."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)

N = 2000
TAGS = ["red", "green", "blue", None]
FKEYS = np.array([0.0, -0.0, 1.5, -2.25, np.nan, 7.0], dtype=np.float32)


def _data(rng):
    wide = rng.integers(-10 ** 12, 10 ** 12, 12)
    return {
        "g": rng.integers(0, 17, N).astype(np.int32),
        "v": rng.integers(-1000, 1000, N).astype(np.int32),
        "u": rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
        "u16": rng.integers(0, 2 ** 16, N).astype(np.uint16),
        "f": rng.standard_normal(N).astype(np.float32),
        "tag": [TAGS[i] for i in rng.integers(0, 4, N)],
        "k2": wide[rng.integers(0, len(wide), N)].astype(np.int64),
        "h": rng.integers(0, 4096, N).astype(np.int32),
        "fk": FKEYS[rng.integers(0, len(FKEYS), N)],
    }


@pytest.fixture(scope="module")
def sessions():
    data = _data(np.random.default_rng(11))
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("t", data)
    p.create_table("t", data)
    return j, p


def _exact(rows):
    """Rows by repr, so that NaN equals NaN and -0.0 differs from 0.0."""
    return [tuple(repr(x) for x in r) for r in rows]


def _rows_close(a, b):
    """Rows equal except floats, which agree within the JAX group-aggregate
    test's own tolerance against f64 (rtol 1e-4, atol 1e-3): f32 sums taken
    in another order."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float):
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-3)
            else:
                assert x == y


EXACT_SQL = [
    # BASELINE config 2's statement (range path, K3 with the sum/avg dedupe)
    "SELECT g, sum(v), count(), avg(v) FROM t WHERE v > -500 GROUP BY g "
    "ORDER BY g",
    # dictionary path, NULL group included
    "SELECT tag, count(), sum(v) FROM t GROUP BY tag",
    # hash paths: a wide Int64 key, two keys, a float key (-0.0, NaN)
    "SELECT k2, count(), sum(v) FROM t GROUP BY k2 ORDER BY k2",
    "SELECT g, tag, count(), max(v) FROM t WHERE g < 5 GROUP BY g, tag",
    "SELECT fk, count(), sum(v) FROM t GROUP BY fk",
    # global aggregates, over all rows and over an empty selection
    "SELECT count(), sum(v), avg(v), min(v), max(v) FROM t",
    "SELECT count(), sum(v), avg(v), min(v), max(v) FROM t WHERE v > 5000",
    "SELECT count(), sum(v), max(f) FROM t WHERE v > 990 AND v < 980",
    # HAVING and ORDER BY an aggregate
    "SELECT g, count() AS c FROM t GROUP BY g HAVING c > 115 "
    "ORDER BY c DESC, g",
    "SELECT g, sum(v) AS s FROM t GROUP BY g ORDER BY s LIMIT 5",
    "SELECT g, sum(v) FROM t GROUP BY g HAVING sum(v) > 0 AND count() < 125",
    # -If combinators (own validity: the matmul path) and a Nullable arg
    "SELECT g, countIf(v > 0), sumIf(v, v < 0), avgIf(v, g < 5), "
    "minIf(v, v > 100), maxIf(u, v > 0) FROM t GROUP BY g",
    "SELECT count(tag), count() FROM t",
    "SELECT g, count(tag), count() FROM t GROUP BY g",
    # result types: sum(Int32) Int64, sum(UInt32/UInt16) UInt64, avg Float64
    "SELECT sum(v), sum(u), sum(u16), avg(v), avg(u), sum(toInt64(v)) "
    "FROM t",
    # scatter path: min/max/any, unsigned and Date-free extremes (any()
    # of a String: tests/test_torch_sql_faults.py, where the port returns
    # the string and the JAX package its dictionary id)
    "SELECT g, min(v), max(v), any(v), min(u), max(u16) FROM t GROUP BY g",
    # group modifiers
    "SELECT g, tag, sum(v) FROM t WHERE g < 3 GROUP BY g, tag WITH ROLLUP",
    "SELECT g, tag, count() FROM t WHERE g < 3 GROUP BY CUBE(g, tag)",
    "SELECT g, tag, count() FROM t WHERE g < 4 "
    "GROUP BY GROUPING SETS ((g), (tag))",
    "SELECT g, sum(v) FROM t WHERE g < 6 GROUP BY g WITH TOTALS",
    # DISTINCT
    "SELECT DISTINCT g FROM t ORDER BY g",
    "SELECT DISTINCT tag, g < 5 AS lo FROM t ORDER BY tag, lo",
    "SELECT DISTINCT fk FROM t",
    # G > 256 (range path into the matmul histogram)
    "SELECT h, count(), sum(v), avg(v) FROM t GROUP BY h ORDER BY h "
    "LIMIT 40",
    # expressions over the aggregated table and over the keys
    "SELECT g, sum(v) / count() AS m, max(v) - min(v) AS r FROM t "
    "GROUP BY g ORDER BY m",
    "SELECT v % 7 AS k, count() FROM t GROUP BY k",
]


@pytest.mark.parametrize("sql", EXACT_SQL)
def test_sql_tsv_and_rows_match(sessions, sql):
    j, p = sessions
    # the JAX package floors %, the port truncates as ClickHouse does
    # (ROADMAP section 3): its side runs the truncating form spelled out
    jsql = sql.replace("v % 7", "if(v < 0, -((-v) % 7), v % 7)")
    assert p.sql_tsv(sql) == j.sql_tsv(jsql)
    assert _exact(p.sql(sql).to_rows()) == _exact(j.sql(jsql).to_rows())


FLOAT_SQL = [
    # K3's float path, alone and beside int arguments
    "SELECT g, sum(f), avg(f), sum(v), count() FROM t GROUP BY g",
    "SELECT sum(f), avg(f) FROM t WHERE v > 0",
    # the matmul path's float rows (G > 256, and own validity)
    "SELECT h, sum(f) FROM t GROUP BY h ORDER BY h LIMIT 30",
    "SELECT tag, sumIf(f, v > 0) FROM t GROUP BY tag",
]


@pytest.mark.parametrize("sql", FLOAT_SQL)
def test_float_aggregates_match(sessions, sql):
    j, p = sessions
    _rows_close(p.sql(sql).to_rows(), j.sql(sql).to_rows())


def test_result_types_match(sessions):
    j, p = sessions
    sql = ("SELECT g, sum(v), sum(u), sum(u16), sum(f), avg(v), count(), "
           "min(u), max(u16), any(v), countIf(v > 0) FROM t GROUP BY g")
    want = [c.dtype.value for c in j.sql(sql).columns.values()]
    got = [c.dtype.value for c in p.sql(sql).columns.values()]
    assert got == want
    assert got[1:6] == ["Int64", "UInt64", "UInt64", "Float32", "Float64"]


def test_totals_carried_on_the_result(sessions):
    j, p = sessions
    sql = "SELECT g, count() FROM t WHERE g < 3 GROUP BY g WITH TOTALS"
    assert p.sql(sql).totals.to_rows() == j.sql(sql).totals.to_rows()


def test_host_resident_table_streams(sessions):
    """Columns over the device budget stay on the host; the aggregation
    streams them through the device in chunks and merges the states."""
    data = _data(np.random.default_rng(5))
    settings = dict(max_hbm_bytes_per_column=1024, stream_chunk_rows=1000)
    j = myscaledb_tpu.connect(myscaledb_tpu.config.Settings(**settings))
    p = myscaledb_tpu_torch.connect(
        myscaledb_tpu_torch.config.Settings(**settings), device="cpu")
    j.create_table("s", data)
    p.create_table("s", data)
    assert p.tables["s"]["v"].is_host
    for sql in ("SELECT g, sum(v), count(), min(v), max(u), avg(v) FROM s "
                "GROUP BY g",
                "SELECT count(), sum(v), max(v) FROM s WHERE v > 5000"):
        assert p.sql_tsv(sql) == j.sql_tsv(sql)


def test_not_ported_aggregates_name_their_slice(sessions):
    """The -State/-Merge combinators, once held for the breadth slice, give
    the JAX package's state strings and merged values."""
    j, p = sessions
    for sql in ("SELECT uniqState(v) FROM t",
                "SELECT g, sumMerge(st) FROM (SELECT g, sumState(v) AS st "
                "FROM t GROUP BY g) GROUP BY g ORDER BY g",
                "SELECT quantileTDigestState(0.5)(v) FROM t",
                "SELECT sumState(v) FROM t"):
        assert p.sql_tsv(sql) == j.sql_tsv(sql), sql
    with pytest.raises(Exception) as want:
        j.sql("SELECT g, sumMerge(v) FROM t GROUP BY g")
    with pytest.raises(myscaledb_tpu_torch.ExecError,
                       match=r"^sumMerge expects a state column$") as got:
        p.sql("SELECT g, sumMerge(v) FROM t GROUP BY g")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sql", [
    "SELECT g, sum(sum(v)) FROM t GROUP BY g",
    "SELECT 1 AS c, count() FROM t GROUP BY c",
])
def test_error_texts_match(sessions, sql):
    j, p = sessions
    with pytest.raises(Exception) as je:
        j.sql(sql)
    with pytest.raises(Exception) as pe:
        p.sql(sql)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("where,compacts", [
    ("v < -800", True), ("v > -800", False), ("", False)])
def test_selective_where_reduces_the_kept_rows_only(where, compacts):
    """From 2^16 rows a WHERE that keeps under half of them has the
    grouped aggregation read the kept rows only, on every route (K3 with
    17 groups, the matmul histogram and the scatter with 4096); the rows
    equal the JAX package's whether it compacts or not."""
    from myscaledb_tpu_torch.sql import executor
    rng = np.random.default_rng(4)
    n = executor.COMPACT_MIN_ROWS + 7
    data = {"g": rng.integers(0, 17, n).astype(np.int32),
            "h": rng.integers(0, 4096, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int64)}
    w = f" WHERE {where}" if where else ""
    stmts = [f"SELECT g, sum(v), count(), avg(v) FROM t{w} GROUP BY g "
             "ORDER BY g",
             f"SELECT h, sum(v), count(), min(v), max(v) FROM t{w} "
             "GROUP BY h ORDER BY h"]
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        s.create_table("t", data)
    seen = []
    real = executor._kept_rows_only

    def spy(mask, gid, *a):
        out = real(mask, gid, *a)
        seen.append(out[0].shape[0] < gid.shape[0])
        return out
    executor._kept_rows_only = spy
    try:
        got = [p.sql(q).to_rows() for q in stmts]
    finally:
        executor._kept_rows_only = real
    assert _exact(sum(got, [])) == _exact(sum((j.sql(q).to_rows()
                                                for q in stmts), []))
    assert seen == [compacts, compacts]
