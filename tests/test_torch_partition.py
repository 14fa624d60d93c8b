"""PARTITION BY, DROP PARTITION, table TTL and zone-map pruning through
both packages on the CPU: the cases of tests/test_partition_by.py and
tests/test_pruning_extended.py with the same seeded numpy inputs.  The
port has no EXPLAIN ESTIMATE yet (item 8), so pruning is read through the
``ZonemapPrunedBlocks`` counter, which both packages increment alike.
Also: the port's zone maps taken on the device equal the host's, and a
pruned vector search keeps the table's one SQ8 sidecar."""

import time

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime import metrics as JM
from myscaledb_tpu_torch.core.table import BLOCK_ROWS, ZoneMap
from myscaledb_tpu_torch.runtime import metrics as PM

torch.set_num_threads(1)


def _both():
    return myscaledb_tpu.connect(), myscaledb_tpu_torch.connect(device="cpu")


def _run(s, metrics, sql):
    """(rows, pruned blocks) of one statement."""
    metrics.reset()
    rows = s.sql(sql).to_rows()
    return rows, metrics.events_snapshot().get("ZonemapPrunedBlocks", 0)


def _same(j, p, sql):
    got, want = _run(p, PM, sql), _run(j, JM, sql)
    assert repr(got) == repr(want)
    return got


def test_partition_clustering_prunes():
    rng = np.random.default_rng(0)
    n = 400_000
    data = {"d": rng.integers(0, 4, n).astype(np.int32),
            "id": np.arange(n, dtype=np.int64),
            "v": rng.integers(0, 100, n).astype(np.int64)}
    j, p = _both()
    for s in (j, p):
        s.sql("CREATE TABLE p (d Int32, id Int64, v Int64) ENGINE = "
              "MergeTree PARTITION BY d ORDER BY id")
        s.create_table("stage", data)
        s.sql("INSERT INTO p SELECT d, id, v FROM stage")
    (rows, pruned) = _same(j, p, "SELECT count() FROM p WHERE d = 2")
    assert rows[0][0] == int((data["d"] == 2).sum())
    assert pruned > 0
    _same(j, p, "SELECT d, count(), sum(v) FROM p WHERE d >= 2 GROUP BY d "
          "ORDER BY d")
    _same(j, p, "SELECT id, v FROM p WHERE d = 1 ORDER BY v DESC, id "
          "LIMIT 5")
    # the batch is stored clustered, in np.lexsort order
    order = np.lexsort((data["d"],))
    got = p.tables["p"]["id"].to_numpy()
    np.testing.assert_array_equal(got, data["id"][order])


@pytest.mark.parametrize("values,key", [
    ("(0, 1), (1, 2), (0, 3), (2, 4), (1, 5)", "1"),
    ("(0, 1), (1, 2), (0, 3), (2, 4), (1, 5)", "'1'"),
    ("(5, 1), (5, 2)", "7"),
])
def test_drop_partition(values, key):
    j, p = _both()
    for s in (j, p):
        s.sql("CREATE TABLE p (d Int32, v Int64) ENGINE = MergeTree "
              "PARTITION BY d ORDER BY v")
        s.sql(f"INSERT INTO p VALUES {values}")
        s.sql(f"ALTER TABLE p DROP PARTITION {key}")
    _same(j, p, "SELECT d, v FROM p ORDER BY v")


def test_drop_partition_of_an_unpartitioned_table():
    j, p = _both()
    for s in (j, p):
        s.sql("CREATE TABLE q (d Int32) ENGINE = MergeTree ORDER BY d")
        with pytest.raises(ValueError, match="not partitioned"):
            s.sql("ALTER TABLE q DROP PARTITION 1")


@pytest.mark.parametrize("key,rows", [
    ("(a, b)", "(1, 9, 10), (0, 5, 20), (1, 1, 30), (0, 2, 40)"),
    ("(b, a)", "(1, 9, 10), (0, 5, 20), (1, 1, 30), (0, 2, 40)"),
    ("s", "(1, 9, 10), (0, 5, 20), (1, 1, 30), (0, 2, 40)"),
    ("toDate(a)", "(1, 9, 10), (0, 5, 20)"),
])
def test_partition_key_orders_each_batch(key, rows):
    """A batch is clustered by the key stably (a String key by its
    dictionary ids, as the JAX package's np.lexsort sorts them); a key
    that names no column, such as an expression, leaves it as it is."""
    j, p = _both()
    for s in (j, p):
        s.sql("CREATE TABLE p (a Int32, b Int32, v Int64, s String) ENGINE "
              f"= MergeTree PARTITION BY {key} ORDER BY v")
        vals = ", ".join(f"{r[:-1]}, 'x{10 - i}')"
                         for i, r in enumerate(rows.split("), ")))
        s.sql("INSERT INTO p VALUES " + vals.replace("))", ")"))
        s.sql("INSERT INTO p VALUES (3, 3, 3, 'x0'), (2, 2, 2, 'x9')")
    _same(j, p, "SELECT a, b, v, s FROM p")


@pytest.mark.parametrize("dtype", ["int32", "int64", "uint32", "float32",
                                   "float64"])
def test_zone_maps_on_the_device_equal_the_hosts(dtype):
    rng = np.random.default_rng(1)
    for n in (0, 5, BLOCK_ROWS, 3 * BLOCK_ROWS + 17):
        arr = (rng.standard_normal(n) * 1000).astype(dtype)
        host = ZoneMap.build(arr)
        dev = ZoneMap.build_device(torch.as_tensor(arr.astype(
            "int64" if dtype == "uint32" else dtype)), np.dtype(dtype))
        assert dev.mins.dtype == host.mins.dtype
        np.testing.assert_array_equal(dev.mins, host.mins)
        np.testing.assert_array_equal(dev.maxs, host.maxs)


def test_partitioned_insert_rebuilds_zone_maps():
    """Every INSERT into a partitioned table leaves each plain numeric or
    String column with the zone map of its whole data, as the JAX
    package's host rebuild gives it."""
    rng = np.random.default_rng(2)
    n = 2 * BLOCK_ROWS + 100
    j, p = _both()
    for s in (j, p):
        s.sql("CREATE TABLE p (d UInt8, u UInt32, f Float32, s String) "
              "ENGINE = MergeTree PARTITION BY d ORDER BY u")
        for k in range(2):
            s.create_table(f"st{k}", {
                "d": rng.integers(0, 5, n).astype(np.uint8),
                "u": rng.integers(0, 1 << 32, n).astype(np.uint32),
                "f": rng.standard_normal(n).astype(np.float32),
                "s": [f"w{i % 97}" for i in range(n)]})
        rng = np.random.default_rng(2)
    for k in range(2):
        for s in (j, p):
            s.sql(f"INSERT INTO p SELECT * FROM st{k}")
        for c in ("d", "u", "f", "s"):
            zj, zp = j.tables["p"][c].zonemap, p.tables["p"][c].zonemap
            np.testing.assert_array_equal(zp.mins, zj.mins)
            np.testing.assert_array_equal(zp.maxs, zj.maxs)
    _same(j, p, "SELECT count(), sum(u) FROM p WHERE d = 3")
    _same(j, p, "SELECT count() FROM p WHERE s = 'w5'")


def test_table_ttl_at_optimize():
    """Rows whose TTL has passed go at OPTIMIZE: a Date TTL against
    today, a DateTime TTL against now.  The port reads Date + INTERVAL 30
    DAY as thirty days later; the JAX package adds 30 x 86400 to the day
    count, so none of its rows expire (ROADMAP section 3)."""
    today = int(time.time() // 86400)
    j, p = _both()
    for s in (j, p):
        s.sql("CREATE TABLE t (d Date, id UInt32) ENGINE = MergeTree "
              "PARTITION BY d ORDER BY id TTL d + INTERVAL 30 DAY")
        s.create_table("st", {
            "d": np.array([today - 40, today - 31, today - 30, today - 29,
                           today], dtype="datetime64[D]"),
            "id": np.arange(5, dtype=np.uint32)})
        s.sql("INSERT INTO t SELECT d, id FROM st")
        s.sql("CREATE TABLE w (ts DateTime, id UInt32) ENGINE = MergeTree "
              "ORDER BY id TTL ts")
        s.sql("INSERT INTO w VALUES (1, 1), (2, 2)")
        s.sql("INSERT INTO w SELECT now() + 3600, 3")
        s.sql("OPTIMIZE TABLE t FINAL")
        s.sql("OPTIMIZE TABLE w")
    sql = "SELECT id FROM t ORDER BY id"
    assert p.sql(sql).to_rows() == [(3,), (4,)]
    assert j.sql(sql).to_rows() == [(0,), (1,), (2,), (3,), (4,)]
    assert _same(j, p, "SELECT id FROM w ORDER BY id")[0] == [(3,)]


def test_ttl_applies_in_the_background_merge():
    from myscaledb_tpu_torch.storage.background import default_executor
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.sql("CREATE TABLE t (d Date, id UInt32) ENGINE = MergeTree "
          "ORDER BY id TTL d")
    for i in range(8):
        p.sql(f"INSERT INTO t VALUES ('1999-01-0{i + 1}', {i}), "
              f"('2999-01-01', {100 + i})")
    assert default_executor().wait_idle(30)
    assert p.sql("SELECT count(), min(id) FROM t").to_rows() == [(8, 100)]
    assert len(p._table_parts["t"]) == 1


@pytest.fixture(scope="module")
def blocky():
    """test_pruning_extended's clustered layout: grp and name in runs of
    n/5 rows, so the zone maps are tight."""
    n = 300_000
    rng = np.random.default_rng(3)
    data = {"id": np.arange(n, dtype=np.int64),
            "grp": np.repeat(np.arange(5), n // 5).astype(np.int64),
            "name": np.repeat(np.array(["aa", "bb", "cc", "dd", "ee"]),
                              n // 5),
            "v": rng.integers(0, 100, n).astype(np.int64)}
    out = _both()
    for s in out:
        s.create_table("t", data)
    return out


@pytest.mark.parametrize("sql,count", [
    ("SELECT count() FROM t WHERE grp IN (1, 3)", 120_000),
    ("SELECT count() FROM t WHERE name = 'cc'", 60_000),
    ("SELECT count() FROM t WHERE name = 'zz'", 0),
    ("SELECT count() FROM t WHERE name IN ('bb', 'zz')", 60_000),
    ("SELECT count() FROM t WHERE grp < 1 AND v >= 50", None),
])
def test_zone_map_pruning(blocky, sql, count):
    j, p = blocky
    rows, pruned = _same(j, p, sql)
    if count is not None:
        assert rows[0][0] == count
    assert pruned > 0


def test_pruned_vector_search_keeps_the_tables_sidecar(monkeypatch):
    """A fused vector search whose WHERE prunes blocks runs over the whole
    table with the pruned rows deselected: its rows equal the JAX
    package's (which scans the kept blocks alone), and the table's SQ8
    sidecar is built once, by the first query, not again per pruned
    query or after it."""
    from myscaledb_tpu_torch.sql import executor
    builds = []
    real = executor.build_sq8
    monkeypatch.setattr(executor, "build_sq8",
                        lambda x: builds.append(1) or real(x))
    rng = np.random.default_rng(4)
    n = 2 * BLOCK_ROWS + 1000
    data = {"id": np.arange(n, dtype=np.int64),
            "day": np.repeat(np.arange(3), BLOCK_ROWS)[:n].astype(np.uint8),
            "price": rng.uniform(0, 100, n).astype(np.float32),
            "emb": rng.standard_normal((n, 128)).astype(np.float32)}
    j, p = _both()
    for s in (j, p):
        s.create_table("t", data)
    q = "[" + ",".join(f"{x:.4f}" for x in data["emb"][7]) + "]"
    for where in ("day = 1 AND price < 50", "", "day >= 2", "day = 0"):
        w = f"WHERE {where} " if where else ""
        sql = (f"SELECT id, distance(emb, {q}) AS d FROM t {w}"
               "ORDER BY d LIMIT 10")
        got, want = _run(p, PM, sql), _run(j, JM, sql)
        assert [r[0] for r in got[0]] == [r[0] for r in want[0]]
        np.testing.assert_allclose([r[1] for r in got[0]],
                                   [r[1] for r in want[0]], rtol=2e-5)
        assert got[1] == want[1]
    assert len(builds) == 1
