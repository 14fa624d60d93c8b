"""Views and materialized views through both packages (after
tests/test_views.py): a plain view runs its SELECT where it is read; a
materialized view sees each inserted block only, POPULATE fills it from
the source, a TO table takes its rows by position; system.views,
system.tables, SHOW TABLES and DESCRIBE."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)


def _orders(s):
    s.create_table("orders", {
        "id": np.arange(8, dtype=np.int64), "region": ["eu", "us"] * 4,
        "amt": np.array([10, 20, 30, 40, 50, 60, 70, 80], dtype=np.float64)})


def _both(statements):
    """Each statement through a fresh pair of sessions holding ``orders``;
    the TSV of every statement (or its error text) per package."""
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        _orders(s)
        res = []
        for sql in statements:
            try:
                res.append(s.sql_tsv(sql))
            except Exception as e:          # noqa: BLE001
                res.append(f"{type(e).__name__}: {e}")
        out.append(res)
    return out


CASES = {
    "plain_view": [
        "CREATE VIEW eu_orders AS SELECT id, amt FROM orders WHERE "
        "region = 'eu'",
        "SELECT count() FROM eu_orders",
        "INSERT INTO orders VALUES (8, 'eu', 90.0)",
        "SELECT count() FROM eu_orders",
        "CREATE VIEW big AS SELECT id FROM eu_orders WHERE amt > 40",
        "SELECT count() FROM big",
        "CREATE VIEW IF NOT EXISTS big AS SELECT 1",
        "SELECT id FROM big ORDER BY id",
        "DROP TABLE eu_orders",
        "SELECT * FROM eu_orders"],
    "populate": [
        "CREATE MATERIALIZED VIEW mv POPULATE AS SELECT region, sum(amt) "
        "AS total FROM orders GROUP BY region",
        "SELECT region, total FROM mv ORDER BY region",
        "INSERT INTO orders VALUES (9, 'eu', 1.0)",
        "SELECT region, total FROM mv ORDER BY region, total"],
    "insert_trigger": [
        "CREATE MATERIALIZED VIEW mv AS SELECT id, amt * 2 AS double_amt "
        "FROM orders WHERE amt >= 50",
        "SELECT count() FROM mv",
        "INSERT INTO orders VALUES (100, 'eu', 55.0), (101, 'us', 5.0)",
        "SELECT id, double_amt FROM mv ORDER BY id",
        "INSERT INTO orders SELECT id + 200, region, amt FROM orders "
        "WHERE id < 6",
        "SELECT id, double_amt FROM mv ORDER BY id"],
    "to_table": [
        "CREATE TABLE sink (rid Int64, v Float64)",
        "CREATE MATERIALIZED VIEW mv2 TO sink AS SELECT id, amt FROM "
        "orders WHERE region = 'us'",
        "INSERT INTO orders VALUES (200, 'us', 1.5), (201, 'eu', 2.5)",
        "SELECT rid, v FROM sink",
        "DROP TABLE mv2",
        "SELECT count() FROM sink",
        "INSERT INTO orders VALUES (202, 'us', 3.5)",
        "SELECT count() FROM sink"],
    "to_table_populate_and_states": [
        "CREATE TABLE agg (region String, s String, c String)",
        "CREATE MATERIALIZED VIEW mv3 TO agg POPULATE AS SELECT region, "
        "sumState(amt) AS s, countState(amt) AS c FROM orders GROUP BY "
        "region",
        "INSERT INTO orders VALUES (300, 'eu', 0.5)",
        "SELECT region, sumMerge(s), countMerge(c) FROM agg GROUP BY region "
        "ORDER BY region",
        "SELECT count() FROM agg"],
    "system_views": [
        "CREATE VIEW v1 AS SELECT id FROM orders",
        "CREATE MATERIALIZED VIEW m1 AS SELECT id FROM orders",
        "SELECT name, engine FROM system.views ORDER BY name",
        "SELECT name, total_rows FROM system.tables ORDER BY name",
        "SHOW TABLES",
        "DESCRIBE orders",
        "DESCRIBE TABLE m1",
        "DROP TABLE m1",
        "SHOW TABLES",
        "CREATE TABLE zz (a Int64, s Nullable(String), v Array(Float32, 8))",
        "DESCRIBE zz",
        "DESC zz"],
    "errors": [
        "CREATE MATERIALIZED VIEW bad AS SELECT 1",
        "CREATE MATERIALIZED VIEW bad AS SELECT id FROM nowhere",
        "SELECT * FROM no_such_view"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_views_match_the_jax_package(name):
    j, p = _both(CASES[name])
    assert p == j


def test_view_and_partitioned_insert_run_the_hook_once():
    """The materialized view runs once per INSERT statement over the rows
    it inserted, also into a partitioned table (one call, not one per
    partition), and its SELECT reads the block under a hidden name: the
    source table stays registered as it was."""
    from myscaledb_tpu_torch.sql import ddl
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.sql("CREATE TABLE ev (d UInt8, v Int64) ENGINE = MergeTree "
          "PARTITION BY d ORDER BY v")
    p.sql("CREATE MATERIALIZED VIEW c AS SELECT d, count() AS n FROM ev "
          "GROUP BY d")
    calls, seen = [], []
    real = ddl._view_on_block

    def spy(session, mv, block):
        calls.append(block.n_rows)
        seen.append(session.tables["ev"].n_rows)
        return real(session, mv, block)
    ddl._view_on_block = spy
    try:
        p.sql("INSERT INTO ev SELECT number % 4, number FROM numbers(40)")
        p.sql("INSERT INTO ev VALUES (1, 7), (2, 8)")
    finally:
        ddl._view_on_block = real
    assert calls == [40, 2]
    assert seen == [40, 42]           # the source, not the block
    assert p.sql("SELECT d, sum(n) FROM c GROUP BY d ORDER BY d"
                 ).to_rows() == [(0, 10), (1, 11), (2, 11), (3, 10)]
    assert ddl.MV_BLOCK not in p.tables


def test_materialized_view_with_an_engine_clause():
    """CREATE MATERIALIZED VIEW name ENGINE = ... AS SELECT, ClickHouse's
    form for a view with a table of its own, and AggregateFunction(f, T)
    columns (the -State strings) run in the port; the JAX grammar expects
    AS after the name and has no AggregateFunction type (ROADMAP section
    3)."""
    p = myscaledb_tpu_torch.connect(device="cpu")
    _orders(p)
    p.sql("CREATE TABLE agg (region String, s AggregateFunction(sum, "
          "Float64), n SimpleAggregateFunction(sum, UInt64)) ENGINE = "
          "AggregatingMergeTree ORDER BY region")
    assert p.sql("DESCRIBE agg").to_rows() == [
        ("region", "String"), ("s", "String"), ("n", "UInt64")]
    p.sql("INSERT INTO agg SELECT region, sumState(amt), count() FROM "
          "orders GROUP BY region")
    assert p.sql("SELECT region, sumMerge(s) FROM agg GROUP BY region "
                 "ORDER BY region").to_rows() == [("eu", 160.0),
                                                  ("us", 200.0)]
    with pytest.raises(Exception, match="AggregateFunction"):
        myscaledb_tpu.connect().sql(
            "CREATE TABLE agg (s AggregateFunction(sum, Float64))")
    p.sql("CREATE MATERIALIZED VIEW mv ENGINE = MergeTree ORDER BY id "
          "POPULATE AS SELECT id, amt FROM orders WHERE amt > 60")
    assert p.sql("SELECT id FROM mv ORDER BY id").to_rows() == [(6,), (7,)]
    with pytest.raises(Exception):
        myscaledb_tpu.connect().sql(
            "CREATE MATERIALIZED VIEW mv ENGINE = MergeTree ORDER BY id AS "
            "SELECT 1")


@pytest.mark.parametrize("target,to", [("mv", ""), ("dst", "TO dst ")])
def test_populate_keeps_the_source_tables_settings_and_indexes(target, to):
    """POPULATE reads the registered source table itself: afterwards the
    source keeps its name, so its Cosine metric and its skip index still
    serve a distance query and a pruned count (both packages' rows and
    pruned-block counts equal)."""
    from myscaledb_tpu.runtime import metrics as JM
    from myscaledb_tpu_torch.core.table import BLOCK_ROWS
    from myscaledb_tpu_torch.runtime import metrics as PM
    n = 2 * BLOCK_ROWS
    v = np.repeat(np.array([10, 12], dtype=np.int64), BLOCK_ROWS)
    v[::BLOCK_ROWS] = 0
    v[1::BLOCK_ROWS] = 99999
    emb = np.random.default_rng(5).standard_normal((n, 3)).astype(
        np.float32)
    out = []
    for s, metrics in ((myscaledb_tpu.connect(), JM),
                       (myscaledb_tpu_torch.connect(device="cpu"), PM)):
        s.create_table("t", {"id": np.arange(n, dtype=np.int64), "v": v,
                             "emb": emb})
        s.create_table("dst", {"id": np.zeros(0, dtype=np.int64),
                               "v": np.zeros(0, dtype=np.int64)})
        s.sql("ALTER TABLE t ADD VECTOR INDEX vi emb TYPE "
              "MSTG('metric_type=Cosine')")
        s.sql("ALTER TABLE t ADD INDEX ix v TYPE set(100) GRANULARITY 1")
        s.sql(f"CREATE MATERIALIZED VIEW mv {to}POPULATE AS SELECT id, v "
              "FROM t WHERE v > 11")
        res = [s.sql_tsv(f"SELECT count() FROM {target}"),
               s.sql_tsv("SELECT id, distance(emb, [1.0, 2.0, -0.5]) AS d "
                         "FROM t ORDER BY d LIMIT 3")]
        metrics.reset()
        res.append(s.sql_tsv("SELECT count() FROM t WHERE v = 12"))
        res.append(metrics.events_snapshot().get("ZonemapPrunedBlocks", 0))
        out.append(res)
    j, p = out
    assert p == j
    assert j[0] == str(BLOCK_ROWS) and j[3] == 1


def test_view_over_the_block_takes_the_sources_metric():
    """A materialized view's SELECT over the inserted block (and over
    the source at POPULATE) searches with the source's Cosine metric, as
    in the JAX package, where the block carries the source's name."""
    emb = np.random.default_rng(5).standard_normal((300, 3)).astype(
        np.float32)
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.create_table("t", {"id": np.arange(300, dtype=np.int64),
                             "emb": emb})
        s.sql("ALTER TABLE t ADD VECTOR INDEX vi emb TYPE "
              "MSTG('metric_type=Cosine')")
        for name, k, pop in (("dv", 3, "POPULATE "), ("dv2", 2, "")):
            s.sql(f"CREATE MATERIALIZED VIEW {name} {pop}AS SELECT id, "
                  "distance(emb, [1.0, 2.0, -0.5]) AS d FROM t ORDER BY d "
                  f"LIMIT {k}")
        s.sql("INSERT INTO t VALUES (900, [1.0, 2.0, -0.4])")
        out.append([s.sql_tsv("SELECT * FROM dv ORDER BY d"),
                    s.sql_tsv("SELECT * FROM dv2")])
    assert out[1] == out[0]
    assert out[0][1].startswith("900\t0.0009")
