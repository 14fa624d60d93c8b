"""ALTER column mutations, aggregate projections and EXPLAIN through both
packages (after the ALTER UPDATE half of tests/test_sql_extended.py, the
projection and grant cases of tests/test_optimizer.py and
tests/test_explain_modes.py), with the divergences the port pins: ALTER
UPDATE keeps the column order (the JAX package moves each updated column
last), ADD COLUMN casts its DEFAULT to the declared type, MODIFY COLUMN
exists, and EXPLAIN PIPELINE names the port's processors."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)


def _data():
    rng = np.random.default_rng(3)
    n = 2000
    return {"k": rng.integers(0, 16, n).astype(np.int64),
            "k2": rng.integers(0, 4, n).astype(np.int64),
            "v": rng.integers(-100, 100, n).astype(np.int64),
            "f": rng.normal(size=n),
            "s": np.array(["a", "b", "c"])[rng.integers(0, 3, n)]}


def _pair():
    out = (myscaledb_tpu.connect(), myscaledb_tpu_torch.connect(device="cpu"))
    for s in out:
        s.create_table("t", _data())
    return out


def _steps(s, stmts):
    res = []
    for sql in stmts:
        try:
            res.append(s.sql_tsv(sql))
        except Exception as e:              # noqa: BLE001
            res.append(f"{type(e).__name__}: {e}")
    return res


# statements whose results both packages agree on: the UPDATE cases read
# named columns only (the JAX package reorders the table's columns)
SCRIPTS = {
    "update": [
        "ALTER TABLE t UPDATE v = v * 0 WHERE k = 2",
        "SELECT sum(v) FROM t WHERE k = 2",
        "SELECT k, sum(v), count() FROM t GROUP BY k ORDER BY k",
        "ALTER TABLE t UPDATE v = v + k, f = f * 2 WHERE k2 = 1 AND v > 0",
        "SELECT k2, sum(v), max(f), min(f) FROM t GROUP BY k2 ORDER BY k2",
        "ALTER TABLE t UPDATE k = k + 100 WHERE 0",
        "SELECT max(k) FROM t"],
    "delete_and_update": [
        "ALTER TABLE t DELETE WHERE v < 5",
        "SELECT count() FROM t WHERE v < 5",
        "ALTER TABLE t UPDATE v = 5 WHERE v > 90",
        "SELECT count() FROM t WHERE v = 5"],
    "columns": [
        "ALTER TABLE t ADD COLUMN w Int64 DEFAULT v * 2",
        "SELECT sum(w), sum(v) FROM t",
        "ALTER TABLE t MATERIALIZE COLUMN w",
        "SELECT sum(w) FROM t",
        "ALTER TABLE t ADD COLUMN IF NOT EXISTS w Int64",
        "ALTER TABLE t ADD COLUMN w Int64",
        "ALTER TABLE t ADD COLUMN z UInt8",
        "SELECT sum(z), count() FROM t",
        "DESCRIBE t",
        "ALTER TABLE t DROP COLUMN w",
        "ALTER TABLE t DROP COLUMN IF EXISTS z",
        "DESCRIBE t",
        "ALTER TABLE t DROP COLUMN nope",
        "ALTER TABLE nope ADD COLUMN q Int32"],
    "settings_and_constraints": [
        "ALTER TABLE t MODIFY SETTING index_granularity = 8, "
        "binary_vector_search_metric_type = 'jaccard'",
        "ALTER TABLE t ADD CONSTRAINT c CHECK k >= 0",
        "ALTER TABLE t DROP CONSTRAINT c",
        "ALTER TABLE t DROP CONSTRAINT c",
        "SELECT count() FROM t"],
    "projections": [
        "ALTER TABLE t ADD PROJECTION p1 (SELECT k, sum(v), count(), "
        "min(v), max(v), avg(v) GROUP BY k)",
        "SELECT k, sum(v), count(), min(v), max(v), avg(v) FROM t GROUP BY "
        "k ORDER BY k",
        "EXPLAIN PLAN SELECT k, sum(v), count() FROM t GROUP BY k ORDER BY k",
        "ALTER TABLE t ADD PROJECTION p2 (SELECT k, k2, sum(v), count() "
        "GROUP BY k, k2)",
        "SELECT k2, sum(v), count() FROM t GROUP BY k2 ORDER BY k2",
        "SELECT k, sum(v) FROM t WHERE k < 8 GROUP BY k ORDER BY k",
        "EXPLAIN PLAN SELECT k, sum(v) FROM t WHERE v > 0 GROUP BY k",
        "INSERT INTO t (k, k2, v, f, s) VALUES (3, 0, 1000000, 0.0, 'a')",
        "SELECT k, sum(v), count() FROM t GROUP BY k ORDER BY k",
        "ALTER TABLE t ADD PROJECTION p7 (SELECT k, avg(v), uniq(k2) "
        "GROUP BY k)",
        "SELECT k, uniq(k2) FROM t GROUP BY k ORDER BY k",
        "EXPLAIN PLAN SELECT k, uniq(k2) FROM t GROUP BY k ORDER BY k",
        "ALTER TABLE t DROP PROJECTION p1",
        "ALTER TABLE t DROP PROJECTION p2",
        "EXPLAIN PLAN SELECT k, sum(v) FROM t GROUP BY k"],
    "explain": [
        "EXPLAIN SELECT k FROM t WHERE k < 5",
        "EXPLAIN PLAN SELECT k, count() FROM t WHERE k IN (1, 2) GROUP BY k "
        "ORDER BY k LIMIT 3",
        "EXPLAIN ESTIMATE SELECT * FROM t",
        "EXPLAIN ESTIMATE SELECT * FROM t WHERE k > 100",
        "EXPLAIN AST SELECT k FROM t ORDER BY k DESC LIMIT 3",
        "EXPLAIN SYNTAX SELECT k AS x FROM t WHERE k < 5 GROUP BY k "
        "ORDER BY x LIMIT 2",
        "EXPLAIN SELECT k FROM t UNION ALL SELECT k2 FROM t",
        "EXPLAIN PLAN SELECT * FROM (SELECT k FROM t) WHERE k > 1"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_alter_and_explain_match_the_jax_package(name):
    j, p = _pair()
    assert _steps(p, SCRIPTS[name]) == _steps(j, SCRIPTS[name])


def test_estimate_reports_pruned_blocks():
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.create_table("big", {"v": np.arange(260_000, dtype=np.int64)})
        out.append(s.sql("EXPLAIN ESTIMATE SELECT * FROM big WHERE "
                         "v >= 200000").to_rows())
    assert out[0] == out[1] == [("big", 260_000, 4, 3)]


def test_projection_respects_grants_and_row_policies():
    out = []
    for s in _pair():
        s.sql("ALTER TABLE t ADD PROJECTION p8 (SELECT k, sum(v) GROUP BY k)")
        s.sql("CREATE USER bob")
        s.sql("CREATE USER eve")
        s.sql("GRANT SELECT ON t TO bob")
        s.sql("CREATE ROW POLICY rp ON t USING k < 4 TO bob")
        res = []
        for user in ("bob", "eve"):
            s.current_user = user
            res += _steps(s, ["SELECT k, sum(v) FROM t GROUP BY k "
                              "ORDER BY k"])
        out.append(res)
    assert out[0] == out[1]
    assert "AccessDeniedError" in out[1][1]


def test_update_keeps_the_column_order_and_strings():
    """ALTER UPDATE writes in place: the columns keep their order (the JAX
    package moves each updated column last: ROADMAP section 3) and a
    String column takes a literal or another String column's values."""
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.create_table("t", _data())
    names = p.tables["t"].column_names
    p.sql("ALTER TABLE t UPDATE v = -v, s = 'zz' WHERE k = 1")
    assert p.tables["t"].column_names == names
    assert p.sql("SELECT DISTINCT s FROM t WHERE k = 1").to_rows() == \
        [("zz",)]
    p.sql("CREATE TABLE u (a String, b String)")
    p.sql("INSERT INTO u VALUES ('x', 'p'), ('y', 'q')")
    p.sql("ALTER TABLE u UPDATE a = b WHERE a = 'y'")
    assert p.sql("SELECT a, b FROM u").to_rows() == [("x", "p"), ("q", "q")]
    j = myscaledb_tpu.connect()
    j.create_table("t", _data())
    j.sql("ALTER TABLE t UPDATE v = -v WHERE k = 1")
    assert j.tables["t"].column_names[-1] == "v"


def test_add_and_modify_column_take_the_declared_type():
    """ADD COLUMN ... DEFAULT casts to the declared type (ClickHouse; the
    JAX package keeps the expression's type) and MODIFY COLUMN casts an
    existing column (the JAX grammar has none): both pinned here."""
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.create_table("t", _data())
    p.sql("ALTER TABLE t ADD COLUMN h Int32 DEFAULT f * 10")
    p.sql("ALTER TABLE t MODIFY COLUMN k Float64")
    types = dict(p.sql("DESCRIBE t").to_rows())
    assert types["h"] == "Int32" and types["k"] == "Float64"
    want = np.trunc(_data()["f"] * 10).astype(np.int64).sum()
    assert p.sql("SELECT sum(h) FROM t").to_rows()[0][0] == want
    with pytest.raises(ValueError, match="cannot convert"):
        p.sql("ALTER TABLE t MODIFY COLUMN s Int64")
    with pytest.raises(Exception):
        myscaledb_tpu.connect().sql("ALTER TABLE t MODIFY COLUMN k Float64")


def test_pipeline_names_the_ports_processors():
    """EXPLAIN PIPELINE has the JAX package's stage lines, each annotated
    with what the port runs there: group_agg.cu (K3) where the JAX package
    says MXUOneHotHistogram (tests/test_explain_modes.py), the int8 and f32
    segment-min kernels (K1, K2) for a vector top-k (ROADMAP section 3)."""
    j, p = _pair()
    sql = "EXPLAIN PIPELINE SELECT k, count() FROM t GROUP BY k"
    got = [r[0] for r in p.sql(sql).to_rows()]
    want = [r[0] for r in j.sql(sql).to_rows()]
    assert [ln.split("  [")[0] for ln in got] == \
        [ln.split("  [")[0] for ln in want]
    assert any("group_agg.cu K3" in ln for ln in got)
    assert any("MXUOneHotHistogram" in ln for ln in want)
    assert not any("MXU" in ln or "Pallas" in ln or "HBM" in ln
                   for ln in got)
    emb = np.eye(4, dtype=np.float32)
    p.create_table("v", {"id": np.arange(4, dtype=np.int64), "emb": emb})
    vs = [r[0] for r in p.sql("EXPLAIN PIPELINE SELECT id, distance(emb, "
                              "[1.0, 0.0, 0.0, 0.0]) AS d FROM v ORDER BY d "
                              "LIMIT 2").to_rows()]
    assert any("segmin_sq8.cu K1" in ln for ln in vs)


def test_update_takes_the_zone_maps_anew():
    """ALTER UPDATE of a partitioned table's key column takes that
    column's zone maps anew on the device, so pruned statements still see
    every row (the JAX package drops the column's zone map and scans all
    blocks); the rows equal the JAX package's."""
    from myscaledb_tpu_torch.runtime import metrics as M
    out = []
    stmts = ["ALTER TABLE ev UPDATE d = 9 WHERE d = 1 AND v % 2 = 0",
             "SELECT d, count(), sum(v) FROM ev WHERE d = 9 GROUP BY d",
             "SELECT count() FROM ev WHERE d = 1",
             "SELECT count() FROM ev WHERE u = 77"]
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE TABLE ev (d UInt8, u UInt64, v Int64, INDEX b u TYPE "
              "bloom_filter GRANULARITY 1) ENGINE = MergeTree PARTITION BY "
              "d ORDER BY v")
        s.sql("INSERT INTO ev SELECT number % 10, number % 1000, number "
              "FROM numbers(300000)")
        out.append(_steps(s, stmts))
    assert out[0] == out[1]
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.sql("CREATE TABLE ev (d UInt8, v Int64) ENGINE = MergeTree "
          "PARTITION BY d ORDER BY v")
    p.sql("INSERT INTO ev SELECT number % 10, number FROM numbers(300000)")
    p.sql("ALTER TABLE ev UPDATE d = 9 WHERE d = 1")
    before = M.events_snapshot().get("ZonemapPrunedBlocks", 0)
    assert p.sql("SELECT count() FROM ev WHERE d = 9").to_rows() == \
        [(60000,)]
    assert M.events_snapshot().get("ZonemapPrunedBlocks", 0) > before
