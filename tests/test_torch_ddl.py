"""DDL and DML parity on the CPU: the same statement sequences through
``myscaledb_tpu.connect()`` and ``myscaledb_tpu_torch.connect(device="cpu")``,
every SELECT's rows and TSV lines compared; error texts compared; the
statements outside the port's subset (file and stream engines and
formats) raised ``NotPortedError`` naming the slice that brings them until
it landed; those cases now hold the port to the JAX package."""

import threading

import numpy as np
import pytest
import torch

import myscaledb_tpu
from myscaledb_tpu.runtime.formats import ch_tsv_lines as j_tsv
import myscaledb_tpu_torch
from myscaledb_tpu_torch.runtime.formats import ch_tsv_lines as p_tsv
from myscaledb_tpu_torch.sql import ddl as PDDL

torch.set_num_threads(1)


def _pair():
    return myscaledb_tpu.connect(), myscaledb_tpu_torch.connect(device="cpu")


def _run(j, p, statements):
    """Run each statement in both sessions; SELECT results must have equal
    rows and equal TSV lines.  Returns the port's SELECT results."""
    out = []
    for sql in statements:
        jt, pt = j.sql(sql), p.sql(sql)
        if sql.lstrip().upper().startswith("SELECT"):
            assert pt.to_rows() == jt.to_rows(), sql
            assert p_tsv(pt) == j_tsv(jt), sql
            out.append(pt)
    return out


COLUMN_TYPES = """CREATE TABLE t (id UInt32, f Float32, a int, n Int64,
    s String, ns Nullable(Int32), fs FixedString(4), ai Array(Int32),
    v Array(Float32), CONSTRAINT v_len CHECK length(v) = 3)
    ENGINE = MergeTree ORDER BY id SETTINGS index_granularity=1024"""


def test_create_with_each_column_type_and_insert_values():
    j, p = _pair()
    _run(j, p, [
        COLUMN_TYPES,
        "INSERT INTO t VALUES (1, 1.5, -2, 7, 'x', NULL, 'ab', [1, 2], "
        "[0.5, 1, 2]), (2, -0.25, 3, -9, 'yz', 4, 'abcd', [], [3, 4, 5])",
        "INSERT INTO t (id, s, v) VALUES (3, 'q', [1, 1, 1])",
        "SELECT * FROM t ORDER BY id",
        "SELECT id, length(ai), length(s), ns FROM t ORDER BY id",
    ])
    pt = p.tables["t"]
    assert pt["v"].data.shape == (3, 3) and pt["v"].field.vector_dim == 3
    assert pt["fs"].field.fixed_len == 4


def test_insert_select_from_numbers_and_empty_rows():
    """numbers(a, b), array literals over columns, and [] rows into a
    vector column: those rows are stored invalid, skipped by the search
    and print as the JAX package prints them."""
    j, p = _pair()
    res = _run(j, p, [
        "CREATE TABLE tv (id Float32, vector Array(Float32)) ENGINE "
        "MergeTree PRIMARY KEY id",
        "INSERT INTO tv SELECT number, [number, number + 1, number * 2] "
        "FROM numbers(10)",
        "INSERT INTO tv SELECT number + 10, [] FROM numbers(5)",
        "INSERT INTO tv SELECT number, [number, number, number] "
        "FROM numbers(15, 5)",
        "ALTER TABLE tv ADD CONSTRAINT vector_len CHECK length(vector) = 3",
        "SELECT id, vector FROM tv WHERE id >= 8 AND id < 17 ORDER BY id",
        "SELECT id, distance(vector, [10.5, 10.5, 10.5]) AS d FROM tv "
        "ORDER BY d LIMIT 20",
        "SELECT count(*) FROM tv",
        "SELECT number, range(number), [number, 1] FROM numbers(1, 3)",
    ])
    ids = [r[0] for r in res[1].to_rows()]
    assert not set(ids) & set(range(10, 15))
    valid = p.tables["tv"]["vector"].valid
    assert valid is not None and int((~valid).sum()) == 5


def test_delete_detach_attach_truncate_optimize_drop():
    j, p = _pair()
    _run(j, p, [
        "CREATE TABLE t (id UInt32, v Array(Float32), CONSTRAINT c CHECK "
        "length(v) = 3) ENGINE = MergeTree ORDER BY id",
        "SYSTEM STOP MERGES t",
        "INSERT INTO t SELECT number, [number, number, number] "
        "FROM numbers(0, 40)",
        "INSERT INTO t SELECT number, [number, number, number] "
        "FROM numbers(40, 40)",
        "INSERT INTO t SELECT number, [number, number, number] "
        "FROM numbers(80, 20)",
        "SELECT table, name, rows, active FROM system.parts "
        "WHERE table = 't'",
        "SET allow_experimental_lightweight_delete = 1",
        "SET mutations_sync = 1",
        "DELETE FROM t WHERE id = 3 OR id = 5",
        "ALTER TABLE t DELETE WHERE id > 95",
        "SELECT id, distance(v, [4.1, 4.1, 4.1]) AS d FROM t "
        "ORDER BY d LIMIT 5",
        "DETACH TABLE t",
        "ATTACH TABLE t",
        "SELECT id, distance(v, [4.1, 4.1, 4.1]) AS d FROM t "
        "ORDER BY d LIMIT 5",
        "OPTIMIZE TABLE t FINAL",
        "SELECT table, name, rows FROM system.parts WHERE table = 't'",
        "SELECT count() FROM t",
        "TRUNCATE TABLE t",
        "SELECT count() FROM t",
        "SELECT count() FROM system.parts WHERE table = 't'",
        "DROP TABLE t",
        "DROP TABLE IF EXISTS t",
        "SELECT count() FROM system.parts",
    ])
    assert "t" not in p.tables


def test_vector_index_lifecycle_and_system_vector_indices():
    j, p = _pair()
    _run(j, p, [
        "CREATE TABLE t (id UInt32, v1 Array(Float32), v2 Array(Float32), "
        "CONSTRAINT a CHECK length(v1) = 3, CONSTRAINT b CHECK "
        "length(v2) = 3) ENGINE = MergeTree ORDER BY id "
        "SETTINGS min_bytes_to_build_vector_index=10000",
        "INSERT INTO t SELECT number, [number, number, number], "
        "[number + 100, number + 100, number + 100] FROM numbers(300)",
        "ALTER TABLE t ADD VECTOR INDEX i1 v1 TYPE MSTG",
        "ALTER TABLE t ADD VECTOR INDEX i2 v2 TYPE IVFFLAT('ncentroids = 1')",
        "SELECT database, table, name, column, type, expr, status, "
        "total_parts, parts_with_vector_index FROM system.vector_indices "
        "WHERE database = currentDatabase() ORDER BY name",
        "SELECT id, distance(v2, [110.1, 110.1, 110.1]) AS d FROM t "
        "ORDER BY d LIMIT 4",
        "ALTER TABLE t DROP VECTOR INDEX i1",
        "SELECT name, status FROM system.vector_indices",
        "ALTER TABLE t ADD VECTOR INDEX i1 v1 TYPE HNSWFLAT('metric_type=IP')",
        "SELECT id, distance(v1, [1.0, 1.0, 1.0]) AS d FROM t "
        "ORDER BY d DESC LIMIT 3",
        "SELECT if(status = 'Built', sleep(0), sleep(1.5) + sleep(2)) "
        "FROM (SELECT status FROM system.vector_indices WHERE name = 'i1')",
    ])
    assert [e["event_type"] for e in p.vi_events][-3:] == \
        ["DEFINITION_CREATED", "BUILD_START", "BUILD_SUCCEED"]


@pytest.mark.parametrize("sql", [
    "ALTER TABLE t ADD VECTOR INDEX i1 v TYPE FLAT",        # same name
    "ALTER TABLE t ADD VECTOR INDEX i2 v TYPE FLAT",        # same column
    "SELECT id, distance(v, [1.0, 1.0, 1.0]) AS d FROM t ORDER BY d DESC "
    "LIMIT 2",                                              # L2, DESC
    "SELECT id, distance(v, [0.1, 0.1, 0.1]) AS d1, "
    "distance(v, [1.1, 1.1, 1.1]) AS d2 FROM t",            # two searches
    "ALTER TABLE nope ADD VECTOR INDEX i9 v TYPE FLAT",     # unknown table
    "ALTER TABLE t ADD VECTOR INDEX i9 id TYPE FLAT",       # not a vector
    "CREATE TABLE t (id UInt32) ENGINE = MergeTree ORDER BY id",  # exists
    "SELECT id, batch_distance(v, [[1.0, 1.0, 1.0]]) AS d FROM t "
    "ORDER BY d.1, d.2 LIMIT 3",                           # no LIMIT BY
    "ATTACH TABLE t",                                       # not detached
    "DROP TABLE nope",
])
def test_error_texts_equal_the_jax_package(sql):
    j, p = _pair()
    setup = ["CREATE TABLE t (id UInt32, v Array(Float32), CONSTRAINT c "
             "CHECK length(v) = 3) ENGINE = MergeTree ORDER BY id",
             "INSERT INTO t SELECT number, [number, number, number] "
             "FROM numbers(1, 100)",
             "ALTER TABLE t ADD VECTOR INDEX i1 v TYPE HNSWFLAT"]
    _run(j, p, setup)
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sql,slice_name", [
    ("CREATE TABLE f (id UInt32) ENGINE = File(CSV, 'f.csv')",
     "storage, formats and runtime state"),
    ("CREATE TABLE k (id UInt32) ENGINE = Kafka",
     "storage, formats and runtime state"),
    ("INSERT INTO t FROM INFILE 'rows.csv' FORMAT CSV",
     "storage, formats and runtime state"),
    ("INSERT INTO t FORMAT CSV 1,[1,2,3]",
     "storage, formats and runtime state"),
    ("CREATE DICTIONARY fd (id UInt64) PRIMARY KEY id "
     "SOURCE(FILE(PATH 'ids.csv' FORMAT 'CSV'))",
     "storage, formats and runtime state"),
    ("SELECT * FROM system.formats", "storage, formats and runtime state"),
])
def test_statements_outside_the_subset_name_their_slice(sql, slice_name,
                                                        tmp_path,
                                                        monkeypatch):
    """Statements that raised NotPortedError naming ``slice_name`` until
    that slice landed now leave the JAX package's state or raise its
    error: the rows of each table read afterwards (a Kafka table's read
    fails with the broker message) and the dictionaries."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "f.csv").write_text("3\n1\n")
    (tmp_path / "rows.csv").write_text('7,"[1.0, 2.0, 3.0]"\n8,"[]"\n')
    (tmp_path / "ids.csv").write_text("5\n6\n")
    out = []
    for s in _pair():
        s.sql("CREATE TABLE t (id UInt32, v Array(Float32)) ENGINE = "
              "MergeTree ORDER BY id")
        got = []
        for q in (sql, "SELECT * FROM t ORDER BY id",
                  "SELECT * FROM f ORDER BY id", "SELECT * FROM k",
                  "SELECT name, element_count FROM system.dictionaries"):
            try:
                got.append(s.sql_tsv(q))
            except Exception as e:
                got.append((type(e).__name__, str(e)))
        out.append(got)
    assert out[0] == out[1]


# statements the breadth slice ported, each followed by a statement that
# reads what it left
BREADTH_STATEMENTS = [
    ("CREATE VIEW w AS SELECT id FROM t", "SELECT count() FROM w"),
    ("CREATE MATERIALIZED VIEW w AS SELECT id FROM t",
     "SELECT name, engine FROM system.views"),
    ("CREATE USER u IDENTIFIED BY 'x'", "SHOW USERS"),
    ("CREATE ROLE r", "SHOW ROLES"),
    ("GRANT SELECT ON t TO default", "SHOW GRANTS"),
    ("REVOKE SELECT ON t FROM default", "SHOW GRANTS"),
    ("SHOW TABLES", "SELECT name FROM system.tables"),
    ("DESCRIBE TABLE t", "SELECT count() FROM t"),
    ("CREATE DICTIONARY d (id UInt64, v String) PRIMARY KEY id "
     "SOURCE(CLICKHOUSE(TABLE 'w0')) LAYOUT(HASHED()) LIFETIME(0)",
     "SELECT dictGet('d', 'v', 2)"),
    ("DROP DICTIONARY IF EXISTS d", "SHOW DICTIONARIES"),
    ("SYSTEM RELOAD DICTIONARY", "SHOW DICTIONARIES"),
    ("ALTER TABLE t UPDATE id = 1 WHERE id = 2",
     "SELECT id, count() FROM t GROUP BY id ORDER BY id"),
    ("ALTER TABLE t ADD COLUMN z Int32", "SELECT sum(z), count() FROM t"),
    ("ALTER TABLE t MODIFY SETTING index_granularity = 8",
     "SELECT count() FROM t"),
    ("CREATE TABLE j (k UInt32, v UInt32) ENGINE = Join(ANY, LEFT, k)",
     "SELECT joinGet('j', 'v', toUInt32(1))"),
    ("ALTER TABLE t DROP CONSTRAINT c", "SELECT count() FROM t"),
    ("SELECT * FROM system.tables", "SELECT count() FROM t"),
]


@pytest.mark.parametrize("sql,check", BREADTH_STATEMENTS)
def test_breadth_statements_run_since_the_breadth_slice(sql, check):
    """Statements that raised NotPortedError naming the breadth slice
    before it landed now give what the JAX package gives, and leave the
    state it leaves."""
    out = []
    for s in _pair():
        s.sql("CREATE TABLE t (id UInt32, v Array(Float32)) ENGINE = "
              "MergeTree ORDER BY id")
        s.sql("INSERT INTO t VALUES (1, [1.0]), (2, [2.0]), (3, [3.0])")
        s.sql("CREATE TABLE w0 (id UInt64, v String) ENGINE = Memory")
        s.sql("INSERT INTO w0 VALUES (1, 'a'), (2, 'b')")
        out.append((s.sql_tsv(sql), s.sql_tsv(check)))
    assert out[0] == out[1]


@pytest.mark.parametrize("sql", [
    "CREATE TABLE pt (id UInt32) ENGINE = MergeTree PARTITION BY id "
    "ORDER BY id",
    "CREATE TABLE tt (id UInt32, d DateTime) ENGINE = MergeTree ORDER BY "
    "id TTL d + 1",
    "ALTER TABLE t ADD INDEX ix id TYPE minmax",
    "ALTER TABLE t DROP PARTITION 1",
    "SYSTEM FLUSH LOGS",
])
def test_storage_statements_run_since_the_storage_slice(sql):
    """Statements that raised NotPortedError naming the storage slice
    before it landed now do what the JAX package does: the same error
    where it raises one (DROP PARTITION of an unpartitioned table), else
    the same state afterwards."""
    from myscaledb_tpu import connect as jconnect
    out = []
    for s in (jconnect(), myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE TABLE t (id UInt32, v Array(Float32)) ENGINE = "
              "MergeTree ORDER BY id")
        try:
            s.sql(sql)
            out.append(s.sql("SELECT name, type FROM "
                             "system.data_skipping_indices").to_rows())
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


def test_epoch_moves_with_data_and_not_with_detach(monkeypatch):
    """DELETE moves the mutation epoch, so the next query rebuilds the scan
    sidecar and never returns a deleted id; DETACH/ATTACH and an index
    build of the current table keep the sidecar the next query reads."""
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.sql("CREATE TABLE t (id UInt32, v Array(Float32), CONSTRAINT c CHECK "
          "length(v) = 3) ENGINE = MergeTree ORDER BY id")
    p.sql("INSERT INTO t SELECT number, [number, number, number] "
          "FROM numbers(1000)")
    p.sql("ALTER TABLE t ADD VECTOR INDEX i v TYPE MSTG")
    built = dict(p._derived)
    q = "SELECT id FROM t ORDER BY distance(v, [7.0, 7.0, 7.0]) LIMIT 3"
    assert [r[0] for r in p.sql(q).to_rows()] == [7, 6, 8]
    assert p._derived == built          # the index's build served
    p.sql("DETACH TABLE t")
    p.sql("ATTACH TABLE t")
    p.sql(q)
    assert p._derived == built
    epoch = p._mutation_epoch
    p.sql("DELETE FROM t WHERE id = 7")
    assert p._mutation_epoch == epoch + 1
    assert [r[0] for r in p.sql(q).to_rows()] == [6, 8, 5]
    assert p._derived.keys() != built.keys()


def test_detach_with_the_query_cache_on_forgets_the_cached_rows():
    """With use_query_cache = 1, a SELECT after DETACH raises the JAX
    package's unknown-table error rather than serving the rows it cached
    before; after ATTACH the same SELECT gives the same rows again."""
    j, p = _pair()
    q = "SELECT id FROM t ORDER BY distance(v, [7.0, 7.0, 7.0]) LIMIT 3"
    _run(j, p, [
        "SET use_query_cache = 1",
        "CREATE TABLE t (id UInt32, v Array(Float32), CONSTRAINT c CHECK "
        "length(v) = 3) ENGINE = MergeTree ORDER BY id",
        "INSERT INTO t SELECT number, [number, number, number] "
        "FROM numbers(100)",
        q,
        "DETACH TABLE t"])
    assert p.settings.use_query_cache
    epoch = p._mutation_epoch
    with pytest.raises(Exception) as want:
        j.sql(q)
    with pytest.raises(Exception) as got:
        p.sql(q)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    (rows,) = _run(j, p, ["ATTACH TABLE t", q])
    assert [r[0] for r in rows.to_rows()] == [7, 6, 8]
    assert p._mutation_epoch == epoch


def test_background_index_build_hands_its_sidecar_to_a_query(monkeypatch):
    """Builds of BACKGROUND_BUILD_ROWS rows or more run on the background
    executor; a query sent at once either finds the build done or waits
    on the sidecar lock, and gets the JAX package's rows either way."""
    from myscaledb_tpu_torch.storage.background import default_executor
    from myscaledb_tpu_torch.sql import executor as PE
    monkeypatch.setattr(PDDL, "BACKGROUND_BUILD_ROWS", 512)
    calls, real = [], PE.precompute_sqnorm
    gate = threading.Event()

    def slow_sqnorm(x):
        calls.append(threading.current_thread().name)
        gate.wait(5)              # hold the build until the query waits
        return real(x)

    monkeypatch.setattr(PE, "precompute_sqnorm", slow_sqnorm)
    j, p = _pair()
    setup = ["CREATE TABLE t (id UInt32, v Array(Float32), CONSTRAINT c "
             "CHECK length(v) = 3) ENGINE = MergeTree ORDER BY id",
             "INSERT INTO t SELECT number, [number, number + 1, number] "
             "FROM numbers(2000)"]
    for s in setup:
        j.sql(s)
        p.sql(s)
    p.sql("ALTER TABLE t ADD VECTOR INDEX i v TYPE MSTG")
    for _ in range(500):          # the build has started and holds the lock
        if calls:
            break
        threading.Event().wait(0.01)
    q = "SELECT id, distance(v, [9.5, 9.5, 9.5]) AS d FROM t ORDER BY d LIMIT 4"
    result = {}
    th = threading.Thread(target=lambda: result.update(rows=p.sql(q)))
    th.start()
    gate.set()
    th.join(10)
    assert default_executor().wait_idle(10)
    assert result["rows"].to_rows() == j.sql(q).to_rows()
    assert len(calls) == 1 and calls[0].startswith("bg-")
    assert p.sql("SELECT status FROM system.vector_indices").to_rows() == \
        [("Built",)]


def test_background_merge_waits_for_start_merges():
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.sql("CREATE TABLE t (id UInt32) ENGINE = MergeTree ORDER BY id")
    p.sql("SYSTEM STOP MERGES t")
    for i in range(PDDL.MERGE_MIN_PARTS + 2):
        p.sql(f"INSERT INTO t VALUES ({i})")
    from myscaledb_tpu_torch.storage.background import default_executor
    assert default_executor().wait_idle(10)
    count = "SELECT count() FROM system.parts WHERE table = 't'"
    assert p.sql(count).to_rows() == [(PDDL.MERGE_MIN_PARTS + 2,)]
    p.sql("SYSTEM START MERGES t")
    assert default_executor().wait_idle(10)
    assert p.sql(count).to_rows() == [(1,)]


def test_sidecar_is_built_once_under_concurrent_queries(monkeypatch):
    """More query threads than cores, thread switches every 10 µs, one
    background index build: the sidecar lock lets exactly one of them
    build the scan sidecar, and every query returns the same rows."""
    import sys
    from myscaledb_tpu_torch.storage.background import default_executor
    from myscaledb_tpu_torch.sql import executor as PE
    monkeypatch.setattr(PDDL, "BACKGROUND_BUILD_ROWS", 512)
    builds, real = [], PE.precompute_sqnorm

    def counting_sqnorm(x):
        builds.append(1)
        return real(x)

    monkeypatch.setattr(PE, "precompute_sqnorm", counting_sqnorm)
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.sql("CREATE TABLE t (id UInt32, v Array(Float32), CONSTRAINT c CHECK "
          "length(v) = 3) ENGINE = MergeTree ORDER BY id")
    p.sql("INSERT INTO t SELECT number, [number, number, number] "
          "FROM numbers(3000)")
    q = "SELECT id FROM t ORDER BY distance(v, [20.2, 20.2, 20.2]) LIMIT 5"
    results, errors = [], []

    def run():
        try:
            results.append(p.sql(q).to_rows())
        except Exception as e:        # noqa: BLE001  (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        p.sql("ALTER TABLE t ADD VECTOR INDEX i v TYPE MSTG")
        threads = [threading.Thread(target=run) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert default_executor().wait_idle(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert results == [[(20,), (21,), (19,), (22,), (18,)]] * 16
    assert len(builds) == 1
