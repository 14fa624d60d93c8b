"""The system.* tables the formats slice brought, the port against the JAX
package: system.columns, settings, functions, formats and
vector_index_segments row for row; events, metrics, timings, query_log and
span_log by their columns and types (their values are the process's own
counters and clocks) and by what a statement adds to them."""

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime import metrics as jax_metrics


@pytest.fixture(scope="module")
def sessions():
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE TABLE t (id UInt32, name Nullable(String), "
              "v Array(Float32), d Date) ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO t VALUES (1, 'a', [1.0, 2.0], '2020-01-01'), "
              "(2, NULL, [3.0, 4.0], '2020-01-02')")
        s.sql("INSERT INTO t VALUES (3, 'c', [5.0, 6.0], '2020-01-03')")
        s.sql("ALTER TABLE t ADD VECTOR INDEX vi v TYPE MSTG")
        s.create_table("w", {"x": np.arange(4, dtype=np.int64)})
        out.append(s)
    return out


@pytest.mark.parametrize("sql", [
    "SELECT * FROM system.columns",
    "SELECT * FROM system.settings",
    "SELECT * FROM system.functions",
    "SELECT kind, count() FROM system.functions GROUP BY kind ORDER BY kind",
    "SELECT * FROM system.formats",
    "SELECT name FROM system.formats WHERE is_input = 0",
    "SELECT * FROM system.vector_index_segments",
    "SELECT table, part, total_vectors, dimension FROM "
    "system.vector_index_segments ORDER BY part",
])
def test_rows_match(sessions, sql):
    j, p = sessions
    assert p.sql_tsv(sql) == j.sql_tsv(sql)


@pytest.mark.parametrize("name", ["events", "metrics", "timings",
                                  "query_log", "span_log"])
def test_runtime_tables_have_the_jax_columns(sessions, name):
    j, p = sessions
    # the port's spans add their seconds to the timings; the JAX package
    # adds none of its own, so its statement is timed here, and both
    # tables have rows whose columns carry their types
    with jax_metrics.timed("query"):
        j.sql("SELECT count() FROM w")
    p.sql("SELECT count() FROM w")
    jt, pt = j.sql(f"SELECT * FROM system.{name}"), \
        p.sql(f"SELECT * FROM system.{name}")
    assert [str(f) for f in pt.schema()] == [str(f) for f in jt.schema()]


def test_query_log_records_statements(sessions):
    _, p = sessions
    p.sql("SELECT count() FROM w WHERE x > 1")
    rows = p.sql("SELECT query, result_rows, status FROM system.query_log "
                 "WHERE query = 'SELECT count() FROM w WHERE x > 1'")
    assert rows.to_rows()[-1] == ("SELECT count() FROM w WHERE x > 1", 1,
                                  "QueryFinish")


def test_events_count_queries(sessions):
    _, p = sessions

    def queries():
        return dict(p.sql("SELECT event, value FROM system.events")
                    .to_rows()).get("Query", 0)
    before = queries()
    p.sql("SELECT 1")
    assert queries() >= before + 2       # SELECT 1 and the read itself


def test_unknown_system_table_raises_as_in_the_jax_package(sessions):
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql("SELECT * FROM system.nope")
    with pytest.raises(Exception) as got:
        p.sql("SELECT * FROM system.nope")
    assert str(got.value) == str(want.value)
