"""INSERT into a distributed table, the port against the JAX package, after
tests/test_distributed_insert.py: new rows route to shards by the hash of
the first ORDER BY key (round-robin without an integer key) and each
shard's rows grow in place, so the global order becomes shard-major.  The
same DDL and INSERTs through both packages; rows compared exactly,
including the order of statements with no ORDER BY, and the padded layout
itself (each column's values, the ``__row_valid__`` mask)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh

from myscaledb_tpu_torch.interop import distributed_table_from_numpy
from myscaledb_tpu_torch.parallel.dist_table import ROW_VALID
from myscaledb_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def _both(ddl: str, first: str, later: list, nsh: int = 8):
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s, mesh in ((j, j_mesh(nsh)), (p, make_mesh(nsh, device="cpu"))):
        s.sql(ddl)
        s.sql(first)
        s.distribute("t", mesh)
        for stmt in later:
            s.sql(stmt)
    return j, p


def _values(t, name):
    c = t[name]
    if c.dictionary is not None:
        return c.to_python()
    return np.asarray(c.data if not isinstance(c.data, torch.Tensor)
                      else c.data.numpy())


@pytest.fixture(scope="module")
def id_v():
    """(JAX, port) sessions whose table t (id, v = 2 id) took 64 rows, was
    distributed over 8 shards and took 20 more; shared by the tests that
    read it, so the JAX session and its statements compile once."""
    n = 64
    return _both(
        "CREATE TABLE t (id Int64, v Int64) ENGINE = MergeTree ORDER BY id",
        "INSERT INTO t VALUES " + ",".join(f"({i},{i * 2})"
                                           for i in range(n)),
        ["INSERT INTO t VALUES " + ",".join(f"({i},{i * 2})"
                                            for i in range(n, n + 20))])


def test_insert_into_distributed_table(id_v):
    j, p = id_v
    n = 64
    t = p.tables["t"]
    assert t.mesh.size == 8 and t.real_rows == n + 20
    r = p.sql("SELECT count(), sum(v) FROM t").to_rows()
    assert r[0] == (n + 20, sum(i * 2 for i in range(n + 20)))
    for q in ("SELECT v FROM t ORDER BY id DESC LIMIT 3",
              "SELECT id, v FROM t LIMIT 100",
              "SELECT id FROM t WHERE v % 3 = 0 LIMIT 10"):
        assert p.sql_tsv(q) == j.sql_tsv(q), q
    # the padded layout is the JAX package's
    jt = j.tables["t"]
    for name in ("id", "v", ROW_VALID):
        np.testing.assert_array_equal(_values(t, name), _values(jt, name))


@pytest.mark.parametrize("nsh", [8, 3])
def test_nullable_and_string_columns(nsh):
    j, p = _both(
        "CREATE TABLE t (id Int64, name String, x Nullable(Int32), "
        "f Float32) ENGINE = MergeTree ORDER BY id",
        "INSERT INTO t VALUES (1,'a',1,0.5),(2,'b',NULL,1.5),(3,'c',3,2.5),"
        "(4,'d',NULL,3.5)",
        ["INSERT INTO t VALUES (5,'e',5,4.5),(6,'f',NULL,5.5)",
         "INSERT INTO t VALUES (7,'b',7,6.5),(8,'zz',NULL,7.5),"
         "(9,'a',9,8.5)"], nsh)
    for q in ("SELECT name FROM t ORDER BY id",
              "SELECT id, name, x, f FROM t",
              "SELECT name, count(), sum(x) FROM t GROUP BY name "
              "ORDER BY name",
              "SELECT id FROM t WHERE x IS NULL ORDER BY id"):
        assert p.sql_tsv(q) == j.sql_tsv(q), q
    assert [r[0] for r in p.sql("SELECT name FROM t ORDER BY id")
            .to_rows()] == ["a", "b", "c", "d", "e", "f", "b", "zz", "a"]
    t, jt = p.tables["t"], j.tables["t"]
    np.testing.assert_array_equal(_values(t, ROW_VALID),
                                  _values(jt, ROW_VALID))
    rv = _values(t, ROW_VALID).astype(bool)
    assert list(np.asarray(_values(t, "name"), dtype=object)[rv]) == \
        list(np.asarray(_values(jt, "name"), dtype=object)[rv])


def test_column_subset_insert_takes_defaults():
    """Absent columns take their type's default, as an INSERT into the
    undistributed table gives them (the JAX package's distributed INSERT
    fails on a column subset)."""
    ddl = ("CREATE TABLE t (id Int64, name String, x Nullable(Int32)) "
           "ENGINE = MergeTree ORDER BY id")
    sessions = []
    for mesh in (None, make_mesh(4, device="cpu")):
        s = myscaledb_tpu_torch.connect(device="cpu")
        s.sql(ddl)
        s.sql("INSERT INTO t VALUES (1,'a',1),(2,'b',NULL)")
        if mesh is not None:
            s.distribute("t", mesh)
        s.sql("INSERT INTO t (id, name) VALUES (10,'q'),(11,'r')")
        sessions.append(s)
    q = "SELECT id, name, x FROM t ORDER BY id"
    assert sessions[1].sql_tsv(q) == sessions[0].sql_tsv(q)


def test_round_robin_without_an_integer_key():
    """A String first ORDER BY key hashes its dictionary ids (as the JAX
    package does); a table with no ORDER BY goes round-robin."""
    for ddl in ("CREATE TABLE t (name String, v Int64) ENGINE = MergeTree "
                "ORDER BY name",
                "CREATE TABLE t (v Int64, name String) ENGINE = Memory"):
        j, p = _both(ddl, "INSERT INTO t VALUES " + ",".join(
            f"('n{i % 5}',{i})" if "ORDER BY name" in ddl
            else f"({i},'n{i % 5}')" for i in range(11)),
            ["INSERT INTO t VALUES " + ",".join(
                f"('n{i % 7}',{i})" if "ORDER BY name" in ddl
                else f"({i},'n{i % 7}')" for i in range(11, 40))])
        q = "SELECT v, name FROM t"
        assert p.sql_tsv(q) == j.sql_tsv(q), ddl


def test_state_carried_from_the_jax_package(id_v):
    """interop.distributed_table_from_numpy: the JAX package's padded,
    shard-major table after an INSERT, carried across, answers as the
    JAX session does."""
    j, _p = id_v
    jt = j.tables["t"]
    cols = {n: _values(jt, n) for n in ("id", "v", ROW_VALID)}
    t = distributed_table_from_numpy(cols, jt.mesh.shape["shard"], "cpu",
                                     name="t")
    s = myscaledb_tpu_torch.connect(device="cpu")
    s.register("t", t)
    assert s.tables["t"].real_rows == 84
    for q in ("SELECT id, v FROM t LIMIT 100",
              "SELECT v % 9 AS r, count() FROM t GROUP BY r ORDER BY r",
              "SELECT id FROM t ORDER BY v DESC, id LIMIT 5"):
        assert s.sql_tsv(q) == j.sql_tsv(q), q
