"""Four faults of the port against the JAX package and ClickHouse, each
held by statements run through both packages on the CPU (ROADMAP section
3): integer ``%`` and ``intDiv`` by a NULL or a zero divisor, a float cast
to Int32/Int64 out of range, ``joinGet`` with several keys one of which
is a scalar, and the NULL literal.  Where the port keeps another answer
than the JAX package's (a fault of the reference), the test pins both."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu_torch.exec.expr import EvalError

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sessions():
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE TABLE z (id Int32, n Nullable(Int32)) "
              "ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO z VALUES (1, NULL), (2, 3)")
        s.create_table("fl", {
            "id": np.arange(6, dtype=np.int64),
            "f": np.array([2e10, -2e10, 1e19, -1e19, np.nan, 3.7]),
            "g": np.array([3e9, -3e9, 1e19, -1e19, np.nan, -3.7],
                          dtype=np.float32)})
        s.sql("CREATE TABLE j (a Int32, b Int32, v String) "
              "ENGINE = Join(ANY, LEFT, a, b)")
        s.sql("INSERT INTO j VALUES (1, 10, 'x'), (1, 20, 'y'), "
              "(2, 20, 'q')")
        s.sql("CREATE TABLE t (id Int32, x Int32) "
              "ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
        s.sql("CREATE TABLE w (id Int32, v Int32) "
              "ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO w VALUES (1, 4), (2, 5)")
        out.append(s)
    return tuple(out)


def _same(sessions, sql):
    j, p = sessions
    got = p.sql(sql).to_rows()
    assert repr(got) == repr(j.sql(sql).to_rows())
    return got


# -- 1. integer % and intDiv by a NULL or a zero divisor ---------------------

@pytest.mark.parametrize("sql,rows", [
    ("SELECT id, 7 % n FROM z ORDER BY id", [(1, None), (2, 1)]),
    ("SELECT id, intDiv(7, n) FROM z ORDER BY id", [(1, None), (2, 2)]),
    ("SELECT id, modulo(7, n) FROM z ORDER BY id", [(1, None), (2, 1)]),
    ("SELECT id, n % n FROM z ORDER BY id", [(1, None), (2, 0)]),
])
def test_null_divisor_gives_null(sessions, sql, rows):
    """The 0 stored under a NULL divisor is not divided by: the row is
    NULL, as in the JAX package (the port raised on the CPU)."""
    assert _same(sessions, sql) == rows


@pytest.mark.parametrize("sql,jax", [
    ("SELECT 5 % 0", [(0,)]),
    ("SELECT intDiv(5, 0)", [(-2,)]),
    ("SELECT modulo(5, 0)", [(0,)]),
    ("SELECT id, 7 % (n - n) FROM z ORDER BY id", [(1, None), (2, 0)]),
    ("SELECT id, intDiv(id, id - 1) FROM z ORDER BY id", [(1, -2), (2, 2)]),
])
def test_valid_zero_divisor_raises(sessions, sql, jax):
    """A valid zero divisor raises "Division by zero" in the port, as
    ClickHouse does; the JAX package answers with the numbers pinned here
    (a fault of the reference: ROADMAP section 3)."""
    j, p = sessions
    assert j.sql(sql).to_rows() == jax
    with pytest.raises(EvalError, match="Division by zero"):
        p.sql(sql)


# b is 0 in rows 3 and 8; 13 rows, so 4 shards pad 3 rows, with b = 0.
# No operand is negative: there the JAX package floors where the port
# truncates, as ClickHouse (ROADMAP section 3)
_DZ = {"id": np.arange(13, dtype=np.int32),
       "a": np.array([7, 9, 8, 5, 11, 4, 13, 6, 2, 10, 7, 3, 12],
                     dtype=np.int32),
       "b": np.array([3, 2, 5, 0, 4, 3, 6, 5, 0, 3, 2, 4, 5],
                     dtype=np.int32)}


@pytest.fixture(scope="module")
def dz_sessions():
    """The JAX package's session, the port's, and the port's with the
    table distributed over 4 shards (its padding rows hold b = 0)."""
    from myscaledb_tpu_torch.parallel.mesh import make_mesh
    out = []
    for s, mesh in ((myscaledb_tpu.connect(), None),
                    (myscaledb_tpu_torch.connect(device="cpu"), None),
                    (myscaledb_tpu_torch.connect(device="cpu"),
                     make_mesh(4, device="cpu"))):
        s.create_table("dz", {k: v.copy() for k, v in _DZ.items()})
        # no zero divisor in any real row
        s.create_table("dn", {"id": _DZ["id"].copy(), "a": _DZ["a"].copy(),
                              "b": np.where(_DZ["b"] == 0, 7,
                                            _DZ["b"]).astype(np.int32)})
        if mesh is not None:
            s.distribute("dz", mesh)
            s.distribute("dn", mesh)
        out.append(s)
    return tuple(out)


@pytest.mark.parametrize("sql", [
    "SELECT sum(intDiv(a, b)) FROM dz WHERE b != 0",
    "SELECT id, if(b = 0, 0, intDiv(a, b)) FROM dz ORDER BY id",
    "SELECT id FROM dz WHERE b != 0 AND a % b = 1 ORDER BY id",
    "SELECT id FROM dz WHERE b = 0 OR intDiv(a, b) > 1 ORDER BY id",
    "SELECT id, CASE WHEN b = 0 THEN -1 ELSE a % b END FROM dz ORDER BY id",
    "SELECT id, multiIf(b = 0, 0, b > 4, intDiv(a, b), a % b) FROM dz "
    "ORDER BY id",
    "SELECT a % b AS r, count() FROM dz WHERE b != 0 GROUP BY r ORDER BY r",
    "SELECT id, a % b FROM dz WHERE b != 0 ORDER BY a % b, id LIMIT 4",
    "SELECT id FROM dn WHERE a % b = 1 ORDER BY id",
    "SELECT sum(intDiv(a, b)), max(a % b) FROM dn",
])
def test_zero_divisor_in_a_dropped_row_does_not_raise(dz_sessions, sql):
    """A zero divisor in a row the statement drops (a WHERE, the branch
    if/multiIf/CASE does not take, the conjunct AND/OR does not need, a
    distributed table's padding) raises nothing: the port's answers,
    undistributed and over 4 shards, are the JAX package's."""
    j, p, pd = dz_sessions
    want = j.sql(sql).to_rows()
    assert p.sql(sql).to_rows() == want
    assert pd.sql(sql).to_rows() == want


@pytest.mark.parametrize("sql", [
    "SELECT sum(intDiv(a, b)) FROM dz",
    "SELECT id FROM dz WHERE a % b = 1",
    "SELECT id, if(b > 4, 0, intDiv(a, b)) FROM dz",
])
def test_zero_divisor_in_a_kept_row_raises(dz_sessions, sql):
    _j, p, pd = dz_sessions
    for s in (p, pd):
        with pytest.raises(EvalError, match="Division by zero"):
            s.sql(sql)


def test_alter_update_counts_a_divisor_where_it_holds(dz_sessions):
    """ALTER UPDATE evaluates its assignment over every row and writes it
    where the condition holds: a zero divisor elsewhere raises nothing."""
    got = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.create_table("du", {k: v.copy() for k, v in _DZ.items()})
        s.sql("ALTER TABLE du UPDATE a = intDiv(a, b) WHERE b != 0")
        got.append(s.sql("SELECT id, a FROM du ORDER BY id").to_rows())
    assert got[0] == got[1]


def test_float_divisor_and_or_zero_forms_are_unchanged(sessions):
    _same(sessions, "SELECT intDivOrZero(5, 0), moduloOrZero(5, 0)")
    _same(sessions, "SELECT id, 7 % 2, intDiv(7, 2), 7.5 % 2 FROM z "
                    "ORDER BY id")


# -- 2. float to integer out of range ----------------------------------------

@pytest.mark.parametrize("sql", [
    "SELECT toInt32(2e10), toInt64(1e19), toInt32(-2e10), toInt64(-1e19)",
    "SELECT id, toInt32(f), toInt64(f) FROM fl ORDER BY id",
    "SELECT id, toInt32(g), toInt64(g) FROM fl ORDER BY id",
])
def test_float_to_int_saturates(sessions, sql):
    """Out of range saturates and NaN gives 0, as XLA converts: the JAX
    package's answers (x86's bare cast gave the type's minimum)."""
    got = _same(sessions, sql)
    flat = [x for r in got for x in r]
    assert 2147483647 in flat and 9223372036854775807 in flat


def test_float_to_int_values(sessions):
    got = _same(sessions, "SELECT id, toInt32(f), toInt64(f) FROM fl "
                          "ORDER BY id")
    assert got == [(0, 2147483647, 20000000000),
                   (1, -2147483648, -20000000000),
                   (2, 2147483647, 9223372036854775807),
                   (3, -2147483648, -9223372036854775808),
                   (4, 0, 0), (5, 3, 3)]


def test_narrow_casts_still_wrap(sessions):
    assert _same(sessions, "SELECT toUInt8(300.0), toInt8(1000)") == \
        [(44, -24)]


# -- 3. joinGet with several keys, one a scalar ------------------------------

def test_join_get_mixed_scalar_and_column_keys(sessions):
    """ClickHouse answers 'x', 'y', ''; the JAX package fails on the mixed
    form ("Arguments to sort must have equal shapes"), so the port is
    pinned to its answers for the same keys given as scalars."""
    j, p = sessions
    got = p.sql("SELECT id, joinGet('j', 'v', 1, x) FROM t "
                "ORDER BY id").to_rows()
    assert got == [(1, "x"), (2, "y"), (3, "")]
    want = [j.sql(f"SELECT joinGet('j', 'v', 1, {x})").to_rows()[0][0]
            for x in (10, 20, 30)]
    assert [r[1] for r in got] == want
    with pytest.raises(Exception):
        j.sql("SELECT id, joinGet('j', 'v', 1, x) FROM t ORDER BY id")


def test_join_get_scalar_first_and_second_key(sessions):
    _j, p = sessions
    assert p.sql("SELECT id, joinGet('j', 'v', id, 20) FROM t "
                 "ORDER BY id").to_rows() == [(1, "y"), (2, "q"), (3, "")]
    _same(sessions, "SELECT joinGet('j', 'v', 1, 10), "
                    "joinGet('j', 'v', 2, 20), joinGet('j', 'v', 3, 30)")


# -- 4. the NULL literal -----------------------------------------------------

@pytest.mark.parametrize("sql,port,jax", [
    ("SELECT NULL", [(None,)], [(0,)]),
    ("SELECT NULL + 1", [(None,)], [(1,)]),
    ("SELECT id, v + NULL FROM w ORDER BY id", [(1, None), (2, None)],
     [(1, 4), (2, 5)]),
    ("SELECT id, v = NULL FROM w ORDER BY id", [(1, None), (2, None)],
     [(1, False), (2, False)]),
    ("SELECT id, greatest(v, NULL) FROM w ORDER BY id",
     [(1, None), (2, None)], [(1, 4), (2, 5)]),
    ("SELECT id, coalesce(NULL, v) FROM w ORDER BY id", [(1, 4), (2, 5)],
     [(1, 0), (2, 0)]),
    ("SELECT id, ifNull(NULL, v) FROM w ORDER BY id", [(1, 4), (2, 5)],
     [(1, 0), (2, 0)]),
    ("SELECT id, coalesce(NULL, NULL, v) FROM w ORDER BY id",
     [(1, 4), (2, 5)], [(1, 0), (2, 0)]),
])
def test_null_literal_is_null(sessions, sql, port, jax):
    """ClickHouse's answers in the port; the JAX package's literal is a
    non-nullable 0 (a fault of the reference: ROADMAP section 3)."""
    j, p = sessions
    assert p.sql(sql).to_rows() == port
    assert j.sql(sql).to_rows() == jax


@pytest.mark.parametrize("sql", [
    "SELECT isNull(NULL), if(1, NULL, 2)",
    "SELECT id, if(id > 1, NULL, v) FROM w ORDER BY id",
    "SELECT id, coalesce(v, 7) FROM w ORDER BY id",
    "SELECT count(*) FROM w WHERE v IS NOT NULL",
])
def test_null_literal_keeps_the_forms_both_packages_agree_on(sessions, sql):
    _same(sessions, sql)
