"""Subqueries, CTEs, set operations, JOIN on a subquery and computed query
vectors on the CPU, through myscaledb_tpu.connect() and
myscaledb_tpu_torch.connect(device="cpu"): the same SQL through both,
compared on to_rows() (by repr: a NaN equals a NaN, -0.0 only -0.0) and
sql_tsv().  The two sides of the set operations hold duplicates, NULLs,
-0.0, NaN and strings of two dictionaries.  The divergences pinned in
ROADMAP section 3 are tested as such."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)

D = 4


@pytest.fixture(scope="module")
def sessions():
    u = {"id": np.arange(8, dtype=np.int64),
         "k": np.array([1, 1, 2, 3, 3, 3, 5, 0], dtype=np.int64),
         "s": ["a", "a", "b", None, "c", "c", None, "zz"],
         "f": np.array([0.0, -0.0, np.nan, 1.5, 1.5, 2.0, np.nan, -1.0])}
    v = {"id": np.arange(6, dtype=np.int64) + 100,
         "k": np.array([3, 1, 3, 4, 0, 0], dtype=np.int64),
         "s": ["c", "q", None, "a", "c", "b"],
         "f": np.array([-0.0, np.nan, 1.5, 7.0, 2.0, 2.0])}
    rng = np.random.default_rng(3)
    e = {"id": np.arange(64, dtype=np.int64),
         "cat": rng.integers(0, 4, 64).astype(np.int64),
         "emb": rng.standard_normal((64, D)).astype(np.float32)}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for sess in (j, p):
        sess.create_table("u", u)
        sess.create_table("v", v)
        sess.create_table("e", e)
    return j, p


def _same(j, p, sql):
    assert p.sql_tsv(sql) == j.sql_tsv(sql)
    assert repr(p.sql(sql).to_rows()) == repr(j.sql(sql).to_rows())


SET_OPS = [
    "SELECT k FROM u UNION ALL SELECT k FROM v",
    "SELECT k FROM u UNION DISTINCT SELECT k FROM v",
    "SELECT k FROM u INTERSECT SELECT k FROM v",
    "SELECT k FROM u EXCEPT SELECT k FROM v",
    "SELECT k FROM u INTERSECT DISTINCT SELECT k FROM v",
    "SELECT k FROM u EXCEPT DISTINCT SELECT k FROM v",
    "SELECT s FROM u INTERSECT SELECT s FROM v",
    "SELECT s FROM u EXCEPT SELECT s FROM v",
    "SELECT s FROM u UNION ALL SELECT s FROM v",
    "SELECT f FROM u INTERSECT SELECT f FROM v",
    "SELECT f FROM u EXCEPT SELECT f FROM v",
    "SELECT nullIf(k, 3) AS n FROM u INTERSECT SELECT nullIf(k, 3) FROM v",
    "SELECT nullIf(k, 3) AS n FROM u EXCEPT SELECT nullIf(k, 1) FROM v",
    "SELECT k, s FROM u INTERSECT SELECT k, s FROM v",
    "SELECT k, s FROM u EXCEPT SELECT k, s FROM v",
    "SELECT k FROM u INTERSECT SELECT toFloat64(k) FROM v",
    "SELECT k FROM u EXCEPT SELECT s FROM v",
    "SELECT [k, 1] AS a FROM u INTERSECT SELECT [k, 1] FROM v",
    "SELECT k FROM u UNION ALL SELECT k FROM v EXCEPT SELECT k FROM u",
    "SELECT k AS x FROM u UNION ALL SELECT id FROM v",
]


@pytest.mark.parametrize("sql", SET_OPS)
def test_set_operations_match(sessions, sql):
    j, p = sessions
    _same(j, p, sql)


SUBQUERIES = [
    "SELECT id FROM u WHERE k IN (SELECT k FROM v) ORDER BY id",
    "SELECT id FROM u WHERE k NOT IN (SELECT k FROM v) ORDER BY id",
    "SELECT id FROM u WHERE s IN (SELECT s FROM v WHERE k = 0) ORDER BY id",
    "SELECT id FROM u WHERE s NOT IN (SELECT s FROM v WHERE k = 0) "
    "ORDER BY id",
    "SELECT id, k IN (SELECT k FROM v WHERE k > 2) AS m FROM u ORDER BY id",
    "SELECT id FROM u WHERE k IN (SELECT k FROM v WHERE k > 100)",
    "SELECT id FROM u WHERE k NOT IN (SELECT k FROM v WHERE k > 100) "
    "ORDER BY id",
    "SELECT id FROM u WHERE id IN (SELECT id FROM u ORDER BY id DESC "
    "LIMIT 3) ORDER BY id",
    "SELECT id FROM u WHERE k > (SELECT avg(k) FROM v) ORDER BY id",
    "SELECT (SELECT max(k) FROM v) AS m",
    "SELECT (SELECT k FROM v WHERE k > 100) AS m",
    "SELECT (SELECT s FROM v WHERE id = 100) AS m",
    "SELECT id FROM u WHERE EXISTS (SELECT 1 FROM v WHERE k = 4) "
    "ORDER BY id",
    "SELECT id FROM u WHERE NOT EXISTS (SELECT 1 FROM v WHERE k = 9) "
    "AND k = 3 ORDER BY id",
    "SELECT count() FROM u WHERE k IN (SELECT k FROM v UNION ALL "
    "SELECT 5)",
]


# an empty scalar subquery folds to the NULL literal: NULL in the port, as
# ClickHouse answers, 0 in the JAX package (its NULL literal is a
# non-nullable 0: ROADMAP section 3)
EMPTY_SCALAR = {"SELECT (SELECT k FROM v WHERE k > 100) AS m"}


@pytest.mark.parametrize("sql", SUBQUERIES)
def test_subqueries_match(sessions, sql):
    j, p = sessions
    if sql in EMPTY_SCALAR:
        assert (j.sql_tsv(sql), p.sql_tsv(sql)) == ("0", "\\N")
        return
    _same(j, p, sql)


CTES = [
    "WITH top AS (SELECT id, k FROM u WHERE k > 1) SELECT count(), sum(k) "
    "FROM top",
    "WITH top AS (SELECT id, k FROM u) SELECT top.id, v.id FROM top "
    "INNER JOIN v ON top.k = v.k ORDER BY top.id, v.id",
    "WITH a AS (SELECT k FROM u), b AS (SELECT k FROM a WHERE k > 1) "
    "SELECT k, count() FROM b GROUP BY k ORDER BY k",
]


@pytest.mark.parametrize("sql", CTES)
def test_ctes_match(sessions, sql):
    j, p = sessions
    _same(j, p, sql)


def test_cte_binding_is_restored_when_the_statement_raises(sessions):
    j, p = sessions
    for sess in (j, p):
        with pytest.raises(Exception):
            sess.sql("WITH u AS (SELECT 1 AS z) SELECT nope FROM u")
        assert sess.sql("SELECT count() FROM u").to_rows() == [(8,)]
    _same(j, p, "WITH u AS (SELECT k FROM v) SELECT sum(k) FROM u")
    assert p.sql("SELECT sum(k) FROM u").to_rows() == [(18,)]


JOINS = [
    "SELECT u.id, x.id FROM u INNER JOIN (SELECT id, k FROM v) AS x "
    "ON u.k = x.k ORDER BY u.id, x.id",
    "SELECT u.id, x.s FROM u LEFT JOIN (SELECT k, s FROM v WHERE k < 4) "
    "AS x ON u.k = x.k ORDER BY u.id, x.s",
    "SELECT u.id, x.k FROM u RIGHT JOIN (SELECT k FROM v) AS x "
    "ON u.k = x.k ORDER BY x.k, u.id",
    "SELECT u.id, x.k FROM u FULL JOIN (SELECT k FROM v) AS x "
    "ON u.k = x.k ORDER BY u.id, x.k",
    "SELECT u.id, x.id FROM u LEFT ANY JOIN (SELECT id, k FROM v) AS x "
    "ON u.k = x.k ORDER BY u.id",
    "SELECT u.id FROM u LEFT SEMI JOIN (SELECT k FROM v) AS x "
    "ON u.k = x.k ORDER BY u.id",
    "SELECT u.id FROM u LEFT ANTI JOIN (SELECT k FROM v) AS x "
    "ON u.k = x.k ORDER BY u.id",
    "SELECT u.id, x.m FROM u CROSS JOIN (SELECT max(k) AS m FROM v) AS x "
    "ORDER BY u.id",
    "SELECT * FROM u INNER JOIN (SELECT k, f FROM v) USING k "
    "ORDER BY id, f",
    "SELECT u.id, x.id FROM u LEFT ASOF JOIN (SELECT id, k, id - 100 AS t "
    "FROM v) AS x ON u.k = x.k AND u.id >= x.t ORDER BY u.id",
    "SELECT c.cat, count(), min(c.d) FROM (SELECT id, cat, "
    "distance(emb, [0.1, 0.2, 0.3, 0.4]) AS d FROM e ORDER BY d LIMIT 20) "
    "AS c INNER JOIN (SELECT id FROM e WHERE cat < 3) AS m ON c.id = m.id "
    "GROUP BY c.cat ORDER BY c.cat",
]


@pytest.mark.parametrize("sql", JOINS)
def test_join_on_a_subquery_matches(sessions, sql):
    j, p = sessions
    _same(j, p, sql)


QVEC = "[0.1, -0.2, 0.3, 0.05]"
COMPUTED = [
    "WITH {q} AS q SELECT id FROM e ORDER BY distance(emb, q) LIMIT 5",
    "SELECT id, distance(emb, arrayMap(x -> x / 10, [1, -2, 3, 0.5])) AS d "
    "FROM e ORDER BY d LIMIT 5",
    "SELECT id, distance(emb, (SELECT emb FROM e WHERE id = 7)) AS d "
    "FROM e WHERE cat < 3 ORDER BY d LIMIT 5",
]


@pytest.mark.parametrize("sql", COMPUTED)
def test_computed_query_vectors_give_the_literals_rows(sessions, sql):
    j, p = sessions
    sql = sql.format(q=QVEC)
    _same(j, p, sql)
    ids = [r[0] for r in p.sql(sql).to_rows()]
    if "id = 7" in sql:
        q = p.sql("SELECT emb FROM e WHERE id = 7").to_rows()[0][0]
        lit = "[" + ", ".join(repr(float(x)) for x in q) + "]"
        want = p.sql(f"SELECT id FROM e WHERE cat < 3 ORDER BY "
                     f"distance(emb, {lit}) LIMIT 5").to_rows()
    else:
        want = p.sql(f"SELECT id FROM e ORDER BY distance(emb, {QVEC}) "
                     "LIMIT 5").to_rows()
    assert ids == [r[0] for r in want]


@pytest.mark.parametrize("sql", [
    "SELECT id, distance(emb, 5) AS d FROM e ORDER BY d LIMIT 3",
    "SELECT id, distance(emb, nope) AS d FROM e ORDER BY d LIMIT 3",
    "SELECT (SELECT k FROM v) AS m",
    "SELECT k FROM u UNION ALL SELECT k, s FROM v",
    "SELECT id FROM u WHERE s IN (SELECT k FROM v)",
])
def test_error_texts_match(sessions, sql):
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)


def test_null_in_the_subquery_matches_nothing(sessions):
    """A NULL in the subquery's column matches no row in the port, as in
    ClickHouse; the JAX package matches the value stored under the NULL
    (here 3, the value nullIf hid) (ROADMAP section 3)."""
    j, p = sessions
    sql = ("SELECT id FROM u WHERE k IN (SELECT nullIf(k, 3) FROM v) "
           "ORDER BY id")
    assert p.sql(sql).to_rows() == [(0,), (1,), (7,)]
    assert j.sql(sql).to_rows() == [(0,), (1,), (3,), (4,), (5,), (7,)]


def test_in_subquery_after_a_where(sessions):
    """IN (subquery) in the SELECT list of a statement with a WHERE: every
    Env of the port's statement carries the subquery runner; the JAX
    package sets it on the first one only and fails (ROADMAP section 3)."""
    j, p = sessions
    sql = ("SELECT id, k IN (SELECT k FROM v) AS m FROM u WHERE id < 4 "
           "ORDER BY id")
    assert p.sql(sql).to_rows() == [(0, 1), (1, 1), (2, 0), (3, 1)]
    with pytest.raises(Exception, match="not available in this context"):
        j.sql(sql)


def test_in_subquery_order_by_is_dropped(sessions, monkeypatch):
    """The optimizer's removeRedundantSorting pass runs: an IN subquery's
    ORDER BY (set semantics) is dropped before the subquery runs."""
    from myscaledb_tpu_torch.sql import executor
    removed = []
    real = executor.remove_redundant_sorting

    def spy(q):
        out = real(q)
        removed.extend(out)
        return out
    monkeypatch.setattr(executor, "remove_redundant_sorting", spy)
    j, p = sessions
    sql = "SELECT id FROM u WHERE k IN (SELECT k FROM v ORDER BY k) ORDER BY id"
    assert p.sql(sql).to_rows() == j.sql(sql).to_rows()
    assert "IN-subquery ORDER BY [k]" in removed
