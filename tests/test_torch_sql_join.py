"""Joins end to end on the CPU: one data dict into myscaledb_tpu.connect()
and myscaledb_tpu_torch.connect(device="cpu"), the same SQL through both,
compared on column names and to_rows() — values, NULLs and row order.

After tests/test_joins_full.py: INNER/LEFT/RIGHT/FULL x ANY/ALL, SEMI and
ANTI, CROSS, USING, ASOF, string and float keys, multi-column keys, table
aliases, chained joins, a join feeding an aggregate, the grace-hash
algorithm, NULL-padded sides and the error texts."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)

NAN = float("nan")


def _tables():
    rng = np.random.default_rng(21)
    n_l, n_r = 300, 120
    words = ["ant", "bee", "cat", "dog", None]
    return {
        "l": {"k": rng.integers(0, 60, n_l).astype(np.int64),
              "k2": rng.integers(0, 3, n_l).astype(np.int32),
              "lv": np.arange(n_l, dtype=np.int64),
              "s": [words[i] for i in rng.integers(0, 5, n_l)],
              "f": np.array([0.0, -0.0, 1.5, NAN, 2.5], np.float32)[
                  rng.integers(0, 5, n_l)],
              "t": rng.integers(0, 100, n_l).astype(np.int32)},
        "r": {"k": rng.integers(20, 80, n_r).astype(np.int32),
              "k2": rng.integers(0, 3, n_r).astype(np.int32),
              "rv": 1000 + np.arange(n_r, dtype=np.int64),
              "s": [words[i] for i in rng.integers(0, 5, n_r)],
              "f": np.array([0.0, 1.5, NAN, 7.0], np.float32)[
                  rng.integers(0, 4, n_r)],
              "t": rng.integers(0, 100, n_r).astype(np.int32)},
        "r2": {"rv": 1000 + np.arange(0, 120, 3, dtype=np.int64),
               "w": np.arange(40, dtype=np.int32)},
        "empty": {"k": np.zeros(0, dtype=np.int64),
                  "ev": np.zeros(0, dtype=np.int64)},
        "e": {"id": np.arange(90, dtype=np.int64),
              "emb": rng.standard_normal((90, 4)).astype(np.float32)},
    }


@pytest.fixture(scope="module")
def sessions():
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for name, data in _tables().items():
        j.create_table(name, data)
        p.create_table(name, data)
    return j, p


def _rows(t):
    return [tuple(repr(x) for x in r) for r in t.to_rows()]


SQL = [f"SELECT lv, rv FROM l {s} {h} JOIN r ON l.k = r.k"
       for s in ("ALL", "ANY") for h in ("INNER", "LEFT", "RIGHT", "FULL")]
SQL += [
    # the default strictness is ALL; OUTER is a noise word
    "SELECT lv, rv, r.k FROM l FULL OUTER JOIN r ON l.k = r.k",
    "SELECT * FROM l SEMI LEFT JOIN r ON l.k = r.k",
    "SELECT * FROM l ANTI LEFT JOIN r ON l.k = r.k",
    "SELECT l.lv, r.rv FROM l CROSS JOIN r2 AS r WHERE l.lv < 3",
    "SELECT * FROM l INNER JOIN r USING (k)",
    "SELECT * FROM l INNER JOIN r USING (k, k2)",
    "SELECT lv, rv FROM l INNER JOIN r ON l.k = r.k AND l.k2 = r.k2",
    # the sides of an ON term may come in either order
    "SELECT lv, rv FROM l INNER JOIN r ON r.k = l.k",
    # string keys (NULL strings included) and float keys (-0.0, NaN)
    "SELECT lv, rv FROM l INNER JOIN r ON l.s = r.s",
    "SELECT lv, rv, l.s, r.s FROM l LEFT JOIN r ON l.s = r.s",
    "SELECT lv, rv, l.f FROM l INNER JOIN r ON l.f = r.f",
    # table aliases, WHERE and ORDER BY on both sides, LIMIT
    "SELECT a.lv, b.rv FROM l AS a INNER JOIN r AS b ON a.k = b.k "
    "WHERE b.rv > 1050 AND a.lv < 200 ORDER BY b.rv, a.lv LIMIT 25",
    # NULL-padded right side under a filter and a sort
    "SELECT lv, rv FROM l LEFT JOIN r ON l.k = r.k WHERE lv < 40 "
    "ORDER BY lv, rv",
    # chained joins
    "SELECT lv, rv, w FROM l INNER JOIN r ON l.k = r.k "
    "INNER JOIN r2 ON r.rv = r2.rv",
    # a join feeding aggregates
    "SELECT count(), sum(lv), sum(rv) FROM l INNER JOIN r ON l.k = r.k",
    "SELECT l.k, count(), sum(rv) FROM l INNER JOIN r ON l.k = r.k "
    "GROUP BY l.k ORDER BY l.k",
    "SELECT r.k2, count(), max(lv) FROM l ANY LEFT JOIN r ON l.k = r.k "
    "GROUP BY r.k2",
    # ASOF: the closest right row on each side of the inequality
    "SELECT lv, rv, l.t, r.t FROM l INNER ASOF JOIN r "
    "ON l.k = r.k AND l.t >= r.t",
    "SELECT lv, rv FROM l LEFT ASOF JOIN r ON l.k = r.k AND l.t < r.t",
    "SELECT lv, rv FROM l INNER ASOF JOIN r ON l.k = r.k AND r.t <= l.t",
    "SELECT lv, rv FROM l LEFT ASOF JOIN r ON l.k = r.k AND l.t > r.t",
    # an empty build side
    "SELECT count() FROM l INNER JOIN empty ON l.k = empty.k",
    # the partitioned (grace) algorithm gives the same rows
    "SELECT lv, rv FROM l INNER JOIN r ON l.k = r.k "
    "SETTINGS join_algorithm = 'grace_hash'",
    "SELECT lv, rv FROM l ANY LEFT JOIN r ON l.k = r.k "
    "SETTINGS join_algorithm = 'grace_hash'",
]


@pytest.mark.parametrize("sql", SQL)
def test_rows_equal_the_jax_package(sessions, sql):
    j, p = sessions
    want, got = j.sql(sql), p.sql(sql)
    assert got.column_names == want.column_names
    assert _rows(got) == _rows(want)


def test_join_skips_the_base_tables_scan_sidecar(sessions):
    """A vector search over a joined table scans a column that is no longer
    the base table's, so the scan sidecar cached by a query on the base
    table (its squared norms) must not be used."""
    j, p = sessions
    vec = "[0.5, -0.25, 1.0, 0.0]"
    for sql in (f"SELECT id, distance(emb, {vec}) AS d FROM e "
                "ORDER BY d LIMIT 7",
                f"SELECT id, rv, distance(emb, {vec}) AS d FROM e "
                "INNER JOIN r ON e.id = r.k ORDER BY d LIMIT 7"):
        assert _rows(p.sql(sql)) == _rows(j.sql(sql))


def test_join_rows_against_a_nested_loop_oracle(sessions):
    """ALL x INNER/LEFT/RIGHT/FULL against a nested loop (the oracle of
    tests/test_joins_full.py), not just against the JAX package."""
    _j, p = sessions
    data = _tables()
    lk, lv = data["l"]["k"].tolist(), data["l"]["lv"].tolist()
    rk, rv = data["r"]["k"].tolist(), data["r"]["rv"].tolist()

    def key(t):
        return (t[0] is None, t[0] or 0, t[1] is None, t[1] or 0)
    for how, sql_how in (("INNER", "INNER JOIN"), ("LEFT", "LEFT JOIN"),
                         ("RIGHT", "RIGHT JOIN"), ("FULL", "FULL JOIN")):
        out, matched = [], set()
        for i in range(len(lk)):
            hits = [x for x in range(len(rk)) if rk[x] == lk[i]]
            matched.update(hits)
            out += [(lv[i], rv[x]) for x in hits]
            if not hits and how in ("LEFT", "FULL"):
                out.append((lv[i], None))
        if how in ("RIGHT", "FULL"):
            out += [(None, rv[x]) for x in range(len(rk)) if x not in matched]
        got = p.sql(f"SELECT lv, rv FROM l {sql_how} r ON l.k = r.k")
        assert sorted(got.to_rows(), key=key) == sorted(out, key=key), how


def test_left_join_of_an_empty_table_pads_nulls(sessions):
    """A divergence the port pins (ROADMAP queue 3): the JAX package fails
    to gather from the empty right side; the port NULL-pads it, as
    ClickHouse does."""
    j, p = sessions
    sql = "SELECT lv, ev FROM l LEFT JOIN empty ON l.k = empty.k WHERE lv < 3"
    with pytest.raises(IndexError):
        j.sql(sql)
    assert p.sql(sql).to_rows() == [(0, None), (1, None), (2, None)]


ERRORS = [
    "SELECT * FROM l INNER JOIN r ON l.k > r.k",
    "SELECT * FROM l INNER JOIN r ON l.k + 1 = r.k",
    "SELECT * FROM l INNER JOIN r ON l.k = l.lv",
    "SELECT * FROM l INNER JOIN r ON l.s = r.k",
    "SELECT * FROM l INNER JOIN nope ON l.k = nope.k",
    "SELECT * FROM l INNER ASOF JOIN r ON l.k = r.k",
    "SELECT * FROM l INNER ASOF JOIN r ON l.k = r.k AND l.t >= r.t "
    "AND l.lv < r.rv",
]


@pytest.mark.parametrize("sql", ERRORS)
def test_error_texts_match(sessions, sql):
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sql,slice_name", [
    # EXPLAIN PLAN and joinGet came with the breadth slice; SAMPLE and
    # INTO OUTFILE with the formats slice
    ("SELECT * FROM l SAMPLE 0.5 INNER JOIN r ON l.k = r.k",
     "storage, formats and runtime state"),
    ("SELECT l.k FROM l INNER JOIN r ON l.k = r.k INTO OUTFILE 'j.csv'",
     "storage, formats and runtime state"),
])
def test_outside_the_slice_raises_not_ported(sessions, sql, slice_name,
                                             tmp_path, monkeypatch):
    """Statements that raised NotPortedError naming ``slice_name`` before
    that slice landed give the JAX package's rows now, and an INTO
    OUTFILE writes its bytes."""
    monkeypatch.chdir(tmp_path)
    j, p = sessions
    want = _rows(j.sql(sql))
    jbytes = (tmp_path / "j.csv").read_bytes() if "OUTFILE" in sql else None
    got = _rows(p.sql(sql))
    assert got == want and len(got) > 0
    if jbytes is not None:
        assert (tmp_path / "j.csv").read_bytes() == jbytes
