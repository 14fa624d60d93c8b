"""arrayJoin() and [LEFT] ARRAY JOIN on the CPU, through
myscaledb_tpu.connect() and myscaledb_tpu_torch.connect(device="cpu"):
several arrays, aliases that replace or add a column, the cartesian
product of two different arrayJoin() arguments, the unequal-size error
text, and the one pinned divergence (ROADMAP section 3): LIMIT counts the
rows arrayJoin() expands to."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)

N = 12


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(5)
    lens = rng.integers(0, 4, N)
    lens[2] = 0
    data = {"id": np.arange(N, dtype=np.int64),
            "a": [rng.integers(0, 9, n).tolist() for n in lens],
            "b": [rng.integers(-5, 5, n).tolist() for n in lens],
            "s": [[["p", "q", "r"][i] for i in rng.integers(0, 3, n)]
                  for n in lens],
            "c": [rng.integers(0, 3, n).tolist()
                  for n in rng.integers(0, 3, N)],
            "g": rng.integers(0, 3, N).astype(np.int64)}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for sess in (j, p):
        sess.create_table("t", data)
    return j, p


SQL = [
    "SELECT id, a FROM t ARRAY JOIN a ORDER BY id, a",
    "SELECT id, x FROM t ARRAY JOIN a AS x ORDER BY id, x",
    "SELECT id, a, x FROM t ARRAY JOIN a AS x ORDER BY id, x",
    "SELECT id, x, y FROM t ARRAY JOIN a AS x, b AS y ORDER BY id, x, y",
    "SELECT id, s FROM t ARRAY JOIN s ORDER BY id, s",
    "SELECT id, x FROM t LEFT ARRAY JOIN a AS x ORDER BY id, x",
    "SELECT id, x FROM t LEFT ARRAY JOIN s AS x ORDER BY id, x",
    "SELECT id, x FROM t ARRAY JOIN [1, 2] AS x ORDER BY id, x",
    "SELECT id, x FROM t ARRAY JOIN a AS x WHERE x > 3 ORDER BY id, x",
    "SELECT x, count() FROM t ARRAY JOIN a AS x GROUP BY x ORDER BY x",
    "SELECT count() FROM t LEFT ARRAY JOIN a AS x",
    "SELECT g, sum(x) FROM t ARRAY JOIN a AS x GROUP BY g ORDER BY g",
    "SELECT id, arrayJoin(a) AS x FROM t ORDER BY id, x",
    "SELECT id, arrayJoin(a) AS x, arrayJoin(a) + 1 AS y FROM t "
    "ORDER BY id, x",
    "SELECT id, arrayJoin(arrayMap(x -> x * 2, a)) AS x FROM t "
    "ORDER BY id, x",
    "SELECT arrayJoin(s) AS w, count() FROM t GROUP BY w ORDER BY w",
    "SELECT id, arrayJoin(range(id % 3)) AS r FROM t ORDER BY id, r",
    "SELECT sum(arrayJoin(a)) FROM t",
]


@pytest.mark.parametrize("sql", SQL)
def test_array_join_matches(sessions, sql):
    j, p = sessions
    assert p.sql_tsv(sql) == j.sql_tsv(sql)
    assert p.sql(sql).to_rows() == j.sql(sql).to_rows()


@pytest.mark.parametrize("sql", [
    "SELECT id, x, y FROM t ARRAY JOIN a AS x, c AS y",
    "SELECT id FROM t ARRAY JOIN id",
])
def test_error_texts_match(sessions, sql):
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)


def test_unequal_sizes_error_text(sessions):
    _, p = sessions
    with pytest.raises(Exception,
                       match="ARRAY JOIN requires arrays of equal sizes"):
        p.sql("SELECT id FROM t ARRAY JOIN a AS x, c AS y")


def test_limit_counts_the_expanded_rows():
    """ClickHouse applies LIMIT after arrayJoin() expands the rows; the
    JAX package pushes the LIMIT into the scan first, so it expands only
    the first 3 base rows here and returns 2 rows (ROADMAP section 3)."""
    data = {"id": np.arange(5, dtype=np.int64),
            "a": [[1], [], [2], [3, 4, 5], [6]]}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("t", data)
    p.create_table("t", data)
    sql = "SELECT arrayJoin(a) AS x FROM t LIMIT 3"
    assert p.sql(sql).to_rows() == [(1,), (2,), (3,)]
    assert j.sql(sql).to_rows() == [(1,), (2,)]


@pytest.mark.parametrize("sql,want", [
    ("SELECT arrayJoin([1, 2, 3]) AS x, arrayJoin(['u', 'v']) AS y",
     [(1, "u"), (1, "v"), (2, "u"), (2, "v"), (3, "u"), (3, "v")]),
    ("SELECT id, arrayJoin(a) AS x, arrayJoin([7, 8]) AS y FROM t "
     "WHERE id < 2", [(0, 1, 7), (0, 1, 8)]),
])
def test_distinct_arrayjoin_arguments_multiply(sql, want):
    """Two different arrayJoin() arguments give their cartesian product,
    the first one's elements outermost, as in ClickHouse; the JAX package
    expands them together and fails unless the sizes agree (ROADMAP
    section 3)."""
    data = {"id": np.arange(3, dtype=np.int64), "a": [[1], [], [2, 3]]}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("t", data)
    p.create_table("t", data)
    assert p.sql(sql).to_rows() == want
    with pytest.raises(Exception, match="arrays of equal sizes"):
        j.sql(sql)
