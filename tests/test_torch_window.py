"""Window functions through SQL against the JAX package on the CPU: the
same data and statements into myscaledb_tpu.connect() and
myscaledb_tpu_torch.connect(device="cpu").

The window cases of tests/test_window.py compare on ``sql_tsv``; random
partitions with ties and NULLs compare row by row: integers (row_number,
rank, dense_rank, ntile, counts, integer sums, min/max, lag/lead with
their NULLs) equal, float sums and averages within rtol 2e-5 or atol
2e-5 x the partition's sum of |x| (the f32 cumsum adds in another order:
PyTorch accumulates in f64 on the CPU).  Error texts equal."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)

RTOL = 2e-5


def _both(setup):
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    setup(j)
    setup(p)
    return j, p


@pytest.fixture(scope="module")
def wsess():
    def setup(s):
        s.create_table("t", {
            "dept": ["a", "a", "a", "b", "b", "c"],
            "emp": np.arange(6, dtype=np.int64),
            "salary": np.array([100, 200, 200, 50, 70, 90], dtype=np.int64),
        })
    return _both(setup)


# the window statements of tests/test_window.py
WINDOW_CASES = [
    "SELECT dept, emp, row_number() OVER (PARTITION BY dept ORDER BY "
    "salary DESC) AS rn, rank() OVER (PARTITION BY dept ORDER BY salary "
    "DESC) AS rk, dense_rank() OVER (PARTITION BY dept ORDER BY salary "
    "DESC) AS dr FROM t ORDER BY dept, salary DESC, emp",
    "SELECT emp, sum(salary) OVER (PARTITION BY dept ORDER BY emp) AS run, "
    "sum(salary) OVER (PARTITION BY dept) AS tot FROM t ORDER BY emp",
    "SELECT emp, sum(salary) OVER (ORDER BY salary) AS r FROM t "
    "ORDER BY emp",
    "SELECT emp, lag(salary) OVER (ORDER BY emp) AS prev, "
    "lead(salary, 1, -1) OVER (ORDER BY emp) AS nxt FROM t ORDER BY emp",
    "SELECT emp, min(salary) OVER (PARTITION BY dept) AS lo, "
    "max(salary) OVER (PARTITION BY dept ORDER BY emp) AS hi, "
    "count(*) OVER (PARTITION BY dept) AS c FROM t ORDER BY emp",
    "SELECT emp, avg(salary) OVER (PARTITION BY dept) AS a FROM t "
    "WHERE dept = 'b' ORDER BY emp",
    "SELECT emp, row_number() OVER (ORDER BY salary DESC) AS rn FROM t "
    "WHERE salary >= 90 ORDER BY rn",
    "SELECT dept, sum(salary) AS s, rank() OVER (ORDER BY sum(salary) DESC) "
    "AS rk FROM t GROUP BY dept ORDER BY dept",
    "SELECT emp, first_value(salary) OVER (PARTITION BY dept ORDER BY "
    "salary) AS fv, last_value(salary) OVER (PARTITION BY dept) AS lv, "
    "ntile(2) OVER (PARTITION BY dept ORDER BY emp) AS nt FROM t "
    "ORDER BY emp",
    "SELECT count(*) FROM t SETTINGS enable_brute_force_vector_search=1",
    # beyond tests/test_window.py: strings through first_value and lag,
    # a window over an aggregate's single row, a window as ORDER BY key
    "SELECT emp, first_value(dept) OVER (ORDER BY salary DESC) AS f, "
    "lag(dept, 2) OVER (PARTITION BY dept ORDER BY emp) AS l FROM t "
    "ORDER BY emp",
    "SELECT sum(salary), row_number() OVER () AS rn FROM t",
    "SELECT emp FROM t ORDER BY rank() OVER (ORDER BY salary), emp DESC",
    "SELECT emp, ntile(4) OVER (ORDER BY emp DESC) AS q FROM t ORDER BY emp",
]


@pytest.mark.parametrize("stmt", WINDOW_CASES)
def test_window_case(wsess, stmt):
    j, p = wsess
    assert p.sql_tsv(stmt) == j.sql_tsv(stmt)


ERROR_CASES = [
    # unsupported window function
    "SELECT emp, median(salary) OVER (PARTITION BY dept) FROM t",
    "SELECT emp, uniqExact(salary) OVER () FROM t",
    # a window mixed with a plain aggregate (the window's argument is gone
    # from the aggregated table)
    "SELECT sum(salary) OVER (), count() FROM t",
    # a window inside an expression is not evaluated
    "SELECT emp, row_number() OVER () + 1 AS x FROM t",
    "SELECT emp, lag(salary, emp) OVER (ORDER BY emp) FROM t",
]


@pytest.mark.parametrize("stmt", ERROR_CASES)
def test_window_error_texts(wsess, stmt):
    j, p = wsess
    with pytest.raises(Exception) as je:
        j.sql(stmt)
    with pytest.raises(Exception) as pe:
        p.sql(stmt)
    assert (type(pe.value).__name__, str(pe.value)) == \
        (type(je.value).__name__, str(je.value))


def test_window_over_no_rows(wsess):
    """Pinned divergence: over an empty input the JAX package fails inside
    its gather (a TypeError); the port returns no rows."""
    _j, p = wsess
    assert p.sql_tsv("SELECT dept, sum(salary) OVER (PARTITION BY dept) "
                     "FROM t WHERE emp > 10") == ""


# -- random partitions with ties and NULLs ----------------------------------

N_RANDOM = 600


def _sql_value(x):
    return "NULL" if x is None else repr(x)


@pytest.fixture(scope="module")
def rsess():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 12, N_RANDOM)
    v = rng.integers(0, 6, N_RANDOM)            # heavy ties
    vnull = rng.random(N_RANDOM) < 0.15
    f = rng.standard_normal(N_RANDOM).astype(np.float32) * 100
    rows = ", ".join(
        f"({i}, {g[i]}, {_sql_value(None if vnull[i] else int(v[i]))}, "
        f"{float(f[i])!r}, {int(v[i]) % 3})" for i in range(N_RANDOM))

    def setup(s):
        s.sql("CREATE TABLE r (id Int64, g Int32, v Nullable(Int32), "
              "f Float32, w Int32) ENGINE = Memory")
        s.sql(f"INSERT INTO r VALUES {rows}")
    j, p = _both(setup)
    return j, p, g, f


INT_STATEMENTS = [
    "SELECT id, row_number() OVER (PARTITION BY g ORDER BY w) AS a, "
    "rank() OVER (PARTITION BY g ORDER BY w) AS b, "
    "dense_rank() OVER (PARTITION BY g ORDER BY w DESC) AS c, "
    "ntile(3) OVER (PARTITION BY g ORDER BY w, id) AS d FROM r ORDER BY id",
    "SELECT id, rank() OVER (PARTITION BY g ORDER BY v) AS a, "
    "rank() OVER (PARTITION BY g ORDER BY v DESC NULLS FIRST) AS b, "
    "dense_rank() OVER (ORDER BY v NULLS FIRST, w) AS c FROM r ORDER BY id",
    "SELECT id, sum(w) OVER (PARTITION BY g ORDER BY w) AS a, "
    "sum(w) OVER (PARTITION BY g) AS b, count() OVER (PARTITION BY g "
    "ORDER BY w DESC) AS c, min(w) OVER (PARTITION BY g ORDER BY id) AS d, "
    "max(g) OVER (PARTITION BY w ORDER BY g) AS e FROM r ORDER BY id",
    "SELECT id, lag(v) OVER (PARTITION BY g ORDER BY id) AS a, "
    "lead(v, 2, 0) OVER (PARTITION BY g ORDER BY id) AS b, "
    "lag(w, 3, -1) OVER (ORDER BY w, id) AS c, "
    "first_value(v) OVER (PARTITION BY g ORDER BY w) AS d, "
    "last_value(v) OVER (PARTITION BY g ORDER BY w) AS e FROM r ORDER BY id",
    "SELECT id, min(f) OVER (PARTITION BY g) AS a, max(f) OVER "
    "(PARTITION BY w ORDER BY g) AS b, first_value(f) OVER (PARTITION BY g "
    "ORDER BY f DESC) AS c FROM r ORDER BY id",
]


@pytest.mark.parametrize("stmt", INT_STATEMENTS)
def test_random_partitions_exact(rsess, stmt):
    j, p, _g, _f = rsess
    assert p.sql_tsv(stmt) == j.sql_tsv(stmt)


@pytest.mark.parametrize("order", ["", " ORDER BY w", " ORDER BY f DESC"])
def test_random_partitions_float_sums(rsess, order):
    """sum(f) and avg(f) per partition, whole or running with peers:
    within rtol 2e-5 of the JAX package's, or atol 2e-5 x the partition's
    sum of |f| (cancellation)."""
    j, p, g, f = rsess
    stmt = (f"SELECT id, g, sum(f) OVER (PARTITION BY g{order}) AS s, "
            f"avg(f) OVER (PARTITION BY g{order}) AS a, "
            f"count() OVER (PARTITION BY g{order}) AS c FROM r ORDER BY id")
    want = j.sql(stmt).to_pydict()
    got = p.sql(stmt).to_pydict()
    for col in ("id", "g", "c"):
        assert got[col] == want[col]
    abs_sum = np.bincount(g, weights=np.abs(f.astype(np.float64)))
    atol = 2e-5 * abs_sum[np.asarray(want["g"])]
    # an average's error is its sum's over the frame's row count
    for col, tol in (("s", atol), ("a", atol / np.asarray(want["c"]))):
        w = np.asarray(want[col], dtype=np.float64)
        x = np.asarray(got[col], dtype=np.float64)
        assert np.all(np.abs(x - w) <= np.maximum(RTOL * np.abs(w), tol))
