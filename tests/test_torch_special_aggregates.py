"""The special aggregates (sql/agg_fns.py ``_special_aggregate``: every
``SPECIAL_AGGS`` kind) and the DISTINCT rewrite against the JAX package on
the CPU: one seeded numpy table with NULLs and a String column built into
both packages, each kind through SQL with and without GROUP BY, over an
empty selection and with String arguments.  Integers, ids, strings and
exact quantiles are compared exactly; the f64 moments (var*, stddev*,
covar*, corr, avgDistinct of floats) within rtol 1e-12, since the port
sums in another order.

The sketch pieces are held bit for bit: HLL registers against
``myscaledb_tpu.ops.hll.hll_registers`` on the same keys, uniqCombined
past its exact threshold and quantileTDigest against the JAX package's
results, and the uniqExact run-start rows against the scatter-min rows the
JAX package takes."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.config import Settings as JSettings
from myscaledb_tpu_torch.config import Settings
from myscaledb_tpu_torch.interop import table_from_numpy

torch.set_num_threads(1)

N = 1500
TAGS = ["red", "green", "blue", "", None]


def _data(rng):
    return {
        "g": rng.integers(0, 7, N).astype(np.int32),
        "v": rng.integers(-50, 50, N).astype(np.int32),
        "w": rng.integers(0, 10 ** 6, N).astype(np.int64),
        "f": np.round(rng.standard_normal(N) * 10, 2).astype(np.float32),
        "x": rng.standard_normal(N) * 1e3,
        "u": rng.integers(0, 255, N).astype(np.uint8),
        "tag": [TAGS[i] for i in rng.integers(0, len(TAGS), N)],
    }


@pytest.fixture(scope="module")
def sessions():
    data = _data(np.random.default_rng(3))
    j = myscaledb_tpu.connect(JSettings(uniq_combined_exact_rows=500))
    p = myscaledb_tpu_torch.connect(Settings(uniq_combined_exact_rows=500),
                                    device="cpu")
    j.create_table("t", data)
    p.register("t", table_from_numpy(data, "cpu"))
    j.sql("CREATE TABLE n (k Int32, y Nullable(Int32), s Nullable(String)) "
          "ENGINE = MergeTree ORDER BY k")
    p.sql("CREATE TABLE n (k Int32, y Nullable(Int32), s Nullable(String)) "
          "ENGINE = MergeTree ORDER BY k")
    rows = ", ".join(f"({i % 3}, {'NULL' if i % 4 == 0 else i % 5}, "
                     f"{'NULL' if i % 5 == 0 else repr(str(i % 3))})"
                     for i in range(40))
    for s in (j, p):
        s.sql(f"INSERT INTO n VALUES {rows}")
    return j, p


def _exact(rows):
    return [tuple(repr(x) for x in r) for r in rows]


def _close(got, want, rtol):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        for x, y in zip(rg, rw):
            if isinstance(y, float):
                if np.isnan(y):
                    assert np.isnan(x)
                else:
                    np.testing.assert_allclose(x, y, rtol=rtol, atol=0)
            else:
                assert x == y


# each special kind, several per statement (one JAX trace each)
EXACT_AGGS = [
    "uniq(v), uniqExact(v), countDistinct(w), count(DISTINCT v), "
    "uniqCombined(w), uniqHLL12(w), uniqTheta(v), uniqExact(v, u)",
    "uniq(tag), uniqExact(f), uniqHLL12(tag), uniqCombined(f), "
    "uniqCombined(v, tag)",
    "quantile(0.9)(v), median(f), quantileExact(0.25)(w), "
    "quantileExactLow(0.5)(u), quantile(x), quantile(0)(v), quantile(1)(f),"
    " quantiles(0.1, 0.5, 0.99)(w)",
    "quantileTDigest(0.5)(f), quantileTDigest(0.9)(w), groupBitAnd(w), "
    "groupBitOr(v), groupBitXor(u)",
    "sumDistinct(v), sum(DISTINCT u), avgDistinct(v), groupArray(3)(w), "
    "groupUniqArray(v), groupUniqArray(2)(tag), topK(3)(v), topK(tag)",
    # the JAX package fails on these over no rows (below)
    "argMin(w, v), argMax(tag, f), argMin(tag, w), argMax(v, u), "
    "anyLast(w), anyLast(tag)",
]
FLOAT_AGGS = [
    "varPop(v), varSamp(f), stddevPop(x), stddevSamp(w)",
    "covarPop(v, f), covarSamp(x, w), corr(v, x), avgDistinct(f), "
    "avg(DISTINCT x)",
]


@pytest.mark.parametrize("agg", EXACT_AGGS)
@pytest.mark.parametrize("shape", ["global", "grouped", "empty"])
def test_special_aggregate_matches(sessions, agg, shape):
    j, p = sessions
    sql = {"global": f"SELECT {agg} FROM t",
           "grouped": f"SELECT g, {agg}, count() FROM t GROUP BY g "
                      f"ORDER BY g",
           "empty": f"SELECT {agg} FROM t WHERE w < 0"}[shape]
    if shape == "empty" and agg.startswith("argMin"):
        # the JAX package gathers from no rows and fails (ROADMAP section
        # 3); the port gives NULL, as for a group whose rows are all NULL
        with pytest.raises(IndexError):
            j.sql(sql)
        assert p.sql(sql).to_rows() == [(None,) * 6]
        return
    assert _exact(p.sql(sql).to_rows()) == _exact(j.sql(sql).to_rows())
    assert p.sql_tsv(sql) == j.sql_tsv(sql)


@pytest.mark.parametrize("agg", FLOAT_AGGS)
def test_float_moments_match(sessions, agg):
    j, p = sessions
    for sql in (f"SELECT {agg} FROM t",
                f"SELECT g, {agg} FROM t GROUP BY g ORDER BY g",
                f"SELECT tag, {agg} FROM t WHERE g < 2 GROUP BY tag",
                f"SELECT {agg} FROM t WHERE w < 0"):
        _close(p.sql(sql).to_rows(), j.sql(sql).to_rows(), 1e-12)


@pytest.mark.parametrize("sql", [
    "SELECT uniq(y), uniqExact(s), count(DISTINCT s), quantile(0.5)(y), "
    "argMin(s, y), argMax(y, k), anyLast(y), anyLast(s), sumDistinct(y), "
    "groupArray(y), groupUniqArray(s), topK(2)(s), groupBitOr(y), "
    "quantiles(0.5)(y), quantileTDigest(y) FROM n",
    "SELECT k, uniq(y), uniqExact(s), median(y), argMin(s, y), anyLast(y), "
    "avgDistinct(y), groupArray(s) FROM n GROUP BY k ORDER BY k",
    "SELECT s, count(), uniqExact(y), quantile(0.75)(k) FROM n GROUP BY s",
    "SELECT k, uniqCombined(y), uniqHLL12(s), uniqTheta(y), varPop(y), "
    "stddevSamp(y), covarSamp(y, k), corr(k, y), groupBitAnd(y), "
    "groupBitXor(y), quantileExact(0.3)(y), quantileExactLow(0.6)(y), "
    "countDistinct(y, s) FROM n GROUP BY k ORDER BY k",
    "SELECT tag, uniqExact(v), quantile(0.5)(w), argMax(v, w), count() "
    "FROM t GROUP BY tag",
    "SELECT tag, g, countDistinct(v, u) FROM t GROUP BY tag, g ORDER BY tag,"
    " g",
    "SELECT g, uniqExact(v) AS c FROM t GROUP BY g HAVING c > 90 ORDER BY c "
    "DESC, g",
    "SELECT g, quantile(0.5)(v) + 1, uniq(v) * 2 FROM t WHERE u > 100 "
    "GROUP BY g ORDER BY g",
    "SELECT count(DISTINCT g), sum(DISTINCT g), avg(DISTINCT g), count() "
    "FROM t",
])
def test_nulls_strings_and_mixes_match(sessions, sql):
    j, p = sessions
    _close(p.sql(sql).to_rows(), j.sql(sql).to_rows(), 1e-12)
    assert p.sql_tsv(sql) == j.sql_tsv(sql)


def test_hll_registers_and_estimate_equal_the_jax_package():
    import jax.numpy as jnp
    from myscaledb_tpu.ops import hll as jh
    from myscaledb_tpu_torch.ops import hll as ph
    rng = np.random.default_rng(2)
    n, G = 20000, 5
    keys64 = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    keys32 = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    jh64 = jh.hash_key_columns((jnp.asarray(keys64), jnp.asarray(keys32)))
    ph64 = ph.hash_key_columns((torch.from_numpy(keys64),
                                torch.from_numpy(keys32)))
    assert (ph64.numpy().view(np.uint64) == np.asarray(jh64)).all()
    jr = np.asarray(jh.hll_registers(jh64, jnp.asarray(gid),
                                     jnp.asarray(mask), G))
    pr = ph.hll_registers(ph64, torch.from_numpy(gid),
                          torch.from_numpy(mask), G).numpy()
    assert (pr == jr).all()
    assert (ph.hll_estimate(torch.from_numpy(pr)).numpy() ==
            np.asarray(jh.hll_estimate(jnp.asarray(jr)))).all()
    assert (ph.splitmix64(torch.from_numpy(keys64)).numpy().view(np.uint64)
            == np.asarray(jh.splitmix64(keys64.view(np.uint64)))).all()


def test_uniq_exact_run_starts_are_the_scatter_min_rows():
    """The port takes each distinct tuple's row from the run starts of one
    stable sort; they are the rows the JAX package's scatter-min of row
    ids picks (the lowest row of each (group, value) tuple)."""
    from myscaledb_tpu_torch.exec.expr import Value
    from myscaledb_tpu_torch.sql.agg_fns import _distinct_first_hit
    rng = np.random.default_rng(4)
    n, G = 5000, 9
    v = rng.integers(0, 40, n)
    f = rng.choice(np.array([0.0, -0.0, 1.5, np.nan], dtype=np.float32), n)
    gid = rng.integers(0, G, n).astype(np.int32)
    vm = rng.random(n) < 0.8
    rows, groups = _distinct_first_hit(
        [Value(torch.from_numpy(v)), Value(torch.from_numpy(f))],
        torch.from_numpy(gid), torch.from_numpy(vm), n)
    fbits = np.where(f == 0, np.float32(0), f).view(np.int32)
    first = {}
    for r in range(n):
        if vm[r]:
            first.setdefault((gid[r], v[r], fbits[r]), r)
    assert sorted(rows.tolist()) == sorted(first.values())
    assert (groups.numpy() == gid[rows.numpy()]).all()


def test_exact_quantile_is_the_inverted_cdf_element():
    """quantile over groups of every size from 1 to 12 and levels on and
    between the steps picks np.quantile's inverted_cdf element."""
    from myscaledb_tpu_torch.exec.expr import Value
    from myscaledb_tpu_torch.sql.agg_fns import _group_sorted, _inverted_cdf
    rng = np.random.default_rng(6)
    sizes = np.arange(1, 13)
    gid = np.repeat(np.arange(12), sizes).astype(np.int32)
    vals = rng.integers(-100, 100, len(gid))
    n = len(gid)
    sv, start, count = _group_sorted(Value(torch.from_numpy(vals)),
                                     torch.from_numpy(gid),
                                     torch.ones(n, dtype=torch.bool), 12, n)
    for level in (0.0, 0.1, 0.25, 1 / 3, 0.5, 0.9, 0.999, 1.0):
        got = _inverted_cdf(sv, start, count, level).numpy()
        want = [np.quantile(vals[gid == g].astype(np.float64), level,
                            method="inverted_cdf") for g in range(12)]
        assert (got == np.asarray(want)).all()


def test_uint64_hash_distinct_counts(sessions):
    j, p = sessions
    sql = ("SELECT uniqExact(cityHash64(v)), uniq(xxHash64(tag)), "
           "count(DISTINCT sipHash64(w)) FROM t")
    assert p.sql(sql).to_rows() == j.sql(sql).to_rows()


def test_wide_group_by_beside_a_special_aggregate_takes_the_scatter_path(
        sessions, monkeypatch):
    """A GROUP BY whose one-hot matmul would take more than
    MATMUL_MAX_PRODUCTS products (sql_hits' minute buckets over 100M rows)
    sums and counts by scatter instead, with the same rows."""
    from myscaledb_tpu_torch.ops import aggregate, aggregate_matmul
    j, p = sessions
    sql = ("SELECT w % 5000 AS k, count(), sum(v), uniqExact(g) FROM t "
           "GROUP BY k ORDER BY k")
    want = j.sql(sql).to_rows()
    assert p.sql(sql).to_rows() == want              # 40 products: matmul
    calls = []
    real = aggregate_matmul.matmul_group_aggregate
    monkeypatch.setattr(aggregate_matmul, "matmul_group_aggregate",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(aggregate, "MATMUL_MAX_PRODUCTS", 39)
    assert p.sql(sql).to_rows() == want
    assert calls == []
    assert aggregate._matmul_products(100_000_000, 2880) > \
        aggregate.MATMUL_MAX_PRODUCTS
