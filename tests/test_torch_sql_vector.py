"""The vector slice end to end on the CPU: one data dict into
myscaledb_tpu.connect() and myscaledb_tpu_torch.connect(device="cpu"), the
same SQL through both, compared on to_rows() and sql_tsv()."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu_torch.ops.kernels import distance as K2
from myscaledb_tpu_torch.ops.kernels import distance_q as K1

torch.set_num_threads(1)

N, D = 300, 3
TAGS = ["red", "green", "blue", None]


def _vec(v) -> str:
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(7)
    data = {
        "id": np.arange(N, dtype=np.int64),
        "price": rng.integers(0, 100, N).astype(np.int32),
        "tag": [TAGS[i] for i in rng.integers(0, 4, N)],
        "emb": rng.standard_normal((N, D)).astype(np.float32),
    }
    data["emb"][10:14] = data["emb"][9]          # exact ties
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("t", data)
    p.create_table("t", data)
    return j, p, rng.standard_normal(D).astype(np.float32)


def _rows_close(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float):
                np.testing.assert_allclose(x, y, rtol=2e-5, atol=2e-5)
            else:
                assert x == y


# L2 and IP distances are bit-equal at d = 3 (ordered f32 sums), so the
# TSV text must match byte for byte; Cosine's norms are library sums
# (ROADMAP queue 3), so it is compared on rows within the reference's
# tolerance.
EXACT_SQL = [
    "SELECT id, distance(emb, {q}) AS d FROM t WHERE price < 50 "
    "ORDER BY d LIMIT 10",
    "SELECT id, price, L2Distance(emb, {q}) AS d FROM t "
    "WHERE tag = 'red' ORDER BY d LIMIT 7",
    "SELECT id, dotProduct(emb, {q}) AS s FROM t WHERE tag IN ('red', "
    "'blue') AND price BETWEEN 10 AND 80 ORDER BY s DESC LIMIT 5",
    "SELECT id, tag, distance(emb, {q}) AS d FROM t WHERE tag != 'green' "
    "OR price >= 90 ORDER BY d LIMIT 6 OFFSET 3",
    "SELECT id, distance(emb, {q}) AS d FROM t WHERE price < 50 AND "
    "d < 1.5 ORDER BY d LIMIT 20",
    "SELECT id, distance(emb, {q}) AS d FROM t WHERE price = 17 "
    "ORDER BY d LIMIT 50",
    "SELECT id FROM t PREWHERE price > 95 WHERE NOT tag = 'blue' "
    "ORDER BY distance(emb, {q}) LIMIT 4",
    "SELECT id, distance(emb, {q}) AS d, price * 2 AS p2, price / 4 AS p4, "
    "price + 1.5 AS pf FROM t WHERE price < 30 ORDER BY d LIMIT 8",
    "SELECT * FROM t WHERE id < 5",
    "SELECT id, tag FROM t WHERE tag < 'h' ORDER BY price DESC, id "
    "LIMIT 12",
    "SELECT id, distance(emb, {q}) AS d FROM t WHERE price < 20 "
    "ORDER BY id LIMIT 5",
    "SELECT id, abs(price - 50) AS a, if(price > 50, price, -price) AS b, "
    "greatest(price, 40) AS g, intDiv(price, 7) AS q7, modulo(price, 7) "
    "AS m7, toFloat32(price) AS f FROM t WHERE isNotNull(tag) "
    "ORDER BY a, id LIMIT 9",
    "SELECT id FROM t LIMIT 3",
    "SELECT id, tag FROM t WHERE isNull(tag) AND id < 40",
]


@pytest.mark.parametrize("sql", EXACT_SQL)
def test_sql_tsv_and_rows_match(sessions, sql):
    j, p, q = sessions
    sql = sql.format(q=_vec(q))
    assert p.sql_tsv(sql) == j.sql_tsv(sql)
    assert p.sql(sql).to_rows() == j.sql(sql).to_rows()


@pytest.mark.parametrize("sql", [
    "SELECT id, floor(price / 3) AS f, ceil(price / 3) AS c, "
    "round(price / 3) AS r, round(price / 7, 2) AS r2, round(price) AS ri, "
    "sqrt(price) AS s, exp(price / 50) AS e, log(price + 1) AS l, "
    "pow(price, 2) AS pw, least(price, 40) AS le, negate(price) AS ng, "
    "toInt32(price) AS i32, toInt64(price) AS i64, toFloat64(price) AS f64, "
    "plus(price, 1) AS pl, minus(price, 1) AS mi, multiply(price, 3) AS mu, "
    "divide(price, 3) AS dv, -price AS un FROM t WHERE id < 40 ORDER BY id",
    "SELECT id, cosineDistance(emb, {q}) AS d FROM t WHERE price < 60 "
    "ORDER BY d LIMIT 10",
    "SELECT id, cosineDistance(emb, {q}) AS d FROM t WHERE tag = 'green' "
    "ORDER BY d LIMIT 500",
])
def test_float_rows_match(sessions, sql):
    """Results whose floats come from library math (exp, log, pow, cosine
    norms) that the two packages may round differently in the last ulp."""
    j, p, q = sessions
    sql = sql.format(q=_vec(q))
    _rows_close(p.sql(sql).to_rows(), j.sql(sql).to_rows())


@pytest.mark.parametrize("sql", [
    "SELECT id, dotProduct(emb, {q}) AS s FROM t ORDER BY s LIMIT 3",
    "SELECT id, distance(emb, {q}) AS d FROM t ORDER BY d DESC LIMIT 3",
    "SELECT id, distance(emb, {q}) AS d, L2Distance(emb, {q}) AS e FROM t "
    "ORDER BY d LIMIT 3",
    "SELECT id, distance(nope, {q}) AS d FROM t ORDER BY d LIMIT 3",
    # a WHERE on the distance of a query that does not fuse: both packages
    # fail ("unknown function 'distance'"; ROADMAP queue 3)
    "SELECT id, distance(emb, {q}) AS d FROM t WHERE d < 1.0 "
    "ORDER BY price, id",
])
def test_error_texts_match(sessions, sql):
    j, p, q = sessions
    sql = sql.format(q=_vec(q))
    with pytest.raises(Exception) as je:
        j.sql(sql)
    with pytest.raises(Exception) as pe:
        p.sql(sql)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("sql", [
    "SELECT tag, uniqExact(id) FROM t GROUP BY tag",
    "SELECT quantile(0.5)(price) FROM t",
    "SELECT id FROM t AS a JOIN t AS b ON a.id = b.id",
    "CREATE TABLE u (id Int64) ENGINE = MergeTree ORDER BY id",
    "SELECT sumState(price) FROM t",
    "SELECT TextSearch(tag, 'red') AS s FROM t ORDER BY s DESC LIMIT 3",
    "SELECT id FROM t WHERE id IN (SELECT id FROM t WHERE price < 3)",
    "SELECT lower(tag) FROM t",
])
def test_outside_the_slice_raises_not_ported(sessions, sql):
    _, p, _ = sessions
    with pytest.raises(myscaledb_tpu_torch.NotPortedError):
        p.sql(sql)


def test_explain_ast_matches(sessions):
    j, p, q = sessions
    sql = ("EXPLAIN AST SELECT id, distance(emb, {q}) AS d FROM t "
           "WHERE price < 50 ORDER BY d LIMIT 10").format(q=_vec(q))
    assert p.sql(sql).to_rows() == j.sql(sql).to_rows()


def test_main_path_at_d128_takes_the_k1_branch(monkeypatch):
    """n = 65,536, d = 128: the port's CPU run scans through the certified
    int8 branch (segmin_sq8_plain) and returns the JAX package's rows."""
    calls = {"sq8": 0, "f32": 0}
    real_sq8, real_f32 = K1.segmin_sq8_plain, K2.segmin_f32_plain

    def spy_sq8(*a):
        calls["sq8"] += 1
        return real_sq8(*a)

    def spy_f32(*a):
        calls["f32"] += 1
        return real_f32(*a)

    monkeypatch.setattr(K1, "segmin_sq8_plain", spy_sq8)
    monkeypatch.setattr(K2, "segmin_f32_plain", spy_f32)
    rng = np.random.default_rng(11)
    n, d = 1 << 16, 128
    data = {"id": np.arange(n, dtype=np.int64),
            "price": rng.integers(0, 100, n).astype(np.int32),
            "emb": rng.standard_normal((n, d)).astype(np.float32)}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("big", data)
    p.create_table("big", data)
    for _ in range(2):
        sql = ("SELECT id, price, distance(emb, {q}) AS d FROM big WHERE "
               "price < 50 ORDER BY d LIMIT 10").format(
                   q=_vec(rng.standard_normal(d)))
        _rows_close(p.sql(sql).to_rows(), j.sql(sql).to_rows())
    assert calls == {"sq8": 2, "f32": 0}
    assert K1.segmin_sq8.launches == 0


@pytest.fixture(scope="module")
def wide_sessions():
    """140,000 rows over three zone-map blocks, and the same data with the
    vector column kept on the host (memory governor)."""
    rng = np.random.default_rng(5)
    n = 140_000
    data = {"id": np.arange(n, dtype=np.int64),
            "price": rng.integers(0, 100, n).astype(np.int32),
            "emb": rng.standard_normal((n, D)).astype(np.float32)}
    out = []
    for budget in (0, 1 << 20):
        j = myscaledb_tpu.connect(
            myscaledb_tpu.config.Settings(max_hbm_bytes_per_column=budget))
        p = myscaledb_tpu_torch.connect(
            myscaledb_tpu_torch.config.Settings(
                max_hbm_bytes_per_column=budget), device="cpu")
        j.create_table("w", data)
        p.create_table("w", data)
        out.append((j, p))
    return out, rng.standard_normal(D).astype(np.float32)


@pytest.mark.parametrize("host_vectors", [False, True])
@pytest.mark.parametrize("where", ["id >= 131072", "price > 1000",
                                   "price < 50"])
def test_zone_map_pruning_and_host_column_match(wide_sessions, host_vectors,
                                                where):
    pairs, q = wide_sessions
    j, p = pairs[int(host_vectors)]
    assert p.tables["w"]["emb"].is_host == host_vectors
    sql = (f"SELECT id, distance(emb, {_vec(q)}) AS d FROM w WHERE {where} "
           "ORDER BY d LIMIT 10")
    assert p.sql_tsv(sql) == j.sql_tsv(sql)
