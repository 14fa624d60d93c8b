"""batch_distance with LIMIT BY through both packages' SQL on the CPU.

At n = 65,536 rows of d = 128 the port's scan takes the kernel branches
(their plain versions, since the tensors are on the CPU): the SQ8 sidecar
and K1 for every statement, and K2 as well where the certificate cannot
hold (identical rows).  Ids, query indices and row order must equal the
JAX package's; distances agree within the reference's own tolerance
(rtol 2e-5, tests/test_vector.py) — at d = 128 the two libraries sum in
different orders."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu_torch.ops.kernels import distance as K2
from myscaledb_tpu_torch.ops.kernels import distance_q as K1

torch.set_num_threads(1)

N, D = 1 << 16, 128
METRICS = ["L2", "Cosine", "IP"]


def _vec(v) -> str:
    return "[" + ",".join(repr(float(a)) for a in v) + "]"


def _stmt(metric, queries, table="t", k=10, where="WHERE price < 50"):
    qs = "[" + ",".join(_vec(q) for q in queries) + "]"
    desc = " DESC" if metric == "IP" else ""
    return (f"SELECT id, batch_distance(emb, {qs}) AS dist FROM {table} "
            f"{where} ORDER BY dist.1, dist.2{desc} LIMIT {k} BY dist.1")


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((N // 4, D), dtype=np.float32)
    data = {"id": np.arange(N, dtype=np.int64),
            "price": rng.integers(0, 100, N).astype(np.int32),
            "emb": rng.standard_normal((N, D), dtype=np.float32)}
    ties = {"id": np.arange(N, dtype=np.int64),
            "price": data["price"],
            # each vector four times: ties resolve by row id
            "emb": np.repeat(base, 4, axis=0)}
    same = {"id": np.arange(N, dtype=np.int64),
            "price": data["price"],
            "emb": np.tile(base[:1], (N, 1))}
    out = []
    for conn in (myscaledb_tpu.connect,
                 lambda: myscaledb_tpu_torch.connect(device="cpu")):
        s = conn()
        s.create_table("t", data)
        s.create_table("ties", ties)
        s.create_table("same", same)
        out.append(s)
    return out[0], out[1], rng, base


@pytest.fixture
def spy(monkeypatch):
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
    return calls


def _check(j, p, sql, nq, k=10):
    jr, pr = j.sql(sql).to_rows(), p.sql(sql).to_rows()
    assert len(pr) == len(jr) == nq * k
    assert [r[:2] for r in pr] == [r[:2] for r in jr]      # id, query index
    np.testing.assert_allclose([r[2] for r in pr], [r[2] for r in jr],
                               rtol=2e-5, atol=2e-5)
    return pr


def _set_metric(j, p, table, metric):
    from myscaledb_tpu.config import TableSettings as JTS
    from myscaledb_tpu_torch.config import TableSettings as PTS
    j.table_settings[table] = JTS(float_vector_search_metric_type=metric)
    p.table_settings[table] = PTS(float_vector_search_metric_type=metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nq", [10, 32])
def test_batch_distance_matches_jax(sessions, spy, metric, nq):
    j, p, rng, _ = sessions
    _set_metric(j, p, "t", metric)
    queries = rng.standard_normal((nq, D), dtype=np.float32)
    rows = _check(j, p, _stmt(metric, queries), nq)
    # LIMIT 10 BY dist.1: ten rows per query, queries in order, each
    # query's rows best first
    assert [r[1] for r in rows] == [qi for qi in range(nq)
                                    for _ in range(10)]
    # K1 ran once; K2 ran exactly when K1's certificate (one verdict for
    # all nq queries) failed, as the scan's own certificate says
    ran = dict(spy)
    assert ran["sq8"] == 1
    assert ran["f32"] == (0 if _certified(p, "t", queries, metric) else 1)
    assert K1.segmin_sq8.launches == 0 and K2.segmin_f32.launches == 0


def _certified(p, table, queries, metric, k=10) -> bool:
    from myscaledb_tpu_torch.ops import vector as PV
    from myscaledb_tpu_torch.sql.executor import _vector_sidecar
    t = p.tables[table]
    _sqn, (x8, sides) = _vector_sidecar(p, table, t, "emb")
    _d, _i, ok = PV._distance_scan_sq8(
        t["emb"].data, x8, sides, torch.from_numpy(queries),
        t["price"].data < 50, metric, k, True, 16)
    return bool(ok)


def test_ties_resolve_by_row_id(sessions, spy):
    j, p, rng, base = sessions
    _set_metric(j, p, "ties", "L2")
    # queries at stored vectors: each query's best rows are four copies
    queries = base[rng.integers(0, N // 4, 10)]
    rows = _check(j, p, _stmt("L2", queries, "ties", where=""), 10)
    for qi in range(10):
        ids = [r[0] for r in rows if r[1] == qi]
        d = [r[2] for r in rows if r[1] == qi]
        for a in range(9):
            if d[a] == d[a + 1]:
                assert ids[a] < ids[a + 1]


@pytest.mark.parametrize("nq", [10, 32])
def test_identical_rows_fail_the_certificate(sessions, spy, nq):
    """Every row the same vector: K1's bounds cannot separate segments, so
    the scan falls back to K2 in the same statement; ties give ids 0..9
    among the rows WHERE keeps."""
    j, p, rng, _ = sessions
    _set_metric(j, p, "same", "L2")
    queries = rng.standard_normal((nq, D), dtype=np.float32)
    rows = _check(j, p, _stmt("L2", queries, "same"), nq)
    keep = np.flatnonzero(p.tables["same"]["price"].data.numpy() < 50)[:10]
    for qi in range(nq):
        assert [r[0] for r in rows if r[1] == qi] == keep.tolist()
    assert spy == {"sq8": 1, "f32": 1}


def test_batch_distance_needs_limit_by(sessions):
    j, p, rng, _ = sessions
    q = rng.standard_normal((2, D), dtype=np.float32)
    sql = _stmt("L2", q).split(" LIMIT")[0] + " LIMIT 10"
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sql", [
    # one key over the whole table (65,536 rows, 100 groups)
    "SELECT id, price FROM t ORDER BY price, id LIMIT 3 BY price",
    # two keys, then OFFSET/LIMIT after LIMIT BY
    "SELECT id, price FROM t WHERE price < 20 "
    "ORDER BY id DESC LIMIT 2 BY price, id % 2 LIMIT 50 OFFSET 1",
    # float keys: -0.0 equals 0.0, every NaN is its own group
    "SELECT id, f FROM fk ORDER BY id LIMIT 1 BY f",
    # string keys through their dictionary codes
    "SELECT id, s FROM fk ORDER BY id DESC LIMIT 2 BY s",
])
def test_limit_by_over_a_table_equals_the_jax_package(sessions, sql):
    j, p, _rng, _base = sessions
    fk = {"id": np.arange(12, dtype=np.int64),
          "f": np.array([0.0, -0.0, np.nan, 1.5, np.nan, 1.5, 0.0, -0.0,
                         2.5, np.nan, 1.5, 2.5]),
          "s": np.array(["a", "b", "a", "c", "b", "a", "c", "c", "a", "b",
                         "a", "d"], dtype=object)}
    for s in (j, p):
        if "fk" not in s.tables:
            s.create_table("fk", fk)
    jr, pr = j.sql(sql).to_rows(), p.sql(sql).to_rows()
    assert len(pr) > 0
    assert repr(pr) == repr(jr)
