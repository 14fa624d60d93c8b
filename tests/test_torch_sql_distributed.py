"""Distributed SQL of the port against the JAX package, after
tests/test_sql_distributed.py: one data dict (n = 1003 rows, not a
multiple of 8, so the padding is exercised) into both packages' sessions,
the table distributed over 8 shards (the JAX package's virtual CPU
devices, the port's ``make_mesh(8, device="cpu")``), the same SQL through
both, compared as TSV — values and row order.

The statements whose JAX distributed run compiles in seconds are held to
the JAX package's distributed session; the joins and the high-cardinality
GROUP BY (a JAX shuffle compiles for 20-40 s on the CPU) to its
undistributed one, which tests/test_sql_distributed.py holds its
distributed session equal to.  Every statement is also held to the port's
undistributed session, exactly.  Distances agree with the JAX package's
within rtol 2e-5 (ROADMAP section 3), everything else exactly.  Error
texts, EXPLAIN's distributed lines and system.tables are the JAX
distributed session's.

A LEFT SEMI join of a distributed table keeps only the matched rows, as
the undistributed join does; the JAX package's broadcast and shuffle
paths keep the misses too (ROADMAP section 3), so those statements are
held to its undistributed session."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh

from myscaledb_tpu_torch.parallel.mesh import make_mesh
from myscaledb_tpu_torch.runtime import metrics as M

torch.set_num_threads(1)


def _data(n=1003):
    rng = np.random.default_rng(0)
    return {
        "id": np.arange(n, dtype=np.int64),
        "k": rng.integers(0, 5, n).astype(np.int32),
        "v": rng.integers(-100, 100, n).astype(np.int64),
        "s": rng.choice(["x", "y", "z"], n),
        "emb": rng.standard_normal((n, 16)).astype(np.float32),
    }


def _join_data(n=1003, n_dim=37):
    rng = np.random.default_rng(1)
    return ({"id": np.arange(n, dtype=np.int64),
             "k": rng.integers(0, n_dim + 5, n).astype(np.int64),
             "v": rng.integers(-100, 100, n).astype(np.int64),
             "hk": rng.integers(0, 400, n).astype(np.int64)},
            {"k": np.arange(n_dim, dtype=np.int64),
             "label": np.array([f"d{i}" for i in range(n_dim)]),
             "w": rng.integers(0, 10, n_dim).astype(np.int64)})


def _copy(d):
    return {k: v.copy() for k, v in d.items()}


def _floats(field):
    try:
        return [float(x) for x in field.strip("()[]").split(",")]
    except ValueError:
        return None


def _same(got: str, want: str) -> bool:
    """TSV equal, but for numbers that differ within rtol 2e-5."""
    gl, wl = got.split("\n"), want.split("\n")
    if len(gl) != len(wl):
        return False
    for g, w in zip(gl, wl):
        gf, wf = g.split("\t"), w.split("\t")
        if len(gf) != len(wf):
            return False
        for a, b in zip(gf, wf):
            if a == b:
                continue
            fa, fb = _floats(a), _floats(b)
            if fa is None or fb is None or len(fa) != len(fb) or \
                    not np.allclose(fa, fb, rtol=2e-5, atol=0):
                return False
    return True


@pytest.fixture(scope="module")
def sessions():
    """(JAX undistributed, JAX distributed, port undistributed, port
    distributed), each with table t (and dim, t2 for joins: t2 is t's
    join twin, distributed in the distributed sessions)."""
    data = _data()
    jdata, dim = _join_data()
    out = []
    for pkg, mesh in ((myscaledb_tpu, None), (myscaledb_tpu, j_mesh(8)),
                      (myscaledb_tpu_torch, None),
                      (myscaledb_tpu_torch, make_mesh(8, device="cpu"))):
        s = pkg.connect() if pkg is myscaledb_tpu else \
            pkg.connect(device="cpu")
        s.create_table("t", _copy(data))
        s.create_table("t2", _copy(jdata))
        s.create_table("dim", _copy(dim))
        s.create_table("dimd", _copy(dim))
        if mesh is not None:
            s.distribute("t", mesh)
            s.distribute("t2", mesh)
            s.distribute("dimd", mesh)
        out.append(s)
    return out


QUERIES = [
    "SELECT id, v FROM t WHERE v > 50 ORDER BY id LIMIT 20",
    "SELECT k, count(*), sum(v), min(v), max(v), avg(v) FROM t GROUP BY k "
    "ORDER BY k",
    "SELECT s, sum(v) FROM t WHERE k != 2 GROUP BY s ORDER BY s",
    "SELECT count(*) FROM t",
    "SELECT id FROM t ORDER BY v DESC, id LIMIT 7",
    "SELECT k, count(*) AS c FROM t GROUP BY k HAVING c > 150 ORDER BY k",
    "SELECT id, distance(emb, [" + ", ".join(["0.1"] * 16) + "]) AS d "
    "FROM t WHERE v > 0 ORDER BY d LIMIT 12",
    "SELECT id, v FROM t WHERE v > 10 ORDER BY v DESC, id LIMIT 9",
    "SELECT id, v FROM t WHERE v > 98 ORDER BY id LIMIT 500",
    "SELECT s, any(id), anyLast(k) FROM t GROUP BY s ORDER BY s",
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_distributed_matches_jax_distributed(sessions, qi):
    _jl, jd, pl, pd = sessions
    q = QUERIES[qi]
    got = pd.sql_tsv(q)
    assert _same(got, jd.sql_tsv(q)), q
    assert got == pl.sql_tsv(q), q


def test_string_min_max_match_undistributed(sessions):
    """String min/max print strings in the port (ids in the JAX package:
    ROADMAP section 3): held to the port's undistributed session."""
    _jl, _jd, pl, pd = sessions
    q = "SELECT k, min(s), max(s), any(s) FROM t GROUP BY k ORDER BY k"
    assert pd.sql_tsv(q) == pl.sql_tsv(q)


LOCAL_QUERIES = [
    # batch_distance, LIMIT BY
    "SELECT id, batch_distance(emb, [[" + ", ".join(["0.1"] * 16) + "], [" +
    ", ".join(["-0.3"] * 16) + "]]) AS dist FROM t "
    "ORDER BY dist.1, dist.2 LIMIT 5 BY dist.1",
    "SELECT k, uniqExact(v) AS u, argMin(id, v) AS lo, median(v) AS m "
    "FROM t GROUP BY k ORDER BY k",
    "SELECT id, row_number() OVER (PARTITION BY k ORDER BY v, id) AS rn, "
    "sum(v) OVER (PARTITION BY k) AS tot FROM t ORDER BY id LIMIT 40",
    "SELECT k, varPop(v) AS vp, stddevSamp(v) AS ss, corr(v, id) AS c, "
    "count(DISTINCT v) AS cd, sum(DISTINCT v) AS sd, anyLast(id) AS al "
    "FROM t GROUP BY k ORDER BY k",
    # broadcast joins (dim under the threshold)
    "SELECT id, v, label FROM t2 INNER JOIN dim ON t2.k = dim.k "
    "ORDER BY id LIMIT 30",
    "SELECT id, v, label, w FROM t2 LEFT JOIN dim ON t2.k = dim.k "
    "ORDER BY id LIMIT 30",
    "SELECT id FROM t2 ANY INNER JOIN dim ON t2.k = dim.k "
    "ORDER BY id DESC LIMIT 10",
    "SELECT id FROM t2 SEMI LEFT JOIN dim ON t2.k = dim.k "
    "ORDER BY id LIMIT 10",
    "SELECT id FROM t2 ANTI LEFT JOIN dim ON t2.k = dim.k "
    "ORDER BY id LIMIT 10",
    "SELECT label, count(*) AS c, sum(v) FROM t2 INNER JOIN dim USING (k) "
    "GROUP BY label ORDER BY label",
    # a join falling back to the host gather (RIGHT)
    "SELECT id, label FROM t2 RIGHT JOIN dim ON t2.k = dim.k "
    "ORDER BY label, id LIMIT 20",
    # ARRAY JOIN over a distributed table
    "SELECT id, x FROM t ARRAY JOIN [1, 2] AS x WHERE id < 3 ORDER BY id, x",
]


@pytest.mark.parametrize("qi", range(len(LOCAL_QUERIES)))
def test_distributed_matches_jax_undistributed(sessions, qi):
    jl, _jd, pl, pd = sessions
    q = LOCAL_QUERIES[qi]
    got = pd.sql_tsv(q)
    assert _same(got, jl.sql_tsv(q)), q
    assert got == pl.sql_tsv(q), q


SHUFFLE_JOINS = [
    "SELECT id, v, label FROM t2 INNER JOIN dimd ON t2.k = dimd.k "
    "ORDER BY id LIMIT 30",
    "SELECT id, v, label, w FROM t2 LEFT JOIN dimd ON t2.k = dimd.k "
    "ORDER BY id LIMIT 30",
    "SELECT id FROM t2 ANY INNER JOIN dimd ON t2.k = dimd.k "
    "ORDER BY id DESC LIMIT 10",
    "SELECT id FROM t2 SEMI LEFT JOIN dimd ON t2.k = dimd.k "
    "ORDER BY id LIMIT 10",
    "SELECT id FROM t2 ANTI LEFT JOIN dimd ON t2.k = dimd.k "
    "ORDER BY id LIMIT 10",
]


@pytest.mark.parametrize("qi", range(len(SHUFFLE_JOINS)))
def test_distributed_shuffle_join(sessions, qi):
    """Both sides distributed and the broadcast threshold under the build
    side: the shuffle join runs."""
    jl, _jd, pl, pd = sessions
    q = SHUFFLE_JOINS[qi]
    want = jl.sql_tsv(q.replace("dimd", "dim"))
    pd.settings.distributed_broadcast_join_threshold = 4
    try:
        got = pd.sql_tsv(q)
        assert got == want, q
        assert got == pl.sql_tsv(q), q
    finally:
        pd.settings.distributed_broadcast_join_threshold = 1 << 21


def test_join_strategies_run(sessions, monkeypatch):
    from myscaledb_tpu_torch.sql import executor as ex
    _jl, _jd, _pl, pd = sessions
    seen = []
    real = ex._distributed_join

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(getattr(out, "join_strategy", None))
        return out
    monkeypatch.setattr(ex, "_distributed_join", spy)
    pd.sql("SELECT id, label FROM t2 INNER JOIN dim ON t2.k = dim.k "
           "LIMIT 5")
    pd.settings.distributed_broadcast_join_threshold = 4
    try:
        pd.sql("SELECT id, label FROM t2 INNER JOIN dimd "
               "ON t2.k = dimd.k LIMIT 5")
    finally:
        pd.settings.distributed_broadcast_join_threshold = 1 << 21
    assert seen == ["broadcast", "shuffle"]


@pytest.mark.parametrize("q", [
    "SELECT k, count(*), sum(v), min(v), max(v), avg(v) FROM t GROUP BY k "
    "ORDER BY k",
    "SELECT s, id % 7 AS b, count(*) FROM t WHERE v > -50 GROUP BY s, b "
    "ORDER BY s, b",
])
def test_high_cardinality_group_by_shuffles(sessions, q):
    jl, _jd, _pl, pd = sessions
    before = M.events_snapshot().get("DistributedShuffleGroupBy", 0)
    pd.settings.distributed_group_by_shuffle_threshold = 2
    try:
        assert pd.sql_tsv(q) == jl.sql_tsv(q)
    finally:
        pd.settings.distributed_group_by_shuffle_threshold = 1 << 14
    assert M.events_snapshot().get("DistributedShuffleGroupBy", 0) \
        == before + 1


def test_topn_path_used(sessions):
    _jl, _jd, pl, pd = sessions
    before = M.events_snapshot().get("DistributedTopNQueries", 0)
    q = "SELECT id, v FROM t WHERE v > 10 ORDER BY v DESC, id LIMIT 9"
    assert pd.sql_tsv(q) == pl.sql_tsv(q)
    assert M.events_snapshot().get("DistributedTopNQueries", 0) \
        == before + 1


def test_padding_rows_never_leak():
    data = _data(7)                      # 7 rows over 8 shards
    j = myscaledb_tpu.connect()
    j.create_table("t", _copy(data))
    j.distribute("t", j_mesh(8))
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.create_table("t", _copy(data))
    p.distribute("t", make_mesh(8, device="cpu"))
    for q in ("SELECT id FROM t ORDER BY id", "SELECT * FROM t",
              "SELECT count(*), sum(v) FROM t"):
        assert p.sql_tsv(q) == j.sql_tsv(q), q
    assert len(p.sql("SELECT id FROM t").to_rows()) == 7
    assert p.tables["t"].n_rows == 8 and p.tables["t"].real_rows == 7


def _error(s, q):
    with pytest.raises(Exception) as e:
        s.sql(q)
    return str(e.value)


def test_error_texts_explain_and_system_tables(sessions):
    _jl, jd, _pl, pd = sessions
    q = "SELECT count(*) FROM t SAMPLE 0.5"
    assert _error(pd, q) == _error(jd, q) == \
        "SAMPLE over distributed tables not supported"
    for q in ("EXPLAIN SELECT id FROM t ORDER BY v DESC LIMIT 3",
              "EXPLAIN SELECT id FROM t2 INNER JOIN dim ON t2.k = dim.k",
              "EXPLAIN SELECT k, count(*) FROM t GROUP BY k",
              "EXPLAIN SELECT id, distance(emb, [" +
              ", ".join(["0.1"] * 16) + "]) AS d FROM t ORDER BY d LIMIT 3"):
        assert pd.sql_tsv(q) == jd.sql_tsv(q), q
    q = "EXPLAIN PIPELINE SELECT id FROM t ORDER BY v DESC LIMIT 3"
    lines = pd.sql_tsv(q).splitlines()
    want = [ln.split("  [")[0] for ln in jd.sql_tsv(q).splitlines()]
    assert [ln.split("  [")[0] for ln in lines] == want
    assert any("[distributed over 8 shards]" in ln for ln in lines)
    assert any("strategy=sharded per-shard top-n + merge" in ln
               for ln in lines)
    q = ("SELECT name, total_rows, total_columns, is_distributed "
         "FROM system.tables ORDER BY name")
    assert pd.sql_tsv(q) == jd.sql_tsv(q)
