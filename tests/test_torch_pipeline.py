"""The fused config-5 step (parallel/pipeline.py) of the port against the
JAX package's ``fused_topk_join_agg`` on the 8-device virtual CPU mesh,
after tests/test_pipeline.py, and against the port's separate operators
and numpy oracles on 8 shards and on one.

Tolerances: ids, the join count, integer sums and group counts equal;
distances within rtol 2e-5."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh, \
    shard_rows as j_shard
from myscaledb_tpu.parallel.pipeline import fused_topk_join_agg as j_fused

from myscaledb_tpu_torch.ops.vector import distance_scan
from myscaledb_tpu_torch.parallel.mesh import make_mesh
from myscaledb_tpu_torch.parallel.ops import (sharded_distance_topk,
                                              sharded_group_aggregate)
from myscaledb_tpu_torch.parallel.pipeline import fused_topk_join_agg
from myscaledb_tpu_torch.parallel.shuffle import sharded_shuffle_join_count

torch.set_num_threads(1)
RTOL = 2e-5


def _inputs(seed, n, d, nq, G, n_dim):
    """Seeded inputs: 10% of the rows masked out; the dim keys with
    duplicates and with keys no fact row has (fact keys lie in [0,
    2 n_dim), four dim keys past it)."""
    rng = np.random.default_rng(seed)
    dim = rng.integers(0, 2 * n_dim, n_dim).astype(np.int32)
    dim[:4] = dim[4:8]
    dim[8:12] = 2 * n_dim + np.arange(4)
    return dict(
        x=rng.standard_normal((n, d)).astype(np.float32),
        q=rng.standard_normal((nq, d)).astype(np.float32),
        fact=rng.integers(0, 2 * n_dim, n).astype(np.int32),
        dim=dim,
        gid=rng.integers(0, G, n).astype(np.int32),
        vals=rng.integers(-100, 100, n).astype(np.int32),
        mask=rng.random(n) < 0.9)


def _port(inp, nsh, k, G, metric="L2", fn="sum"):
    t = {a: torch.as_tensor(v) for a, v in inp.items()}
    return fused_topk_join_agg(make_mesh(nsh, device="cpu"), t["x"], t["q"],
                               metric, k, t["fact"], t["dim"], t["gid"],
                               t["mask"], t["vals"], (fn,), G)


def _state_arrays(state) -> list:
    """An aggregate's state as numpy arrays (avg's is (sum, count))."""
    parts = state if isinstance(state, tuple) else (state,)
    return [np.asarray(p) for p in parts]


def _group_oracle(inp, fn, G) -> list:
    m = inp["mask"]
    cnt = np.bincount(inp["gid"][m], minlength=G).astype(np.int64)
    tot = np.bincount(inp["gid"][m], weights=inp["vals"][m],
                      minlength=G).astype(np.int64)
    return {"sum": [tot], "count": [cnt], "avg": [tot, cnt]}[fn]


# every metric and aggregate on 8 shards, and on 1
CASES = [(8, "L2", "sum"), (8, "Cosine", "count"), (8, "IP", "avg"),
         (1, "IP", "sum"), (1, "Cosine", "avg")]


@pytest.mark.parametrize("nsh,metric,fn", CASES)
def test_fused_pipeline_matches_jax_and_separate_ops(nsh, metric, fn):
    n, d, nq, k, G, n_dim = 4096, 32, 3, 5, 16, 1024
    inp = _inputs(0, n, d, nq, G, n_dim)
    dcount = Counter(inp["dim"].tolist())
    assert max(dcount.values()) > 1
    assert set(dcount) - set(inp["fact"].tolist())
    assert not inp["mask"].all()
    jm = j_mesh(nsh)
    jd, ji, jcnt, jstates, jgc = j_fused(
        jm, *(j_shard(jm, jnp.asarray(inp[a])) if a != "q"
              else jnp.asarray(inp[a])
              for a in ("x", "q")), metric, k,
        *(j_shard(jm, jnp.asarray(inp[a]))
          for a in ("fact", "dim", "gid", "mask", "vals")), (fn,), G)
    pd, pi, pcnt, pstates, pgc = _port(inp, nsh, k, G, metric, fn)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL)
    assert int(pcnt) == int(np.asarray(jcnt))
    for got, want in zip(_state_arrays(pstates[0]),
                         _state_arrays(jstates[0]), strict=True):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pgc.numpy(), np.asarray(jgc))
    # the port's separate operators give the same
    mesh = make_mesh(nsh, device="cpu")
    t = {a: torch.as_tensor(v) for a, v in inp.items()}
    d2, i2 = sharded_distance_topk(mesh, t["x"], t["q"], metric, k)
    c2 = sharded_shuffle_join_count(mesh, t["fact"], t["dim"])
    s2, gc2 = sharded_group_aggregate(mesh, t["gid"], t["mask"],
                                      (t["vals"],), (fn,), G)
    assert torch.equal(pi, i2) and torch.equal(pd, d2)
    assert int(pcnt) == int(c2)
    for got, want in zip(_state_arrays(pstates[0]), _state_arrays(s2[0]),
                         strict=True):
        np.testing.assert_array_equal(got, want)
    assert torch.equal(pgc, gc2)
    # ground truth: the ALL join's multiplicity, group states by bincount
    assert int(pcnt) == sum(dcount[p] for p in inp["fact"].tolist())
    for got, want in zip(_state_arrays(pstates[0]),
                         _group_oracle(inp, fn, G), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nsh", [1, 8])
def test_fused_pipeline_on_a_cpu_mesh_makes_no_cuda_call(nsh, monkeypatch):
    """A CPU mesh has no streams: the step makes no stream or event and
    gives the same results with every such CUDA entry point raising."""
    inp = _inputs(5, 1024, 16, 2, 8, 256)
    want = _port(inp, nsh, 4, 8, "L2", "avg")

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU mesh made a CUDA call")
    for name in ("Stream", "Event", "stream", "current_stream",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    got = _port(inp, nsh, 4, 8, "L2", "avg")
    for a, b in zip(got[:3] + got[4:], want[:3] + want[4:]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[3][0], want[3][0]))


@pytest.mark.parametrize("nsh", [1, 4])
def test_fused_pipeline_against_oracles(nsh):
    n, d, nq, k, G, n_dim = 512, 16, 2, 4, 8, 128
    inp = _inputs(nsh, n, d, nq, G, n_dim)
    pd, pi, pcnt, pstates, pgc = _port(inp, nsh, k, G)
    ld, li = distance_scan(torch.as_tensor(inp["x"]),
                           torch.as_tensor(inp["q"]), "L2", k)
    assert torch.equal(pi, li)
    np.testing.assert_allclose(pd.numpy(), ld.numpy(), rtol=RTOL)
    dcount = Counter(inp["dim"].tolist())
    assert int(pcnt) == sum(dcount[p] for p in inp["fact"].tolist())
    assert int(pgc.sum()) == int(inp["mask"].sum())


def test_dryrun_multichip_on_eight_cpu_shards():
    from myscaledb_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(8, device="cpu")
    assert out["shards"] == 8 and out["sql_rows"] == (5, 8)
    assert out["sql_join_rows"][0] == out["sql_join_rows"][1] > 0
