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
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((n, d)).astype(np.float32),
        q=rng.standard_normal((nq, d)).astype(np.float32),
        fact=rng.integers(0, 2 * n_dim, n).astype(np.int32),
        dim=rng.integers(0, 2 * n_dim, n_dim).astype(np.int32),
        gid=rng.integers(0, G, n).astype(np.int32),
        vals=rng.integers(-100, 100, n).astype(np.int32),
        mask=rng.random(n) < 0.9)


def _port(inp, nsh, k, G):
    t = {a: torch.as_tensor(v) for a, v in inp.items()}
    return fused_topk_join_agg(make_mesh(nsh, device="cpu"), t["x"], t["q"],
                               "L2", k, t["fact"], t["dim"], t["gid"],
                               t["mask"], t["vals"], ("sum",), G)


def test_fused_pipeline_matches_jax_and_separate_ops():
    nsh, n, d, nq, k, G, n_dim = 8, 4096, 32, 3, 5, 16, 1024
    inp = _inputs(0, n, d, nq, G, n_dim)
    jm = j_mesh(nsh)
    jd, ji, jcnt, jstates, jgc = j_fused(
        jm, *(j_shard(jm, jnp.asarray(inp[a])) if a != "q"
              else jnp.asarray(inp[a])
              for a in ("x", "q")), "L2", k,
        *(j_shard(jm, jnp.asarray(inp[a]))
          for a in ("fact", "dim", "gid", "mask", "vals")), ("sum",), G)
    pd, pi, pcnt, pstates, pgc = _port(inp, nsh, k, G)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL)
    assert int(pcnt) == int(np.asarray(jcnt))
    np.testing.assert_array_equal(pstates[0].numpy(),
                                  np.asarray(jstates[0]))
    np.testing.assert_array_equal(pgc.numpy(), np.asarray(jgc))
    # the port's separate operators give the same
    mesh = make_mesh(nsh, device="cpu")
    t = {a: torch.as_tensor(v) for a, v in inp.items()}
    d2, i2 = sharded_distance_topk(mesh, t["x"], t["q"], "L2", k)
    c2 = sharded_shuffle_join_count(mesh, t["fact"], t["dim"])
    s2, gc2 = sharded_group_aggregate(mesh, t["gid"], t["mask"],
                                      (t["vals"],), ("sum",), G)
    assert torch.equal(pi, i2) and torch.equal(pd, d2)
    assert int(pcnt) == int(c2)
    assert torch.equal(pstates[0], s2[0]) and torch.equal(pgc, gc2)
    # ground truth: the ALL join's multiplicity, group sums by bincount
    dcount = Counter(inp["dim"].tolist())
    assert int(pcnt) == sum(dcount[p] for p in inp["fact"].tolist())
    m = inp["mask"]
    np.testing.assert_array_equal(
        pstates[0].numpy(),
        np.bincount(inp["gid"][m], weights=inp["vals"][m], minlength=G)
        .astype(np.int64))


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
