"""Distributed operators of the port (parallel/mesh.py, parallel/ops.py)
against the JAX package's on the 8-device virtual CPU mesh, after
tests/test_parallel.py: the same numpy inputs through
``myscaledb_tpu.parallel`` and ``myscaledb_tpu_torch.parallel`` (logical
shards on the CPU).

Tolerances: ids, counts, integer sums, min/max/any and top-n ids equal;
distances and float sums within rtol 2e-5 (the shard scans compute
distances in another order than XLA's; float sums merge in shard order,
XLA's psum in its own)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh, \
    shard_rows as j_shard
from myscaledb_tpu.parallel import ops as jops
from myscaledb_tpu.ops.sort import SortKey as JSortKey

from myscaledb_tpu_torch.ops.sort import SortKey
from myscaledb_tpu_torch.ops.vector import distance_scan
from myscaledb_tpu_torch.parallel import mesh as pmesh
from myscaledb_tpu_torch.parallel import ops as pops

torch.set_num_threads(1)
RTOL = 2e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("nsh,metric,masked", [
    (8, "L2", False), (4, "IP", True), (8, "Cosine", True), (1, "L2", True),
])
def test_distance_topk_matches_jax(nsh, metric, masked):
    rng = np.random.default_rng(nsh)
    n, d, nq, k = nsh * 512, 32, 3, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    mask = rng.random(n) < 0.4 if masked else None
    jm = j_mesh(nsh)
    jd, ji = jops.sharded_distance_topk(
        jm, j_shard(jm, jnp.asarray(x)), jnp.asarray(q), metric, k,
        mask=None if mask is None else j_shard(jm, jnp.asarray(mask)),
        block_rows=256)
    pm = pmesh.make_mesh(nsh, device="cpu")
    pd, pi = pops.sharded_distance_topk(
        pm, pmesh.shard_rows(pm, _t(x)), _t(q), metric, k,
        mask=None if mask is None else _t(mask), block_rows=256)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL)
    # and the port's own one-device scan
    ld, li = distance_scan(_t(x), _t(q), metric=metric, k=k,
                           mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(pi.numpy(), li.numpy())


def test_k_past_the_shards_rows_pads_invalid():
    """k larger than a shard's rows and a mask keeping fewer than k rows:
    the JAX package's INVALID_ID padding and infinite distances."""
    rng = np.random.default_rng(3)
    nsh, n, d, k = 8, 8 * 4, 8, 12
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((2, d)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[[1, 9, 30]] = True
    jm = j_mesh(nsh)
    jd, ji = jops.sharded_distance_topk(
        jm, j_shard(jm, jnp.asarray(x)), jnp.asarray(q), "L2", k,
        mask=j_shard(jm, jnp.asarray(mask)))
    pm = pmesh.make_mesh(nsh, device="cpu")
    pd, pi = pops.sharded_distance_topk(pm, _t(x), _t(q), "L2", k,
                                        mask=_t(mask))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL)


def test_butterfly_merge_forced_and_chosen():
    """nsh * nq * k = 2^18 on 8 shards: the JAX package takes the ppermute
    butterfly, and so does the port's merge; the port's butterfly forced
    (``_butterfly_topk``) and its all_gather cut (``_merge_minscore_topk``
    over the gathered candidates) over the same shard top-ks give the same
    ids as the JAX package."""
    rng = np.random.default_rng(5)
    nsh, n_loc, d, nq, k = 8, 1100, 8, 32, 1024
    assert pops.use_butterfly(nsh, nq, k)
    x = rng.standard_normal((nsh * n_loc, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    jm = j_mesh(nsh)
    jd, ji = jops.sharded_distance_topk(jm, j_shard(jm, jnp.asarray(x)),
                                        jnp.asarray(q), "L2", k)
    pm = pmesh.make_mesh(nsh, device="cpu")
    pd, pi = pops.sharded_distance_topk(pm, _t(x), _t(q), "L2", k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL)
    xs = pmesh.row_slices(pm, _t(x))
    tops = [pops._shard_distance_topk(xs[p], _t(q), None, "L2", k, 32768, p,
                                      n_loc) for p in range(nsh)]
    ss, ids = [s for s, _ in tops], [i for _, i in tops]
    _, bi = pops._butterfly_topk(ss, ids, k)
    kk = ss[0].shape[1]
    _, gi = pops._merge_minscore_topk(
        pmesh.all_gather(ss).transpose(0, 1).reshape(nq, nsh * kk),
        pmesh.all_gather(ids).transpose(0, 1).reshape(nq, nsh * kk), k)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("with_valids", [False, True])
def test_group_aggregate_matches_jax(with_valids):
    rng = np.random.default_rng(7)
    nsh, n, G = 8, 8 * 1000, 13
    gid = rng.integers(0, G, n).astype(np.int32)
    vals = rng.integers(-50, 50, n).astype(np.int64)
    ivals = rng.integers(-50, 50, n).astype(np.int32)
    fvals = rng.standard_normal(n).astype(np.float32)
    mask = rng.random(n) < 0.8
    fns = ("sum", "count", "min", "max", "avg", "sum", "any", "avg")
    args = (vals, vals, fvals, fvals, vals, ivals, fvals, fvals)
    valids = [rng.random(n) < 0.7 for _ in fns] if with_valids else None
    jm = j_mesh(nsh)
    js, jgc = jops.sharded_group_aggregate(
        jm, j_shard(jm, jnp.asarray(gid)), j_shard(jm, jnp.asarray(mask)),
        tuple(j_shard(jm, jnp.asarray(a)) for a in args), fns, G,
        arg_valids=None if valids is None else
        tuple(j_shard(jm, jnp.asarray(v)) for v in valids))
    pm = pmesh.make_mesh(nsh, device="cpu")
    ps, pgc = pops.sharded_group_aggregate(
        pm, _t(gid), _t(mask), tuple(_t(a) for a in args), fns, G,
        None if valids is None else tuple(_t(v) for v in valids))
    np.testing.assert_array_equal(pgc.numpy(), np.asarray(jgc))
    present = np.asarray(jgc) > 0
    for fn, a, p_, j_ in zip(fns, args, ps, js):
        pp = [p_] if fn != "avg" else list(p_)
        jj = [j_] if fn != "avg" else list(j_)
        for x, y in zip(pp, jj):
            x, y = x.numpy()[present], np.asarray(y)[present]
            if a.dtype.kind == "f" and fn in ("sum", "avg"):
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-5)
            else:
                np.testing.assert_array_equal(x, y)


def test_group_aggregate_runs_k3_once_per_shard(monkeypatch):
    """Up to 256 groups without per-argument validity every shard's sums
    and counts go through K3's wrapper (its plain version on the CPU)."""
    from myscaledb_tpu_torch.ops.kernels import group_agg
    calls = []
    real = group_agg.group_aggregate

    def spy(gid, *a, **kw):
        calls.append(gid.shape[0])
        return real(gid, *a, **kw)
    monkeypatch.setattr(group_agg, "group_aggregate", spy)
    pm = pmesh.make_mesh(8, device="cpu")
    n = 8 * 64
    pops.sharded_group_aggregate(
        pm, torch.arange(n, dtype=torch.int32) % 256,
        torch.ones(n, dtype=torch.bool),
        (torch.ones(n, dtype=torch.int32),), ("sum",), 256)
    assert calls == [64] * 8


@pytest.mark.parametrize("nsh", [8, 4])
def test_topn_matches_jax(nsh):
    rng = np.random.default_rng(11)
    n, k = nsh * 500, 25
    v = rng.standard_normal(n).astype(np.float32)
    v[rng.integers(0, n, 200)] = 0.5                   # ties
    w = rng.integers(0, 4, n).astype(np.int64)
    valid = rng.random(n) < 0.9
    jm = j_mesh(nsh)
    jids = jops.sharded_topn(jm, [
        JSortKey(j_shard(jm, jnp.asarray(w)), ascending=True,
                 valid=j_shard(jm, jnp.asarray(valid)), nulls_last=True),
        JSortKey(j_shard(jm, jnp.asarray(v)), ascending=False)], k)
    pm = pmesh.make_mesh(nsh, device="cpu")
    pids = pops.sharded_topn(pm, [
        SortKey(_t(w), ascending=True, valid=_t(valid), nulls_last=True),
        SortKey(_t(v), ascending=False)], k)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    jids1 = jops.sharded_topn(jm, [JSortKey(j_shard(jm, jnp.asarray(v)),
                                            ascending=True)], k)
    pids1 = pops.sharded_topn(pm, [SortKey(_t(v), ascending=True)], k)
    np.testing.assert_array_equal(pids1.numpy(), np.asarray(jids1))


def test_collectives():
    xs = [torch.arange(6) + 10 * p for p in range(3)]
    got = pmesh.all_to_all(xs)
    # shard p receives block p (2 rows) of every source, source 0 first
    for p in range(3):
        want = torch.cat([xs[q][2 * p:2 * p + 2] for q in range(3)])
        assert torch.equal(got[p], want)
    perm = [(0, 1), (1, 2)]
    out = pmesh.ppermute(xs, perm)
    assert torch.equal(out[1], xs[0]) and torch.equal(out[2], xs[1])
    assert torch.equal(out[0], torch.zeros_like(xs[0]))
    assert torch.equal(pmesh.psum(xs), xs[0] + xs[1] + xs[2])
    assert torch.equal(pmesh.pmin(xs), xs[0])
    assert torch.equal(pmesh.pmax(xs), xs[2])
    assert pmesh.all_gather(xs).shape == (3, 6)
    assert pmesh.all_gather(xs, tiled=True).shape == (18,)


def test_mesh_shapes_and_multi_device_refusal():
    m = pmesh.make_mesh(8, device="cpu")
    assert m.shape == {"shard": 8} and m.size == 8
    assert pmesh.make_mesh(device="cpu").size == 1
    assert [t.shape[0] for t in pmesh.row_slices(m, torch.zeros(24))] \
        == [3] * 8
    with pytest.raises(ValueError):
        pmesh.shard_rows(m, torch.zeros(10))
    # a mesh over distinct devices is taken (the CPU tests have one device
    # with tensors, so only the placement shows here); a card that does
    # not exist is refused
    two = pmesh.Mesh(["cpu", "meta"])
    assert two.n_cards == 2 and two.device(1) == torch.device("meta")
    with pytest.raises(ValueError, match="no device"):
        pmesh.Mesh(["cuda:%d" % max(8, torch.cuda.device_count() if
                                    torch.cuda.is_available() else 0)])
