"""The port's shuffle (parallel/shuffle.py) against the JAX package's on the
8-device virtual CPU mesh, after tests/test_shuffle.py: the same numpy
inputs through both packages.

Everything here is exact: the received rows and their order per shard
(which decide ANY joins and the pairs' order), the joins' row pairs, the
join counts (also after an overflow of the optimistic buckets and their
retry), the shuffled aggregates.  Each JAX function is compiled once per
call (a shard_map in a fresh closure: 8-40 s on the CPU), so the JAX side
runs for the two whose row order is the JAX package's own (the shuffle,
the ANY join); the rest hold the port to exact numpy oracles that the
JAX package's results equal (tests/test_shuffle.py holds them to the
same: its ALL pairs are sorted, its counts and group states exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh, \
    shard_rows as j_shard
from myscaledb_tpu.parallel import shuffle as jsh

from myscaledb_tpu_torch.ops.hash import hash32
from myscaledb_tpu_torch.parallel import shuffle as psh
from myscaledb_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(jm, a):
    return j_shard(jm, jnp.asarray(a))


def _shuffle_case(nsh, key_dtype, masked):
    rng = np.random.default_rng(nsh)
    n = nsh * 256
    key = rng.integers(0, 1000, n).astype(key_dtype)
    val = (rng.permutation(n) * 7 + 3).astype(np.int64)     # distinct
    valid = rng.random(n) < 0.5 if masked else np.ones(n, bool)
    return key, val, valid


@pytest.mark.parametrize("nsh,key_dtype,masked,against_jax", [
    (8, np.int64, True, True), (4, np.int32, False, False),
    (1, np.int32, True, False),
])
def test_shuffle_by_key_rows_and_order(nsh, key_dtype, masked,
                                       against_jax):
    key, val, valid = _shuffle_case(nsh, key_dtype, masked)
    pk, (pv,), pok = psh.shuffle_by_key(
        make_mesh(nsh, device="cpu"), _t(key), (_t(val),), valid=_t(valid))
    ok = pok.numpy()
    if against_jax:
        jm = j_mesh(nsh)
        jk, (jv,), jok = jsh.shuffle_by_key(
            jm, _j(jm, key), (_j(jm, val),), valid=_j(jm, valid))
        np.testing.assert_array_equal(ok, np.asarray(jok))
        np.testing.assert_array_equal(pk.numpy()[ok], np.asarray(jk)[ok])
        np.testing.assert_array_equal(pv.numpy()[ok], np.asarray(jv)[ok])
    # no row lost, payloads still with their keys
    assert sorted(zip(pk.numpy()[ok].tolist(), pv.numpy()[ok].tolist())) \
        == sorted(zip(key[valid].tolist(), val[valid].tolist()))
    # colocation: every key on shard hash(key) % nsh; each shard's rows
    # from source shard 0 first, each source's rows in row order
    per = len(ok) // nsh
    shard = np.flatnonzero(ok) // per
    h = hash32(pk[torch.as_tensor(ok)]) % nsh
    np.testing.assert_array_equal(shard, h.numpy())
    src_row = {v: i for i, v in enumerate(val.tolist())}
    for p in range(nsh):
        rows = [src_row[v] for v, o in zip(pv.numpy()[p * per:(p + 1) * per],
                                           ok[p * per:(p + 1) * per]) if o]
        assert rows == sorted(rows)


def test_shuffle_aggregate_matches_oracle():
    """Keys in the JAX package's order: each shard's keys ascending (its
    sorted runs), shard by shard; sums, averages and counts exact."""
    rng = np.random.default_rng(2)
    nsh, n = 8, 8 * 500
    key = rng.integers(0, 200, n).astype(np.int32)
    val = rng.integers(-100, 100, n).astype(np.int64)
    mask = rng.random(n) < 0.9
    pk, (ps, pa), pc = psh.sharded_shuffle_aggregate(
        make_mesh(nsh, device="cpu"), _t(key), _t(mask),
        (_t(val), _t(val)), ("sum", "avg"))
    kept = np.unique(key[mask])
    shard = (hash32(_t(kept)) % nsh).numpy()
    want = np.concatenate([kept[shard == p] for p in range(nsh)])
    np.testing.assert_array_equal(pk, want)
    for i, kk in enumerate(want):
        sel = (key == kk) & mask
        assert (ps[i], pc[i]) == (val[sel].sum(), sel.sum())
        assert pa[i] == val[sel].sum() / sel.sum()


def _join_case(nsh):
    rng = np.random.default_rng(3)
    nl, nr = nsh * 200, nsh * 50
    lk = rng.integers(0, 120, nl).astype(np.int64)
    rk = rng.integers(0, 120, nr).astype(np.int64)
    return lk, rk, rng.random(nl) < 0.9, rng.random(nr) < 0.9


def test_shuffle_join_any_matches_jax():
    """ANY pairs in the shards' received order, the lowest valid right row
    of each matched left row."""
    nsh = 8
    lk, rk, lv, rv = _join_case(nsh)
    jm = j_mesh(nsh)
    jl, jr = jsh.sharded_shuffle_join_pairs(
        jm, _j(jm, lk), _j(jm, rk), how="ANY", left_valid=_j(jm, lv),
        right_valid=_j(jm, rv))
    pl, pr = psh.sharded_shuffle_join_pairs(
        make_mesh(nsh, device="cpu"), _t(lk), _t(rk), how="ANY",
        left_valid=_t(lv), right_valid=_t(rv))
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pr, jr)


@pytest.mark.parametrize("how,nsh", [("ALL", 8), ("ALL", 1), ("ANY", 4),
                                     ("ANY", 1)])
def test_shuffle_join_pairs_match_oracle(how, nsh):
    lk, rk, lv, rv = _join_case(nsh)
    pl, pr = psh.sharded_shuffle_join_pairs(
        make_mesh(nsh, device="cpu"), _t(lk), _t(rk), how=how,
        left_valid=_t(lv), right_valid=_t(rv))
    match = (lk[:, None] == rk[None, :]) & lv[:, None] & rv[None, :]
    if how == "ALL":
        # the JAX package's order: by left row, then right row
        want = [tuple(p) for p in np.argwhere(match).tolist()]
        assert list(zip(pl.tolist(), pr.tolist())) == want
    else:
        got = dict(zip(pl.tolist(), pr.tolist()))
        assert len(got) == len(pl)
        want = {i: int(np.argmax(match[i])) for i in range(len(lk))
                if match[i].any()}
        assert got == want


@pytest.mark.parametrize("skewed", [False, True])
def test_shuffle_join_count_and_overflow_retry(skewed, monkeypatch):
    """Optimistic 2x-uniform buckets; with every left key equal one shard's
    bucket overflows, the dropped count says so and the retry at the worst
    case gives the exact count (tests/test_shuffle.py holds the JAX
    package's to the same count)."""
    rng = np.random.default_rng(4)
    nsh, n_l, n_r = 8, 4096, 2048
    lk = rng.integers(0, 500, n_l).astype(np.int32)
    if skewed:
        lk[:] = 7
    rk = rng.integers(0, 500, n_r).astype(np.int32)
    expect = int(np.bincount(rk, minlength=500)[lk].sum())
    caps = []
    real = psh.exchange_pair

    def spy(mesh, lks, lvs, rks, rvs, cap_l, cap_r):
        out = real(mesh, lks, lvs, rks, rvs, cap_l, cap_r)
        caps.append((cap_l, int(out[-1])))
        return out
    monkeypatch.setattr(psh, "exchange_pair", spy)
    pc = psh.sharded_shuffle_join_count(make_mesh(nsh, device="cpu"),
                                        _t(lk), _t(rk))
    assert int(pc) == expect
    if skewed:
        assert caps[0][1] > 0 and caps[1] == (n_l // nsh, 0)
    else:
        assert len(caps) == 1 and caps[0][1] == 0


def test_force_exchange_on_one_shard():
    rng = np.random.default_rng(6)
    lk = _t(rng.integers(0, 50, 300).astype(np.int32))
    rk = _t(rng.integers(0, 50, 100).astype(np.int32))
    m1 = make_mesh(1, device="cpu")
    a = psh.sharded_shuffle_join_count(m1, lk, rk)
    b = psh.sharded_shuffle_join_count(m1, lk, rk, force_exchange=True)
    assert int(a) == int(b) == int((lk[:, None] == rk[None, :]).sum())


def _group_oracle(gid, mask, a, valid, fn, G):
    out = {}
    for g in range(G):
        sel = (gid == g) & mask & valid
        if not ((gid == g) & mask).any():
            continue
        v = a[sel]
        out[g] = {"sum": v.sum(), "count": sel.sum(),
                  "min": v.min() if len(v) else None,
                  "max": v.max() if len(v) else None,
                  "any": v[0] if len(v) else None}[fn]
    return out


@pytest.mark.parametrize("with_valids", [False, True])
def test_shuffle_group_states(with_valids):
    """Dense states against per-group numpy oracles (the JAX package's
    states are the same exact values: tests/test_shuffle.py)."""
    rng = np.random.default_rng(8)
    nsh, n, G = 8, 8 * 300, 150
    gid = rng.integers(0, G, n).astype(np.int32)
    vals = rng.integers(-100, 100, n).astype(np.int64)
    fvals = rng.integers(-100, 100, n).astype(np.float32)
    mask = rng.random(n) < 0.9
    fns = ("sum", "count", "min", "max", "avg", "any")
    args = (vals, vals, vals, fvals, vals, vals)
    valids = [rng.random(n) < 0.8 for _ in fns] if with_valids else None
    ps, pgc = psh.sharded_shuffle_group_states(
        make_mesh(nsh, device="cpu"), _t(gid), _t(mask),
        tuple(_t(a) for a in args), fns, G,
        None if valids is None else tuple(_t(v) for v in valids))
    np.testing.assert_array_equal(pgc.numpy(),
                                  np.bincount(gid[mask], minlength=G))
    for i, (fn, a) in enumerate(zip(fns, args)):
        valid = valids[i] if valids is not None else np.ones(n, bool)
        if fn == "avg":
            want = _group_oracle(gid, mask, a, valid, "sum", G)
            got = ps[i][0].numpy()
        else:
            want = _group_oracle(gid, mask, a, valid, fn, G)
            got = ps[i].numpy()
        for g, w in want.items():
            if w is not None:
                assert got[g] == w, (fn, g)
