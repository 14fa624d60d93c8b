"""Grouping and aggregation ops on the CPU, the port against the JAX
package on the same numpy inputs: ops/hash.py, the grouping half of
ops/hashtable.py, ops/aggregate.py and ops/aggregate_matmul.py.  Integers,
group ids, representatives and counts must be equal; f32 sums agree within
the JAX group-aggregate test's tolerance against f64 (rtol 1e-4, atol
1e-3)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from myscaledb_tpu.ops import hash as JH
from myscaledb_tpu.ops import hashtable as JT
from myscaledb_tpu.ops import aggregate as JA
from myscaledb_tpu.ops.aggregate_matmul import \
    matmul_group_aggregate as j_matmul
from myscaledb_tpu_torch.ops import hash as PH
from myscaledb_tpu_torch.ops import hashtable as PT
from myscaledb_tpu_torch.ops import aggregate as PA
from myscaledb_tpu_torch.ops import aggregate_matmul as PM
from myscaledb_tpu_torch.ops.kernels import group_agg as K3

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(e) for e in x)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_states(got, want, fns, kinds=None):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        if isinstance(g, tuple):
            _assert_states(g, w, ("sum", "count"),
                           (None if kinds is None else kinds[i], "count"))
            continue
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
        else:
            np.testing.assert_array_equal(g, w)


def test_hashes_match(rng):
    x32 = rng.integers(-2**31, 2**31 - 1, 500).astype(np.int32)
    x64 = rng.integers(-2**62, 2**62, 500).astype(np.int64)
    np.testing.assert_array_equal(PH.hash32(_t(x32)).numpy(),
                                  np.asarray(JH.hash32(x32)))
    np.testing.assert_array_equal(PH.hash64(_t(x64)).numpy(),
                                  np.asarray(JH.hash64(x64)))
    np.testing.assert_array_equal(
        PH.hash_columns([_t(x32), _t(x64)]).numpy(),
        np.asarray(JH.hash_columns([jnp.asarray(x32), jnp.asarray(x64)])))
    np.testing.assert_array_equal(PH.np_hash32(x32), JH.np_hash32(x32))
    f = np.array([0.0, -0.0, 1.5, np.nan, -np.inf, 3e38], dtype=np.float32)
    np.testing.assert_array_equal(PH.float_bits_key(_t(f)).numpy(),
                                  np.asarray(JH.float_bits_key(f)))


def _keysets(rng, n):
    fk = np.array([0.0, -0.0, 1.5, np.nan, -7.25], dtype=np.float32)
    f = fk[rng.integers(0, len(fk), n)]
    return {
        "int": (rng.integers(0, 9, n).astype(np.int32),),
        "multi": (rng.integers(0, 4, n).astype(np.int32),
                  rng.integers(-3, 3, n).astype(np.int64),
                  rng.random(n) < 0.5),
        "float_bits": (np.asarray(JH.float_bits_key(f)),
                       rng.integers(0, 2, n).astype(np.int8)),
        "wide": (rng.choice(rng.integers(-10**15, 10**15, 7), n),),
    }


@pytest.mark.parametrize("which", ["int", "multi", "float_bits", "wide"])
@pytest.mark.parametrize("masked", [False, True])
def test_build_group_ids_matches(rng, which, masked):
    n = 3000
    keys = _keysets(rng, n)[which]
    mask = rng.random(n) < 0.6 if masked else None
    jt, jgid, jcap = JT.build_group_ids(tuple(jnp.asarray(k) for k in keys),
                                        mask=_j(mask))
    pt, pgid, pcap = PT.build_group_ids(tuple(_t(k) for k in keys),
                                        mask=_t(mask))
    assert pcap == jcap
    assert pgid.dtype == torch.int32
    np.testing.assert_array_equal(pgid.numpy(), np.asarray(jgid))
    np.testing.assert_array_equal(pt.slot_row.numpy(),
                                  np.asarray(jt.slot_row))
    sgid, srep, sng = PT.group_ids_static(tuple(_t(k) for k in keys),
                                          mask=_t(mask))
    jsgid, jsrep, jsng = JT.group_ids_static(
        tuple(jnp.asarray(k) for k in keys), mask=_j(mask))
    np.testing.assert_array_equal(sgid.numpy(), np.asarray(jsgid))
    assert int(sng) == int(jsng)
    for a, b in zip(srep, jsrep):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_build_group_ids_edges():
    t, gid, cap = PT.build_group_ids((torch.zeros(0, dtype=torch.int32),))
    assert cap == 1 and gid.shape == (0,)
    t, gid, cap = PT.build_group_ids(
        (torch.arange(5, dtype=torch.int32),), mask=torch.zeros(5,
                                                               dtype=bool))
    assert cap == 1 and (gid == PT.INT32_MAX).all()
    _t2, _g2, ok = PT.ht_insert((torch.arange(5),), None)
    assert bool(ok) and PT.next_pow2(5) == 8 == JT.next_pow2(5)
    # the count-probe layout of a join build: one key of <= 32 bits only
    t, _, _ = PT.build_group_ids((torch.tensor([3, 1, 2], dtype=torch.int32),),
                                 prepare_count_probe=True)
    assert t.sorted_keys.tolist() == [1, 2, 3] and not bool(t.sorted_has_max)
    t, _, _ = PT.build_group_ids((torch.arange(5),), prepare_count_probe=True)
    assert t.sorted_keys is None


def _inputs(rng, n, G):
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    v = rng.integers(-10**6, 10**6, n).astype(np.int32)
    f = rng.standard_normal(n).astype(np.float32)
    w = rng.integers(-10**12, 10**12, n).astype(np.int64)
    valid = rng.random(n) < 0.8
    return gid, mask, v, f, w, valid


def test_partial_aggregate_matches(rng):
    n, G = 4000, 11
    gid, mask, v, f, w, valid = _inputs(rng, n, G)
    fns = ("sum", "count", "min", "max", "avg", "any", "sum", "min", "max")
    args = (v, v, v, f, v, f, w, w, f)
    valids = (None, valid, None, valid, valid, None, None, valid, None)
    js, jgc = JA.partial_aggregate(jnp.asarray(gid), jnp.asarray(mask),
                                   tuple(_j(a) for a in args), fns, G,
                                   tuple(jnp.asarray(x) if x is not None
                                         else jnp.ones(n, bool)
                                         for x in valids))
    ps, pgc = PA.partial_aggregate(_t(gid), _t(mask),
                                   tuple(_t(a) for a in args), fns, G,
                                   tuple(_t(x) for x in valids))
    np.testing.assert_array_equal(pgc.numpy(), np.asarray(jgc))
    _assert_states(ps, js, fns)
    # merge two halves == the whole; finalize agrees with the JAX finalize
    h = n // 2
    parts = [PA.partial_aggregate(_t(gid[s]), _t(mask[s]),
                                  tuple(_t(a[s]) for a in args), fns, G,
                                  tuple(None if x is None else _t(x[s])
                                        for x in valids))
             for s in (slice(0, h), slice(h, n))]
    ms, mgc = PA.merge_states(parts[0][0], parts[1][0], parts[0][1],
                              parts[1][1], fns)
    jparts = [JA.partial_aggregate(
        jnp.asarray(gid[s]), jnp.asarray(mask[s]),
        tuple(_j(a[s]) for a in args), fns, G,
        tuple(jnp.asarray(x[s]) if x is not None else jnp.ones(len(gid[s]),
                                                                 bool)
              for x in valids)) for s in (slice(0, h), slice(h, n))]
    jm, jmgc = JA.merge_states(jparts[0][0], jparts[1][0], jparts[0][1],
                               jparts[1][1], fns)
    np.testing.assert_array_equal(mgc.numpy(), np.asarray(jmgc))
    _assert_states(ms, jm, fns)
    for a, b in zip(PA.finalize(ms, mgc, fns), JA.finalize(jm, jmgc, fns)):
        if np.issubdtype(np.asarray(b).dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("G,own_valid", [(13, False), (13, True),
                                         (300, False)])
def test_partial_aggregate_matmul_matches(rng, monkeypatch, G, own_valid):
    """Both branches: K3 (G <= 256, no per-argument validity) and the
    matmul histogram (validity, or G > 256); min/max of an int column take
    K3's lanes at G <= 256 (alone where the sums take the matmul), of a
    float column the scatter."""
    n = 5000
    gid, mask, v, f, w, valid = _inputs(rng, n, G)
    fns = ("sum", "count", "avg", "sum", "min", "max", "sum")
    args = (v, None, v, f, f, v, w)
    vld = (valid, None, valid, None, None, None, None) if own_valid else None
    calls = []
    real = K3._accumulate_plain
    monkeypatch.setattr(K3, "_accumulate_plain",
                        lambda *a: calls.append(1) or real(*a))
    ps, pgc = PA.partial_aggregate_matmul(
        _t(gid), _t(mask), tuple(_t(a) for a in args), fns, G,
        None if vld is None else tuple(_t(x) for x in vld))
    js, jgc = JA.partial_aggregate_matmul(
        jnp.asarray(gid), jnp.asarray(mask),
        tuple(_j(a) if a is not None else jnp.zeros(n, jnp.int32)
              for a in args), fns, G,
        None if vld is None else tuple(_j(x) for x in vld))
    assert len(calls) == (1 if G <= 256 else 0)
    np.testing.assert_array_equal(pgc.numpy(), np.asarray(jgc))
    _assert_states(ps, js, fns)


def test_unsigned_sums_route_like_jax(rng, monkeypatch):
    """UInt16 is stored widened to int32: the logical dtype sends its sum to
    the scatter path, as the JAX package does, not to K3."""
    n, G = 3000, 5
    gid, mask = rng.integers(0, G, n).astype(np.int32), rng.random(n) < 0.5
    u16 = rng.integers(0, 2**16, n).astype(np.uint16)
    calls = []
    real = K3._accumulate_plain
    monkeypatch.setattr(K3, "_accumulate_plain",
                        lambda *a: calls.append(1) or real(*a))
    ps, pgc = PA.partial_aggregate_matmul(
        _t(gid), _t(mask), (_t(u16.astype(np.int32)),), ("sum",), G,
        logical_dtypes=(np.dtype(np.uint16),))
    js, _ = JA.partial_aggregate_matmul(jnp.asarray(gid), jnp.asarray(mask),
                                        (jnp.asarray(u16),), ("sum",), G)
    assert calls == []
    np.testing.assert_array_equal(ps[0].numpy(),
                                  np.asarray(js[0]).astype(np.int64))


@pytest.mark.parametrize("G", [5, 300])
def test_matmul_group_aggregate_matches(rng, G):
    n = 4100
    gid, mask, v, f, _w, valid = _inputs(rng, n, G)
    extremes = rng.choice(np.array([-2**31, 2**31 - 1, 0, -1],
                                   dtype=np.int32), n)
    kinds = ("int", "float", "count", "int")
    args = (v, f, None, extremes)
    valids = (valid, None, valid, None)
    ps, pgc, pcnt = PM.matmul_group_aggregate(
        _t(gid), _t(mask), tuple(_t(a) for a in args), kinds, G,
        tuple(_t(x) for x in valids))
    js, jgc, jcnt = j_matmul(
        jnp.asarray(gid), jnp.asarray(mask),
        tuple(_j(a) if a is not None else jnp.zeros(n, jnp.int32)
              for a in args), kinds, G, tuple(_j(x) for x in valids))
    np.testing.assert_array_equal(pgc.numpy(), np.asarray(jgc))
    for a, b in zip(pcnt, jcnt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_states(ps, js, kinds)


def test_streaming_group_aggregate_matches(rng):
    n = 5000
    gid, mask, v, f, w, valid = _inputs(rng, n, 7)
    keys = (gid, rng.integers(0, 3, n).astype(np.int64))
    fns = ("sum", "count", "avg", "min", "max", "any")
    args = (v, None, f, v, w, v)
    valids = (None, None, valid, None, None, None)
    pk, ps, pgc = PA.streaming_group_aggregate(
        keys, mask, args, fns, valids, chunk_rows=900, device="cpu")
    jk, js, jgc = JA.streaming_group_aggregate(
        keys, mask, tuple(a if a is not None else None for a in args), fns,
        valids, chunk_rows=900)
    np.testing.assert_array_equal(pgc, jgc)
    for a, b in zip(pk, jk):
        np.testing.assert_array_equal(a, b)
    _assert_states(ps, js, fns)
    # all rows masked: no groups
    pk, ps, pgc = PA.streaming_group_aggregate(
        keys, np.zeros(n, dtype=bool), args, fns, valids, chunk_rows=900,
        device="cpu")
    assert len(pgc) == 0 and all(len(k) == 0 for k in pk)


def test_streaming_group_aggregate_needs_a_device(rng):
    """Host arrays alone do not pick the device: the caller must name it."""
    keys = (rng.integers(0, 5, 100).astype(np.int64),)
    with pytest.raises(TypeError, match="device"):
        PA.streaming_group_aggregate(keys, None, (None,), ("count",))
