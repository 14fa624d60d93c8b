"""K3 on the CPU: the port's ``group_aggregate`` (its plain version, since
the tensors lie on the CPU) against the JAX package's
``pallas_group_aggregate`` in interpret mode, on the same numpy inputs.
The cases mirror tests/test_group_agg_pallas.py.  Counts and int sums must
be equal; f32 sums agree within that test's tolerance against f64 (rtol
1e-4, atol 1e-3).  The min/max kinds, which the JAX kernel lacks, are held
against the scatter reductions (the port's and the JAX package's
``partial_aggregate``): equal, empty groups included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import myscaledb_tpu_torch as P
from myscaledb_tpu.ops import aggregate as JA
from myscaledb_tpu.ops.pallas.group_agg import pallas_group_aggregate
from myscaledb_tpu_torch.ops import aggregate as PA
from myscaledb_tpu_torch.ops.kernels.group_agg import (
    group_aggregate, group_aggregate_plain, grid, _dedupe, MAX_G)

torch.set_num_threads(1)


def _both(gid, mask, args, kinds, G, arg_ranges=None):
    want = pallas_group_aggregate(
        jnp.asarray(gid), jnp.asarray(mask),
        tuple(jnp.asarray(a) if a is not None else None for a in args),
        kinds, G, interpret=True, arg_ranges=arg_ranges)
    targs = tuple(torch.from_numpy(a) if a is not None else None
                  for a in args)
    got = group_aggregate(torch.from_numpy(gid), torch.from_numpy(mask),
                          targs, kinds, G, arg_ranges=arg_ranges)
    return got, want


def _assert_match(got, want, kinds):
    states, gc, arg_counts = got
    np.testing.assert_array_equal(gc.numpy(), np.asarray(want[1]))
    for c in arg_counts:
        np.testing.assert_array_equal(c.numpy(), np.asarray(want[1]))
    for k, s, w in zip(kinds, states, want[0]):
        if k == "float":
            assert s.dtype == torch.float32
            np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-3)
        else:
            assert s.dtype == torch.int64
            np.testing.assert_array_equal(s.numpy(), np.asarray(w))


def test_int_sum_count(rng):
    n, G = 40_000, 17
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    vals = rng.integers(-100000, 100000, n).astype(np.int32)
    kinds = ("int", "count")
    _assert_match(*_both(gid, mask, (vals, None), kinds, G), kinds)


def test_int_extremes(rng):
    n, G = 8_192, 3
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = np.ones(n, dtype=bool)
    vals = rng.choice(np.array([-2**31, 2**31 - 1, 0, -1, 1],
                               dtype=np.int32), n)
    _assert_match(*_both(gid, mask, (vals,), ("int",), G), ("int",))


@pytest.mark.parametrize("n,G", [(30_000, 32), (5_000, MAX_G)])
def test_float_sum(rng, n, G):
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    vals = rng.normal(size=n).astype(np.float32)
    _assert_match(*_both(gid, mask, (vals,), ("float",), G), ("float",))


def test_empty_selection_and_unpadded_tail(rng):
    n, G = 1_000, 8          # far below one TPU tile: exercises its padding
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = np.zeros(n, dtype=bool)
    mask[:10] = True
    vals = rng.integers(-5, 5, n).astype(np.int32)
    kinds = ("int", "count")
    _assert_match(*_both(gid, mask, (vals, None), kinds, G), kinds)
    none = np.zeros(n, dtype=bool)
    _assert_match(*_both(gid, none, (vals, None), kinds, G), kinds)


def test_dedupe_sum_avg_share_arg(rng):
    n, G = 20_000, 9
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    vals = rng.integers(-500, 500, n).astype(np.int32)
    # sum(v), count(), avg(v): the two int stats share one argument
    kinds = ("int", "count", "int")
    _assert_match(*_both(gid, mask, (vals, None, vals), kinds, G), kinds)
    # the port keys the dedupe on storage, not on object identity: two
    # tensor objects over the same memory share one slot
    t = torch.from_numpy(vals)
    u_kinds, u_args, slot_of = _dedupe((t, None, t[:], t.view(-1)),
                                       ("int", "count", "int", "int"))
    assert slot_of == [0, None, 0, 0] and len(u_args) == 1
    # the same column as a float argument is another slot
    assert _dedupe((t, t), ("int", "float"))[2] == [0, 1]


def test_narrow_arg_ranges(rng):
    """The JAX kernel's single-limb path for a zone-map range under 2^16;
    K3 takes the ranges and ignores them."""
    n, G = 12_000, 5
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    vals = rng.integers(1000, 9000, n).astype(np.int32)
    wide = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    kinds = ("int", "int", "count")
    _assert_match(*_both(gid, mask, (vals, wide, None), kinds, G,
                         arg_ranges=((1000, 8999), None, None)), kinds)


def test_bool_and_narrow_int_args(rng):
    n, G = 5_000, 4
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    flags = rng.random(n) < 0.3
    small = rng.integers(-100, 100, n).astype(np.int8)
    kinds = ("int", "int")
    _assert_match(*_both(gid, mask, (flags, small), kinds, G), kinds)


def test_plain_equals_wrapper_and_refusals(rng):
    n, G = 3_000, 6
    gid = torch.from_numpy(rng.integers(0, G, n).astype(np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.5)
    f = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    a = group_aggregate(gid, mask, (f, None), ("float", "count"), G)
    b = group_aggregate_plain(gid, mask, (f, None), ("float", "count"), G)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    with pytest.raises(ValueError, match="num_groups"):
        group_aggregate(gid, mask, (f,), ("float",), MAX_G + 1)
    with pytest.raises(ValueError, match="shape"):
        group_aggregate(gid, mask[:-1], (f,), ("float",), G)
    with pytest.raises(ValueError, match="unknown kind"):
        group_aggregate(gid, mask, (f,), ("median",), G)
    # min/max lanes take integers only: floats keep the scatter path
    with pytest.raises(ValueError, match="integer argument"):
        group_aggregate(gid, mask, (f,), ("min",), G)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 1_000_003, 100_000_000])
def test_grid_covers_every_row(n):
    nblocks, rows = grid(n)
    assert rows % 1024 == 0 and 1 <= nblocks <= 1024
    assert (nblocks - 1) * rows < n <= nblocks * rows


# (storage dtype, logical numpy dtype): Int8/16/32/64, UInt8, UInt16 (stored
# widened to int32), Date (int32 days)
MINMAX_TYPES = [(np.int8, np.int8), (np.int16, np.int16),
                (np.int32, np.int32), (np.int64, np.int64),
                (np.uint8, np.uint8), (np.int32, np.uint16),
                (np.int32, "date")]


def _minmax_values(rng, n, storage, logical):
    if logical == "date":
        lo, hi = 0, 65535
    else:
        info = np.iinfo(logical)
        lo, hi = int(info.min), int(info.max)
    v = rng.integers(lo, hi, n, endpoint=True, dtype=np.int64)
    v[: min(n, 4)] = [lo, hi, lo, hi][: min(n, 4)]     # the extremes
    return v.astype(storage)


@pytest.mark.parametrize("G", [1, 2, 7, MAX_G])
@pytest.mark.parametrize("storage,logical", MINMAX_TYPES)
def test_min_max_lanes_match_the_scatter(rng, G, storage, logical):
    """min and max of one column in one call (loaded once) equal the
    scatter reductions' states, empty groups' identities included, and the
    JAX package's over the groups that have rows; rows masked out and
    group ids out of range count nowhere."""
    n = 6_000
    gid = rng.integers(0, G, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    if G > 1:
        mask &= gid != G - 1                     # one empty group
    v = _minmax_values(rng, n, storage, logical)
    kinds = ("min", "max", "count")
    tv = torch.from_numpy(v)
    lanes, u_args, slot_of = _dedupe((tv, tv, None), kinds)
    assert len(u_args) == 1 and [k for k, _a, _d in lanes] == ["min", "max"]
    tgid, tmask = torch.from_numpy(gid), torch.from_numpy(mask)
    oob = tgid.clone()
    oob[::5] = G + 2                             # out of range: skipped
    for g_ids in (tgid, oob):
        states, gc, _ = group_aggregate(g_ids, tmask, (tv, tv, None), kinds,
                                        G)
        want, want_gc = PA.partial_aggregate(g_ids, tmask, (tv, tv),
                                             ("min", "max"), G)
        assert torch.equal(gc, want_gc) and torch.equal(states[2], want_gc)
        for s, w in zip(states, want):
            assert s.dtype == tv.dtype and torch.equal(s, w)
    jst, jgc = JA.partial_aggregate(jnp.asarray(gid), jnp.asarray(mask),
                                    (jnp.asarray(v), jnp.asarray(v)),
                                    ("min", "max"), G)
    states, gc, _ = group_aggregate(tgid, tmask, (tv, tv), ("min", "max"), G)
    has = np.asarray(jgc) > 0
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jgc))
    for s, w in zip(states, jst):
        np.testing.assert_array_equal(s.numpy()[has], np.asarray(w)[has])
    if G > 1:
        info = torch.iinfo(tv.dtype)
        assert int(states[0][G - 1]) == info.max
        assert int(states[1][G - 1]) == info.min


@pytest.mark.parametrize("G", [1, 7])
def test_min_max_beside_sums_and_over_no_rows(rng, G):
    """sum(v), min(v), max(v) and count() read v once; min/max of int64
    beside them; an all-false mask and an empty input give every group the
    identity."""
    n = 4_000
    gid = torch.from_numpy(rng.integers(0, G, n).astype(np.int32))
    v = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))
    w = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64))
    w[:2] = torch.tensor([-2**63, 2**63 - 1])
    kinds = ("int", "min", "max", "count", "min", "max", "int")
    args = (v, v, v, None, w, w, v)
    lanes, u_args, slot_of = _dedupe(args, kinds)
    assert len(u_args) == 2 and len(lanes) == 5
    assert slot_of[0] == slot_of[6] and slot_of[3] is None
    for mask in (torch.from_numpy(rng.random(n) < 0.5),
                 torch.zeros(n, dtype=torch.bool)):
        states, gc, _ = group_aggregate(gid, mask, args, kinds, G)
        want, want_gc = PA.partial_aggregate(
            gid, mask, args, ("sum", "min", "max", "count", "min", "max",
                              "sum"), G)
        assert torch.equal(gc, want_gc)
        for s, x in zip(states, want):
            assert s.dtype == x.dtype and torch.equal(s, x)
    empty = group_aggregate(gid[:0], gid[:0] > 0, (v[:0], w[:0]),
                            ("min", "max"), G)[0]
    assert empty[0].dtype == torch.int32 and empty[1].dtype == torch.int64
    assert bool((empty[0] == 2**31 - 1).all())
    assert bool((empty[1] == -2**63).all())


@pytest.mark.parametrize("fns,args,k3,scatter", [
    (("min", "max"), ("x", "x"), 2, 0),            # a global min/max: K3
    (("min", "sum", "max"), ("x", "x", "x"), 2, 0),
    (("min", "max"), ("f", "f"), 0, 2),            # floats keep the scatter
    (("min", "any"), ("x", "x"), 1, 0),            # any keeps the scatter
])
def test_min_max_routing_counters(rng, fns, args, k3, scatter):
    from myscaledb_tpu_torch.runtime import metrics as M
    n, G = 3_000, 5
    cols = {"x": torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)),
            "f": torch.from_numpy(rng.normal(size=n).astype(np.float32))}
    gid = torch.from_numpy(rng.integers(0, G, n).astype(np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.5)
    a = tuple(cols[c] for c in args)
    before = M.events_snapshot()
    got, gc = PA.partial_aggregate_matmul(gid, mask, a, fns, G)
    after = M.events_snapshot()
    for name, want in (("K3MinMaxAggregates", k3),
                       ("ScatterMinMaxAggregates", scatter)):
        assert after.get(name, 0) - before.get(name, 0) == want
    ref, ref_gc = PA.partial_aggregate(gid, mask, a, fns, G)
    assert torch.equal(gc, ref_gc)
    for s, r in zip(got, ref):
        assert torch.equal(s, r)


def test_min_max_counters_in_system_events(rng):
    """A global min(x), max(x) takes K3's lanes (+2 in system.events); a
    min over more than 256 groups, or of a Nullable argument, the scatter."""
    n = 5_000
    s = P.connect(device="cpu")
    s.create_table("t", {
        "x": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
        "h": rng.integers(0, 1000, n).astype(np.int32)})
    s.sql("CREATE TABLE nt (y Nullable(Int32)) ENGINE = MergeTree "
          "ORDER BY tuple()")
    s.sql("INSERT INTO nt VALUES (1), (NULL), (-3)")

    def moved(sql):
        def events():
            return dict(s.sql("SELECT event, value FROM system.events")
                        .to_rows())
        e0 = events()
        rows = s.sql(sql).to_rows()
        e1 = events()
        return rows, tuple(e1.get(k, 0) - e0.get(k, 0) for k in
                           ("K3MinMaxAggregates", "ScatterMinMaxAggregates"))

    x = s.tables["t"]["x"].data
    rows, d = moved("SELECT min(x), max(x) FROM t")
    assert rows == [(int(x.min()), int(x.max()))] and d == (2, 0)
    rows, d = moved("SELECT h, min(x) FROM t GROUP BY h ORDER BY h LIMIT 3")
    assert len(rows) == 3 and d == (0, 1)
    rows, d = moved("SELECT min(y), max(y) FROM nt")
    assert rows == [(-3, 1)] and d == (0, 2)
