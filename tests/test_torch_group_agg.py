"""K3 on the CPU: the port's ``group_aggregate`` (its plain version, since
the tensors lie on the CPU) against the JAX package's
``pallas_group_aggregate`` in interpret mode, on the same numpy inputs.
The cases mirror tests/test_group_agg_pallas.py.  Counts and int sums must
be equal; f32 sums agree within that test's tolerance against f64 (rtol
1e-4, atol 1e-3)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from myscaledb_tpu.ops.pallas.group_agg import pallas_group_aggregate
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
        group_aggregate(gid, mask, (f,), ("min",), G)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 1_000_003, 100_000_000])
def test_grid_covers_every_row(n):
    nblocks, rows = grid(n)
    assert rows % 1024 == 0 and 1 <= nblocks <= 1024
    assert (nblocks - 1) * rows < n <= nblocks * rows
