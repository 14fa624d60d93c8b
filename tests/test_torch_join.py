"""The probe half of ops/hashtable.py and ops/join.py against the JAX
package, on the cases of tests/test_hashtable.py, test_grace_join.py and
the direct-join cases of test_joins_full.py.  The same numpy keys go
through both; found masks, slots, build rows and (probe, build) pairs must
be equal (the port's row ids are int64, the JAX package's int32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from myscaledb_tpu.ops import hashtable as JHT
from myscaledb_tpu.ops import join as JJ
from myscaledb_tpu_torch.ops import hashtable as PHT
from myscaledb_tpu_torch.ops import join as PJ

torch.set_num_threads(1)


def _t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _eq(p, j):
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def _lookup_both(build, probe, bmask=None, pmask=None):
    jt, _, _ = JHT.build_group_ids(_j(build),
                                   mask=None if bmask is None
                                   else jnp.asarray(bmask))
    pt, _, _ = PHT.build_group_ids(_t(build),
                                   mask=None if bmask is None
                                   else torch.from_numpy(bmask))
    js, jf = JHT.ht_lookup(jt, _j(probe), mask=None if pmask is None
                           else jnp.asarray(pmask))
    ps, pf = PHT.ht_lookup(pt, _t(probe), mask=None if pmask is None
                           else torch.from_numpy(pmask))
    _eq(pf, jf)
    _eq(ps, js)
    _eq(pt.slot_row, jt.slot_row)
    return pt, ps, pf


def test_lookup_found_and_missing():
    build = np.array([5, 9, 13, 5, 21], dtype=np.int32)    # dup key 5
    probe = np.array([13, 7, 5, 21, 40], dtype=np.int32)
    table, slot, found = _lookup_both(build, probe)
    assert found.tolist() == [True, False, True, True, False]
    rows = table.slot_row[slot[found].long()].tolist()
    assert rows == [2, 0, 4]            # the lowest build row wins (ANY)


def test_lookup_against_masked_build_and_probe():
    build = np.array([3, 4, 5, 6], dtype=np.int32)
    probe = np.array([3, 4, 5, 6, 5], dtype=np.int32)
    _, _, found = _lookup_both(build, probe,
                               bmask=np.array([True, False, True, False]),
                               pmask=np.array([True, True, False, True,
                                               True]))
    assert found.tolist() == [True, False, False, False, True]


@pytest.mark.parametrize("dtypes", [(np.int32, np.int32),
                                    (np.int32, np.int64)])
def test_lookup_multi_column_keys(rng, dtypes):
    a = rng.integers(0, 10, 500).astype(dtypes[0])
    b = rng.integers(0, 10, 500).astype(dtypes[1])
    pa = rng.integers(0, 12, 800).astype(dtypes[0])
    pb = rng.integers(0, 12, 800).astype(dtypes[1])
    jt, _, _ = JHT.build_group_ids(_j(a, b))
    pt, _, _ = PHT.build_group_ids(_t(a, b))
    js, jf = JHT.ht_lookup(jt, _j(pa, pb))
    ps, pf = PHT.ht_lookup(pt, _t(pa, pb))
    _eq(pf, jf)
    _eq(ps, js)


def test_lookup_large_merge(rng):
    build = rng.integers(0, 1 << 20, 100_000).astype(np.int32)
    probe = rng.integers(0, 1 << 20, 150_000).astype(np.int32)
    _, _, found = _lookup_both(build, probe)
    assert found.numpy().tolist() == np.isin(probe, build).tolist()


def test_merge_join_any_lowest_build_row():
    build = np.array([7, 7, 7, 3, 3, 9], dtype=np.int32)
    probe = np.array([7, 3, 9, 4], dtype=np.int32)
    row, found = PHT.merge_join_any(_t(build), _t(probe))
    assert found.tolist() == [True, True, True, False]
    assert row[:3].tolist() == [0, 3, 5]


def test_merge_join_any_random(rng):
    build = rng.integers(0, 3000, 20_000).astype(np.int32)
    probe = rng.integers(0, 4000, 30_000).astype(np.int32)
    bvalid = rng.random(20_000) < 0.9
    pvalid = rng.random(30_000) < 0.9
    jr, jf = JHT.merge_join_any(_j(build), _j(probe),
                                build_valid=jnp.asarray(bvalid),
                                probe_valid=jnp.asarray(pvalid))
    pr, pf = PHT.merge_join_any(_t(build), _t(probe),
                                build_valid=torch.from_numpy(bvalid),
                                probe_valid=torch.from_numpy(pvalid))
    _eq(pf, jf)
    _eq(pr, jr)


def test_direct_join_path_equals_hash(rng):
    """Dense build keys take the DirectJoin path; it must match the hash
    path and the JAX package's."""
    build = np.arange(1000, dtype=np.int32)
    rng.shuffle(build)
    build = np.concatenate([build, build[:50]])           # duplicates
    probe = rng.integers(-100, 1200, 5000).astype(np.int32)
    bmask = rng.random(len(build)) < 0.9
    assert PJ.try_build_direct(_t(build)) is not None
    r1 = PJ.hash_join_any(_t(build), _t(probe),
                          build_mask=torch.from_numpy(bmask))
    table = PJ.build_join_table(_t(build),
                                build_mask=torch.from_numpy(bmask))
    r2 = PJ.probe_join_table(table, _t(probe))
    j1 = JJ.hash_join_any(_j(build), _j(probe), build_mask=jnp.asarray(bmask))
    for r in (r1, r2):
        _eq(r.found, j1.found)
        _eq(r.build_row, j1.build_row)


def test_direct_join_sparse_keys_fall_back(rng):
    sparse = rng.integers(0, 2 ** 30, 100).astype(np.int64)
    assert PJ.try_build_direct(_t(sparse)) is None
    assert JJ.try_build_direct(_j(sparse)) is None


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 5000, 20000).astype(np.int64),
            rng.integers(0, 8000, 50000).astype(np.int64))


def test_any_parity_and_grace(keys):
    build, probe = keys
    j = JJ.hash_join_any((build,), (probe,))
    p = PJ.hash_join_any(_t(build), _t(probe))
    g = PJ.grace_hash_join_any(_t(build), _t(probe), n_partitions=8)
    for r in (p, g):
        _eq(r.found, j.found)
        f = r.found.numpy()
        np.testing.assert_array_equal(r.build_row.numpy()[f],
                                      np.asarray(j.build_row)[f])


def test_all_parity_and_grace(keys):
    build, probe = keys
    j = JJ.hash_join_all((build,), (probe,))
    for p in (PJ.hash_join_all(_t(build), _t(probe)),
              PJ.grace_hash_join_all(_t(build), _t(probe), n_partitions=16)):
        _eq(p.found, j.found)
        _eq(p.probe_idx, j.probe_idx)
        _eq(p.build_idx, j.build_idx)


def test_masked_all_join(rng):
    build = rng.integers(0, 50, 400).astype(np.int32)
    probe = rng.integers(0, 60, 700).astype(np.int32)
    bmask = rng.random(400) < 0.7
    pmask = rng.random(700) < 0.7
    j = JJ.hash_join_all(_j(build), _j(probe), build_mask=jnp.asarray(bmask),
                         probe_mask=jnp.asarray(pmask))
    p = PJ.hash_join_all(_t(build), _t(probe),
                         build_mask=torch.from_numpy(bmask),
                         probe_mask=torch.from_numpy(pmask))
    _eq(p.found, j.found)
    _eq(p.probe_idx, j.probe_idx)
    _eq(p.build_idx, j.build_idx)


def test_multicolumn_key_parity():
    rng = np.random.default_rng(1)
    b1, b2 = (rng.integers(0, 100, 5000).astype(np.int64) for _ in range(2))
    p1, p2 = (rng.integers(0, 120, 9000).astype(np.int64) for _ in range(2))
    j = JJ.hash_join_all((b1, b2), (p1, p2))
    g = PJ.grace_hash_join_all(_t(b1, b2), _t(p1, p2), n_partitions=4)
    _eq(g.probe_idx, j.probe_idx)
    _eq(g.build_idx, j.build_idx)


def test_empty_sides():
    e = np.zeros(0, dtype=np.int64)
    k = np.arange(10, dtype=np.int64)
    g = PJ.grace_hash_join_all(_t(e), _t(k))
    assert len(g.probe_idx) == 0 and not g.found.any()
    assert PJ.grace_hash_join_any(_t(k), _t(e)).found.shape == (0,)
    a = PJ.hash_join_all(_t(k), _t(k + 100))
    assert len(a.probe_idx) == 0 and not a.found.any()


def test_partition_ids_match(keys):
    build, _ = keys
    for dt in (np.int32, np.int64):
        _eq(PJ._partition_ids(_t(build.astype(dt)), 8),
            JJ._partition_ids((jnp.asarray(build.astype(dt)),), 8))
