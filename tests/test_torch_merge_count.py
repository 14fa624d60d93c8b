"""K4 on the CPU: the port's ``merge_count`` (its plain version, since the
tensors lie on the CPU) against the JAX package's — the Pallas kernel
itself, run under ``pltpu.force_tpu_interpret_mode()``, and the
``interpret=True`` searchsorted path on the cases of
tests/test_merge_count.py — on the same numpy inputs.  Counts are integers
and must be equal.  Also ``ht_count_matches``' dispatch: one narrow integer
key of a join build takes K4, several keys or a GROUP BY build the merge
sort.  The CUDA kernel's radix directory cannot run here: its layout and a
PyTorch walk of the kernel's steps (``directory_walk``) are held against
searchsorted and the Pallas kernel instead."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myscaledb_tpu.ops.pallas import merge_count as JMC
from myscaledb_tpu.ops import hashtable as JHT
from myscaledb_tpu_torch.interop import count_probe_build_from_numpy
from myscaledb_tpu_torch.ops import hashtable as PHT
from myscaledb_tpu_torch.ops.kernels import merge_count as K4
from myscaledb_tpu_torch.ops.kernels.merge_count import (IMAX, merge_count,
                                                         merge_count_plain,
                                                         prepare_build)

torch.set_num_threads(1)


def _want(build, valid, probe):
    bset = set(np.asarray(build)[np.asarray(valid)].tolist())
    return sum(1 for p in np.asarray(probe).tolist() if p in bset)


def _port(build, valid, probe):
    b, hm = prepare_build(torch.from_numpy(build), torch.from_numpy(valid))
    got = merge_count(b, torch.from_numpy(probe), hm)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(merge_count_plain(b, torch.from_numpy(probe), hm))
    return int(got)


def test_plain_equals_the_pallas_kernel():
    """The TPU kernel's own body, interpreted, on 70K probes: the port's
    sorted build equals the JAX one without its padding and margin rows,
    and the counts are equal."""
    r = np.random.default_rng(5)
    build = r.integers(-100, 3000, 5000).astype(np.int32)
    valid = r.random(5000) > 0.15
    probe = r.integers(-200, 4000, 70_000).astype(np.int32)
    probe[::997] = IMAX
    b2d, hm = JMC.prepare_build(jnp.asarray(build), jnp.asarray(valid))
    with pltpu.force_tpu_interpret_mode():
        want = int(JMC.merge_count(b2d, jnp.asarray(probe), hm,
                                   chunk_elems=1 << 16, interpret=False))
    sk, phm = count_probe_build_from_numpy(np.asarray(b2d), np.asarray(hm),
                                           len(build), "cpu")
    own, own_hm = prepare_build(torch.from_numpy(build),
                                torch.from_numpy(valid))
    assert torch.equal(own, sk) and bool(own_hm) == bool(phm)
    assert int(merge_count(sk, torch.from_numpy(probe), phm)) == want
    assert want == _want(build, valid, probe)


def _random_case(seed):
    r = np.random.default_rng(seed)
    nb = int(r.integers(1, 5000))
    npr = int(r.integers(1, 150_000))
    return (r.integers(-100, 3000, nb).astype(np.int32), r.random(nb) > 0.15,
            r.integers(-200, 4000, npr).astype(np.int32))


def _multichunk_case():
    r = np.random.default_rng(3)
    return (r.integers(0, 1000, 800).astype(np.int32), np.ones(800, bool),
            r.integers(0, 2000, 200_000).astype(np.int32))


CASES = {
    "random0": lambda: _random_case(0),
    "random1": lambda: _random_case(1),
    "random2": lambda: _random_case(2),
    # duplicates, invalid rows, genuine and invalid INT32_MAX build keys
    "sentinel_and_dups": lambda: (
        np.array([5, 5, 5, IMAX, -7, IMAX], dtype=np.int32),
        np.array([True, True, False, True, True, False]),
        np.array([5, 5, IMAX, IMAX, -7, 0, IMAX], dtype=np.int32)),
    # an INT32_MAX build key that is not valid: MAX probes never count
    "no_valid_max": lambda: (
        np.array([1, 2, IMAX], dtype=np.int32),
        np.array([True, True, False]),
        np.array([IMAX, 1, 3], dtype=np.int32)),
    "multichunk": _multichunk_case,
    "all_invalid": lambda: (
        np.array([1, 2, IMAX], dtype=np.int32), np.zeros(3, bool),
        np.array([1, 2, IMAX, 4], dtype=np.int32)),
    "empty_build": lambda: (
        np.zeros(0, dtype=np.int32), np.zeros(0, bool),
        np.array([0, IMAX], dtype=np.int32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_equal_the_jax_package(case):
    build, valid, probe = CASES[case]()
    got = _port(build, valid, probe)
    assert got == _want(build, valid, probe)
    if len(build):       # the JAX prepare_build needs one key at least
        b2d, hm = JMC.prepare_build(jnp.asarray(build), jnp.asarray(valid))
        assert got == int(JMC.merge_count(b2d, jnp.asarray(probe), hm,
                                          chunk_elems=1 << 16))


def test_ht_count_matches_dispatch():
    """Join builds of one int32 key keep the sorted layout and count
    through K4; GROUP BY builds skip it; both agree with the JAX package
    and with the packed-sort path."""
    r = np.random.default_rng(7)
    build = r.integers(0, 500, 2000).astype(np.int32)
    probe = r.integers(0, 900, 30_000).astype(np.int32)
    want = int(JHT.ht_count_matches(
        JHT.build_group_ids((jnp.asarray(build),),
                            prepare_count_probe=True)[0],
        (jnp.asarray(probe),)))
    table_g, _, _ = PHT.build_group_ids((torch.from_numpy(build),))
    assert table_g.sorted_keys is None
    table, _, _ = PHT.build_group_ids((torch.from_numpy(build),),
                                      prepare_count_probe=True)
    assert table.sorted_keys is not None
    assert torch.equal(table.sorted_keys,
                       torch.sort(torch.from_numpy(build)).values)
    got = PHT.ht_count_matches(table, (torch.from_numpy(probe),))
    assert int(got) == want == _want(build, np.ones(2000, bool), probe)
    # the packed merge sort (a mask keeps it off K4) counts the same
    every = torch.ones(len(probe), dtype=torch.bool)
    assert int(PHT.ht_count_matches(table, (torch.from_numpy(probe),),
                                    mask=every)) == want


def test_ht_count_matches_multikey_keeps_sort_path():
    a = np.array([1, 2, 3, 3], dtype=np.int32)
    b = np.array([9, 8, 7, 7], dtype=np.int32)
    pa = np.array([1, 2, 3, 4, 3], dtype=np.int32)
    pb = np.array([9, 0, 7, 7, 7], dtype=np.int32)
    table, _, _ = PHT.build_group_ids((torch.from_numpy(a),
                                       torch.from_numpy(b)),
                                      prepare_count_probe=True)
    assert table.sorted_keys is None
    got = int(PHT.ht_count_matches(table, (torch.from_numpy(pa),
                                           torch.from_numpy(pb))))
    jt, _, _ = JHT.build_group_ids((jnp.asarray(a), jnp.asarray(b)))
    assert got == int(JHT.ht_count_matches(jt, (jnp.asarray(pa),
                                                jnp.asarray(pb)))) == 3


@pytest.mark.parametrize("np_dtype,eligible", [
    (np.int8, True), (np.uint8, True), (np.int16, True), (np.uint16, True),
    (np.int32, True), (np.uint32, False), (np.int64, False),
    (np.float32, False)])
def test_eligibility_follows_the_logical_type(np_dtype, eligible):
    """UInt16 is stored as int32 and UInt32 widened to int64; K4 admits
    the first and excludes the second, as the JAX package does for uint16
    and uint32."""
    from myscaledb_tpu_torch.core.table import to_tensor
    col = np.arange(10).astype(np_dtype)
    assert JHT._merge_count_eligible(jnp.asarray(col)) == eligible
    assert PHT._merge_count_eligible(to_tensor(col, "cpu")) == eligible


EDGE = K4.index_edge_cases()


@pytest.mark.parametrize("case", sorted(EDGE))
def test_directory_walk_equals_searchsorted_and_jax(case):
    """The kernel's steps over its radix directory, taken in PyTorch on the
    directory's edge cases (nb of 0, 1, 2, 16, 17 and 4097, every key in
    one bucket, dense ids, keys at INT32_MIN and INT32_MAX - 1, duplicates
    across bucket edges, an all-invalid build, probes below lo and above
    hi), count what torch.searchsorted and the Pallas kernel count."""
    build, valid, probe = EDGE[case]
    b, hm = prepare_build(torch.from_numpy(build), torch.from_numpy(valid))
    index = K4.build_count_index(b)
    pt = torch.from_numpy(probe)
    got = int(K4.directory_walk(b, pt, hm, index))
    assert got == int(merge_count_plain(b, pt, hm)) == _want(build, valid,
                                                              probe)
    if len(build):       # the JAX prepare_build needs one key at least
        b2d, jhm = JMC.prepare_build(jnp.asarray(build), jnp.asarray(valid))
        with pltpu.force_tpu_interpret_mode():
            want = int(JMC.merge_count(b2d, jnp.asarray(probe), jhm,
                                       chunk_elems=1 << 16, interpret=False))
        assert got == want


@pytest.mark.parametrize("case", sorted(EDGE))
def test_directory_layout(case):
    """The directory the kernel reads: bucket j starts at the first key >=
    lo + j << shift, at most next_pow2(keys // 4) and 2^DIR_BITS buckets
    (the narrowest buckets within that), the last one ending where
    INT32_MAX sentinels begin, and `steps` halvings narrow its longest
    bucket to one 4-key block."""
    build, valid, _probe = EDGE[case]
    b, _hm = prepare_build(torch.from_numpy(build), torch.from_numpy(valid))
    index = K4.build_count_index(b)
    real = b[b != IMAX]
    if real.numel() == 0:
        assert index.nbuckets == 0 and index.hi < index.lo
        return
    assert (index.lo, index.hi) == (int(real[0]), int(real[-1]))
    most = min(1 << K4.DIR_BITS, PHT.next_pow2(real.numel() // 4))
    assert 1 <= index.nbuckets <= most
    assert index.shift == 0 or \
        ((index.hi - index.lo) >> (index.shift - 1)) >= most
    assert ((index.hi - index.lo) >> index.shift) == index.nbuckets - 1
    if case == "dups_straddle_edges":    # edges at the multiples of 8
        assert (index.lo, index.shift) == (0, 3)
    s = index.starts.long()
    assert int(s[0]) == 0 and int(s[-1]) == real.numel()
    assert bool((s[1:] >= s[:-1]).all())
    key = real.long()
    bucket = (key - index.lo) >> index.shift
    pos = torch.arange(real.numel())
    assert bool(((s[bucket] <= pos) & (pos < s[bucket + 1])).all())
    blocks = (s[1:] - 1) // 4 - s[:-1] // 4 + 1
    longest = int(torch.where(s[1:] > s[:-1], blocks, 0).max())
    assert (1 << index.steps) >= longest > (1 << index.steps) // 2 or \
        longest == 1 and index.steps == 0


def test_join_build_keeps_the_directory():
    """A join build of one int32 key carries K4's directory, so the count
    probe pays for it once per build."""
    r = np.random.default_rng(11)
    build = r.integers(-10 ** 6, 10 ** 6, 3000).astype(np.int32)
    table, _, _ = PHT.build_group_ids((torch.from_numpy(build),),
                                      prepare_count_probe=True)
    index = table.count_index
    assert index is not None
    assert torch.equal(index.starts,
                       K4.build_count_index(table.sorted_keys).starts)
    probe = torch.from_numpy(r.integers(-10 ** 6, 10 ** 6, 20_000)
                             .astype(np.int32))
    assert int(K4.directory_walk(table.sorted_keys, probe,
                                 table.sorted_has_max, index)) == \
        int(PHT.ht_count_matches(table, (probe,)))
    assert PHT.build_group_ids((torch.from_numpy(build),))[0] \
        .count_index is None
