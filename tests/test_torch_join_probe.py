"""The direct-lookup probe of one-integer-key joins (K7's wrapper,
ops/kernels/join_probe.py::probe_direct) on the CPU, where it takes its
plain version: against the element-wise chain that ops/join.py ran before
K7 (copied here as it was) and a numpy oracle; SQL joins whose build
takes the direct lookup against the JAX package; the wrapper's checks;
and the ``system.events`` counters of each probe's route
(``DirectProbeJoins``, ``DirectProbeRows``, ``SearchProbeJoins``).  The
kernel itself runs on the card only (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu_torch.ops import join as PJ
from myscaledb_tpu_torch.ops.hashtable import INT32_MAX
from myscaledb_tpu_torch.ops.kernels.join_probe import (probe_direct,
                                                        probe_direct_plain)
from myscaledb_tpu_torch.runtime import metrics as M

torch.set_num_threads(1)

I64 = np.iinfo(np.int64)
COUNTERS = ("DirectProbeJoins", "DirectProbeRows", "SearchProbeJoins")


def _events():
    ev = M.events_snapshot()
    return {k: ev.get(k, 0) for k in COUNTERS}


def _delta(before):
    after = _events()
    return {k: after[k] - before[k] for k in COUNTERS}


def _chain_before_k7(key, lookup, lo, mask):
    """ops/join.py::probe_sorted's direct branch as it was before K7."""
    m = lookup.shape[0]
    idx = key.to(torch.int64) - lo
    hit = (idx >= 0) & (idx < m)
    row = lookup[idx.clamp_(0, m - 1)]
    del idx
    found = hit & (row != INT32_MAX)
    if mask is not None:
        found = found & mask
    return torch.where(found, row, INT32_MAX), found


def _oracle(key, lookup, lo, mask):
    """Each key's row by plain Python integers (no wrapping)."""
    lk = lookup.tolist()
    rows, found = [], []
    for i, k in enumerate(key.tolist()):
        d = k - lo
        r = lk[d] if 0 <= d < len(lk) else INT32_MAX
        f = r != INT32_MAX and (mask is None or bool(mask[i]))
        rows.append(r if f else INT32_MAX)
        found.append(f)
    return rows, found


def _case(name, rng):
    """(key, lookup, lo) of one case."""
    if name == "below_and_beyond_the_range":
        m, lo = 300, 1_000
        key = rng.integers(lo - 80, lo + m + 80, 4_001).astype(np.int32)
        key[:4] = [lo - 1, lo, lo + m - 1, lo + m]
        lookup = rng.permutation(m).astype(np.int32)
    elif name == "int64_beyond_int32":
        m, lo = 500, 2 ** 33 + 7
        key = rng.integers(lo - 200, lo + m + 200, 3_001).astype(np.int64)
        key[:6] = [I64.min, I64.max, -1, 0, 2 ** 31 - 1, lo - 2 ** 32]
        lookup = rng.permutation(m).astype(np.int32)
    elif name == "negative_lo":
        m, lo = 400, -250
        key = rng.integers(lo - 30, lo + m + 30, 2_999).astype(np.int32)
        key[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
        lookup = rng.permutation(m).astype(np.int32)
    elif name == "absent_entries":
        m, lo = 256, 5
        key = rng.integers(lo, lo + m, 2_048).astype(np.int32)
        lookup = rng.permutation(m).astype(np.int32)
        lookup[rng.random(m) < 0.4] = INT32_MAX
    elif name == "one_entry":
        m, lo = 1, 42
        key = rng.integers(40, 45, 100).astype(np.int64)
        lookup = np.array([3], dtype=np.int32)
    else:                                       # an empty probe
        m, lo = 10, 0
        key = np.zeros(0, dtype=np.int32)
        lookup = np.arange(m, dtype=np.int32)
    return torch.from_numpy(key), torch.from_numpy(lookup), lo


CASES = ["below_and_beyond_the_range", "int64_beyond_int32", "negative_lo",
         "absent_entries", "one_entry", "empty_probe"]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_probe_direct_equals_the_chain_before_k7(case, masked):
    rng = np.random.default_rng(CASES.index(case) + 31)
    key, lookup, lo = _case(case, rng)
    mask = torch.from_numpy(rng.random(key.shape[0]) < 0.5) if masked \
        else None
    launches = probe_direct.launches
    row, found = probe_direct(key, lookup, lo, mask)
    plain_row, plain_found = probe_direct_plain(key, lookup, lo, mask)
    want_row, want_found = _chain_before_k7(key, lookup, lo, mask)
    assert row.dtype == torch.int32 and found.dtype == torch.bool
    assert row.shape == found.shape == key.shape
    assert torch.equal(row, want_row) and torch.equal(found, want_found)
    assert torch.equal(plain_row, want_row)
    assert torch.equal(plain_found, want_found)
    assert (row.tolist(), found.tolist()) == _oracle(key, lookup, lo, mask)
    assert probe_direct.launches == launches        # the CPU launches none


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32,
                                   torch.int64, torch.uint8])
def test_probe_sorted_takes_probe_direct_for_every_key_width(dtype, masked):
    """A dense build through ``build_sorted``; probe keys of every integer
    width (narrow ones widened before the wrapper) and non-contiguous, a
    numpy mask: rows equal the chain's."""
    rng = np.random.default_rng(5)
    build = torch.from_numpy(rng.permutation(np.arange(3, 90)).astype(
        np.int32))
    b = PJ.build_sorted(build)
    assert b.direct is not None
    wide = torch.from_numpy(rng.integers(0, 100, 2 * 501))
    probe = wide.to(dtype)[::2]                 # a strided view
    mask = rng.random(501) < 0.5 if masked else None
    before = _events()
    got = PJ.probe_sorted(b, probe, mask)
    assert _delta(before) == {"DirectProbeJoins": 1, "DirectProbeRows": 501,
                              "SearchProbeJoins": 0}
    want = _chain_before_k7(probe, b.direct.lookup, b.direct.lo,
                            None if mask is None else torch.from_numpy(mask))
    assert torch.equal(got.build_row, want[0])
    assert torch.equal(got.found, want[1])


def _bad_inputs(which):
    key = torch.arange(10, dtype=torch.int32)
    lookup = torch.arange(5, dtype=torch.int32)
    mask = torch.ones(10, dtype=torch.bool)
    lo = 2
    if which == "float_key":
        key = key.float()
    elif which == "int16_key":
        key = key.to(torch.int16)
    elif which == "2d_key":
        key = key.view(2, 5)
    elif which == "int64_lookup":
        lookup = lookup.long()
    elif which == "empty_lookup":
        lookup = lookup[:0]
    elif which == "int_mask":
        mask = mask.int()
    elif which == "short_mask":
        mask = mask[:9]
    elif which == "lookup_on_another_device":
        lookup = torch.empty(5, dtype=torch.int32, device="meta")
    elif which == "key_on_an_unsupported_device":
        key = torch.empty(10, dtype=torch.int32, device="meta")
        lookup = torch.empty(5, dtype=torch.int32, device="meta")
        mask = None
    elif which == "non_contiguous_key":
        key = torch.arange(20, dtype=torch.int32)[::2]
    elif which == "non_contiguous_lookup":
        lookup = torch.arange(10, dtype=torch.int32)[::2]
    elif which == "float_lo":
        lo = 2.0
    return key, lookup, lo, mask


BAD = {"float_key": "int32 or int64", "int16_key": "int32 or int64",
       "2d_key": "1-D", "int64_lookup": "int32 tensor",
       "empty_lookup": "non-empty", "int_mask": "bool tensor",
       "short_mask": r"shape \(10,\)",
       "lookup_on_another_device": "lookup is on meta",
       "key_on_an_unsupported_device": "unsupported device meta",
       "non_contiguous_key": "key is not contiguous",
       "non_contiguous_lookup": "lookup is not contiguous",
       "float_lo": "lo must be an int"}


@pytest.mark.parametrize("which", sorted(BAD))
def test_probe_direct_refuses_what_the_kernel_cannot_take(which):
    key, lookup, lo, mask = _bad_inputs(which)
    with pytest.raises(ValueError, match=BAD[which]):
        probe_direct(key, lookup, lo, mask)
    if which != "key_on_an_unsupported_device":
        with pytest.raises(ValueError, match=BAD[which]):
            probe_direct_plain(key, lookup, lo, mask)


def test_counters_name_each_probe_route():
    """One join whose build keys are dense (the direct lookup) and one
    whose keys are spread (binary search)."""
    rng = np.random.default_rng(9)
    probe = torch.from_numpy(rng.integers(0, 2_000, 777).astype(np.int32))
    dense = torch.from_numpy(rng.permutation(1_500).astype(np.int32))
    spread = dense.to(torch.int64) * 1_000_003
    before = _events()
    res = PJ.hash_join_any([dense], [probe])
    assert _delta(before) == {"DirectProbeJoins": 1, "DirectProbeRows": 777,
                              "SearchProbeJoins": 0}
    before = _events()
    res2 = PJ.hash_join_any([spread], [probe.to(torch.int64) * 1_000_003])
    assert _delta(before) == {"DirectProbeJoins": 0, "DirectProbeRows": 0,
                              "SearchProbeJoins": 1}
    assert torch.equal(res.found, res2.found)
    assert torch.equal(res.build_row, res2.build_row)
    assert res.found.tolist() == (probe < 1_500).tolist()


# SQL joins whose build side takes the direct lookup: dense Int32 keys
# with gaps and keys below and above the build's range, Int64 keys past
# the Int32 range, a filtered probe side
def _tables():
    rng = np.random.default_rng(77)
    n_f, n_d = 2_000, 300
    dk = rng.permutation(np.arange(100, 100 + 2 * n_d))[:n_d]
    return {
        "f": {"id": np.arange(n_f, dtype=np.int64),
              "k": rng.integers(50, 100 + 2 * n_d + 50, n_f).astype(np.int32),
              "k64": (rng.integers(-20, n_d + 20, n_f) + 2 ** 40).astype(
                  np.int64),
              "v": rng.integers(-50, 50, n_f).astype(np.int32)},
        "d": {"k": dk.astype(np.int32),
              "c": rng.integers(0, 9, n_d).astype(np.int32)},
        "d64": {"k64": (rng.permutation(n_d) + 2 ** 40).astype(np.int64),
                "c": rng.integers(0, 9, n_d).astype(np.int32)},
    }


@pytest.fixture(scope="module")
def sessions():
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for name, data in _tables().items():
        j.create_table(name, data)
        p.create_table(name, data)
    return j, p


SQL = [
    "SELECT id, c FROM f ANY INNER JOIN d ON f.k = d.k",
    "SELECT id, c FROM f ALL INNER JOIN d ON f.k = d.k",
    "SELECT id, c FROM f LEFT JOIN d ON f.k = d.k",
    "SELECT id FROM f SEMI LEFT JOIN d ON f.k = d.k",
    "SELECT id FROM f ANTI LEFT JOIN d ON f.k = d.k",
    "SELECT count(), sum(v), sum(c) FROM f INNER JOIN d ON f.k = d.k",
    "SELECT id, c FROM f INNER JOIN d ON f.k = d.k WHERE f.v > 10",
    "SELECT id, d64.c FROM f INNER JOIN d64 ON f.k64 = d64.k64",
    "SELECT id, d64.c FROM f LEFT JOIN d64 ON f.k64 = d64.k64 "
    "WHERE f.v < 0",
    "SELECT d.c, count(), sum(v) FROM f INNER JOIN d ON f.k = d.k "
    "INNER JOIN d64 ON f.k64 = d64.k64 GROUP BY d.c ORDER BY d.c",
]


def _rows(t):
    return [tuple(repr(x) for x in r) for r in t.to_rows()]


@pytest.mark.parametrize("sql", SQL)
def test_sql_joins_through_the_direct_probe_equal_the_jax_package(sessions,
                                                                  sql):
    j, p = sessions
    before = _events()
    got = p.sql(sql)
    moved = _delta(before)
    assert moved["DirectProbeJoins"] == sql.count(" JOIN ")
    assert moved["SearchProbeJoins"] == 0
    want = j.sql(sql)
    assert got.column_names == want.column_names
    assert _rows(got) == _rows(want)
