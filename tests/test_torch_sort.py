"""The sort slice against the JAX package on the CPU: one numpy input,
drawn from a seed, through myscaledb_tpu.ops.sort and
myscaledb_tpu_torch.ops.sort, row ids compared for equality.

Covers every case of tests/test_sort.py (float ASC/DESC, INT_MIN, ties,
mixed-direction multi-key, NULLS FIRST/LAST, NaN), the segment prefilter
of ``topn_permutation`` at 2^19 + 77 rows (uniform and all-tied; NaN,
-NaN, +-0.0 and infinities), its fallback where k * 128 > n, the second
prefilter level at 2^24 + 77 rows, ``streaming_topn_permutation`` over
1000-row chunks with ties across chunk edges, and through SQL the
host-resident (StreamingTopN) and read-in-order (ReadInOrderSorts)
branches of the executor."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.ops import sort as J
from myscaledb_tpu.runtime import metrics as JM
from myscaledb_tpu_torch.ops import sort as P
from myscaledb_tpu_torch.runtime import metrics as PM

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)


def _keys(cols):
    """(values, ascending, valid, nulls_last) tuples -> both packages'
    SortKeys."""
    jk = [J.SortKey(jnp.asarray(v), a,
                    None if m is None else jnp.asarray(m), nl)
          for v, a, m, nl in cols]
    pk = [P.SortKey(torch.from_numpy(v), a,
                    None if m is None else torch.from_numpy(m), nl)
          for v, a, m, nl in cols]
    return jk, pk


def _both_sort(cols):
    jk, pk = _keys(cols)
    want = np.asarray(J.sort_permutation(jk))
    got = P.sort_permutation(pk).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def _both_topn(cols, k, n):
    jk, pk = _keys(cols)
    want = np.asarray(J.topn_permutation(jk, k, n))
    got = P.topn_permutation(pk, k, n).numpy()
    np.testing.assert_array_equal(got, want)
    return got


# -- the cases of tests/test_sort.py ----------------------------------------

@pytest.mark.parametrize("ascending", [True, False])
def test_single_float(rng, ascending):
    v = rng.standard_normal(1000).astype(np.float32)
    perm = _both_sort([(v, ascending, None, True)])
    np.testing.assert_array_equal(
        perm, np.argsort(v if ascending else -v, kind="stable"))


def test_int_desc_includes_intmin():
    v = np.array([5, I32.min, -1, I32.max, 0], dtype=np.int32)
    perm = _both_sort([(v, False, None, True)])
    assert v[perm].tolist() == sorted(v.tolist(), reverse=True)


def test_ties_by_row_id():
    v = np.array([2, 1, 2, 1, 1], dtype=np.int32)
    assert _both_sort([(v, True, None, True)]).tolist() == [1, 3, 4, 0, 2]


def test_multi_key_mixed_direction(rng):
    a = rng.integers(0, 5, 300).astype(np.int32)
    b = rng.standard_normal(300).astype(np.float32)
    perm = _both_sort([(a, True, None, True), (b, False, None, True)])
    np.testing.assert_array_equal(perm, np.lexsort((np.arange(300), -b, a)))


@pytest.mark.parametrize("nulls_last,want", [(True, [2, 0, 1, 3]),
                                             (False, [1, 3, 2, 0])])
def test_nulls_last_and_first(nulls_last, want):
    v = np.array([3.0, 1.0, 2.0, 5.0], dtype=np.float32)
    valid = np.array([True, False, True, False])
    assert _both_sort([(v, True, valid, nulls_last)]).tolist() == want
    assert _both_topn([(v, True, valid, nulls_last)], 3, 4).tolist() == \
        want[:3]


def test_nan_sorts_last_asc():
    v = np.array([1.0, np.nan, -np.inf, np.inf, 0.0], dtype=np.float32)
    assert _both_sort([(v, True, None, True)]).tolist() == [2, 4, 0, 3, 1]


@pytest.mark.parametrize("ascending", [True, False])
def test_topn_matches_sort(rng, ascending):
    v = rng.standard_normal(5000).astype(np.float32)
    top = _both_topn([(v, ascending, None, True)], 20, 5000)
    np.testing.assert_array_equal(
        top, P.sort_permutation([P.SortKey(torch.from_numpy(v),
                                           ascending)])[:20].numpy())


def test_topn_multikey_fallback(rng):
    a = rng.integers(0, 3, 200).astype(np.int32)
    b = rng.integers(0, 100, 200).astype(np.int32)
    _both_topn([(a, True, None, True), (b, False, None, True)], 10, 200)


def test_topn_segmented_matches_flat(rng):
    v = torch.from_numpy(rng.standard_normal(100000).astype(np.float32))
    for asc in (True, False):
        code = P.encode_sort_key(P.SortKey(v, asc))[0]
        flat = P._smallest_k(code, 50)
        seg = P._topn_single_segmented(v, 50, asc)
        assert torch.equal(seg, flat)


def test_topn_segmented_ties_and_padding():
    # 1000 rows (not a multiple of 128), heavy duplicates
    v = np.zeros(1000, dtype=np.float32)
    v[500:] = 1.0
    t = torch.from_numpy(v)
    got = P._topn_single_segmented(t, 20, True)
    assert got.tolist() == list(range(20))          # ties -> lowest ids
    got = P._topn_single_segmented(t, 20, False)
    assert got.tolist() == list(range(500, 520))


# -- the segment prefilter at its real thresholds ---------------------------

N_SEG = (1 << 19) + 77


def _column(kind, n, rng):
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "tied":
        return np.full(n, 0.5, dtype=np.float32)
    if kind == "special":
        # NaN, -NaN, +-0.0 and infinities scattered among few values
        pool = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0,
                         -1.0], dtype=np.float32)
        return pool[rng.integers(0, len(pool), n)]
    if kind == "negative":
        # every segment's values have the sign bit set
        return -np.abs(rng.standard_normal(n)).astype(np.float32) - 1e-3
    if kind == "int32":
        return rng.integers(0, 1000, n).astype(np.int32)
    if kind == "int64":
        return rng.integers(-3, 3, n).astype(np.int64) * (1 << 40)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["normal", "tied", "special", "negative",
                                  "int32", "int64"])
@pytest.mark.parametrize("ascending", [True, False])
def test_segmented_path_at_threshold(rng, kind, ascending, monkeypatch):
    v = _column(kind, N_SEG, rng)
    taken = []
    real = P._topn_single_segmented
    monkeypatch.setattr(P, "_topn_single_segmented",
                        lambda *a: taken.append(a[1]) or real(*a))
    top = _both_topn([(v, ascending, None, True)], 100, N_SEG)
    assert taken == [100]                      # the prefilter ran
    full = P.sort_permutation([P.SortKey(torch.from_numpy(v), ascending)])
    np.testing.assert_array_equal(top, full[:100].numpy())


def test_k_times_128_past_n_falls_back(rng, monkeypatch):
    v = rng.integers(0, 50, N_SEG).astype(np.int32)
    k = N_SEG // 128 + 1
    monkeypatch.setattr(P, "_topn_single_segmented", None)
    _both_topn([(v, False, None, True)], k, N_SEG)


N_L2 = (1 << 24) + 77


@pytest.mark.parametrize("kind,ascending", [("normal", False),
                                            ("tied", True),
                                            ("int32", False)])
def test_second_level_prune(rng, kind, ascending):
    """2^24 + 77 rows: 131,073 segments, so the prefilter prunes the
    segment array too.  The JAX package's full sort takes over 10 s here,
    so the full-sort oracle is the port's (or, all-tied, the row ids)."""
    v = _column(kind, N_L2, rng)
    top = _both_topn([(v, ascending, None, True)], 100, N_L2)
    if kind == "tied":
        want = np.arange(100)
    else:
        want = P.sort_permutation([P.SortKey(torch.from_numpy(v),
                                             ascending)])[:100].numpy()
    np.testing.assert_array_equal(top, want)


def test_second_level_ties_across_groups():
    """Ties at the k-th segment span groups of 128 segments, and the group
    holding the best row ranks first but lies past the others: the chosen
    groups must be scanned in segment-id order for the lowest-id ties to
    win."""
    v = np.zeros(N_L2, dtype=np.int32)
    v[::1000] = 1
    v[8_000_003] = 2
    top = _both_topn([(v, False, None, True)], 100, N_L2)
    want = np.concatenate([[8_000_003], np.arange(0, 99 * 1000, 1000)])
    np.testing.assert_array_equal(top, want)


# -- streaming top-n ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["int32", "float", "nullable", "two_keys"])
def test_streaming_topn_matches_jax(rng, kind):
    n, k = 5500, 37
    # few distinct values, so ties cross every 1000-row chunk edge
    a = rng.integers(0, 4, n).astype(np.int32)
    if kind == "int32":
        cols = [(a, False, None, True)]
    elif kind == "float":
        cols = [(_column("special", n, rng), True, None, True)]
    elif kind == "nullable":
        cols = [(a, True, rng.random(n) < 0.8, False)]
    else:
        cols = [(a, True, None, True),
                (rng.integers(0, 3, n).astype(np.int64), False, None, True)]
    jk = [J.SortKey(v, asc, m, nl) for v, asc, m, nl in cols]
    pk = [P.SortKey(v, asc, m, nl) for v, asc, m, nl in cols]
    want = np.asarray(J.streaming_topn_permutation(jk, k, n, 1000))
    got = P.streaming_topn_permutation(pk, k, n, 1000, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    full = P.sort_permutation([P.SortKey(torch.from_numpy(v), asc,
                                         None if m is None
                                         else torch.from_numpy(m), nl)
                               for v, asc, m, nl in cols])
    np.testing.assert_array_equal(got.numpy(), full[:k].numpy())


# -- through SQL: host-resident keys and read-in-order ----------------------

def _sessions(data, **settings):
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        for name, val in settings.items():
            setattr(s.settings, name, val)
        s.create_table("t", data)
    return j, p


def _count(metrics, name):
    return metrics.events_snapshot().get(name, 0)


def test_streaming_topn_through_sql(rng):
    n = 6000
    data = {"id": np.arange(n, dtype=np.int64),
            "v": rng.integers(0, 5, n).astype(np.int32),
            "f": _column("special", n, rng)}
    j, p = _sessions(data, max_hbm_bytes_per_column=4096,
                     stream_chunk_rows=1000)
    assert p.tables["t"]["v"].is_host
    for stmt in ("SELECT id, v FROM t ORDER BY v DESC LIMIT 25",
                 "SELECT id, f FROM t ORDER BY f LIMIT 10 OFFSET 3",
                 "SELECT id FROM t ORDER BY v, f DESC LIMIT 40"):
        before = (_count(JM, "StreamingTopN"), _count(PM, "StreamingTopN"))
        assert p.sql_tsv(stmt) == j.sql_tsv(stmt)
        grew = (_count(JM, "StreamingTopN") - before[0],
                _count(PM, "StreamingTopN") - before[1])
        assert grew == (1, 1)


def test_read_in_order_through_sql(rng):
    n = (1 << 20) + 5
    data = {"id": np.arange(n, dtype=np.int64),
            "v": rng.integers(-9, 9, n).astype(np.int32)}
    j, p = _sessions(data)
    for stmt, moves in (("SELECT id, v FROM t ORDER BY id LIMIT 7", 1),
                        ("SELECT id, v FROM t ORDER BY id LIMIT 4 OFFSET 9",
                         1),
                        ("SELECT id FROM t ORDER BY v LIMIT 5", 0),
                        ("SELECT id FROM t ORDER BY id DESC LIMIT 5", 0)):
        before = (_count(JM, "ReadInOrderSorts"),
                  _count(PM, "ReadInOrderSorts"))
        assert p.sql_tsv(stmt) == j.sql_tsv(stmt)
        grew = (_count(JM, "ReadInOrderSorts") - before[0],
                _count(PM, "ReadInOrderSorts") - before[1])
        assert grew == (moves, moves)
