"""Set / bloom-filter / n-gram skip indexes through both packages on the
CPU: the cases of tests/test_skip_index.py with the same inputs, rows and
pruned-block counts equal (read through the ``ZonemapPrunedBlocks``
counter: the port has no EXPLAIN ESTIMATE yet), and the port's sidecars,
built with torch ops, bit-equal to the JAX package's numpy builds: the
same set lists and the same bloom words."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime import metrics as JM
from myscaledb_tpu.storage import skip_index as jsk
from myscaledb_tpu_torch.core.table import BLOCK_ROWS
from myscaledb_tpu_torch.runtime import metrics as PM
from myscaledb_tpu_torch.storage import skip_index as psk

torch.set_num_threads(1)


def _both():
    return myscaledb_tpu.connect(), myscaledb_tpu_torch.connect(device="cpu")


def _run(s, metrics, sql):
    metrics.reset()
    rows = s.sql(sql).to_rows()
    ev = metrics.events_snapshot()
    return rows, ev.get("ZonemapPrunedBlocks", 0), ev.get("SkipIndexChecks",
                                                          0)


def _same(j, p, sql):
    got, want = _run(p, PM, sql), _run(j, JM, sql)
    assert repr(got) == repr(want)
    return got


def _blocky(nblocks=4):
    """v: every block holds {0, 99999} (zone maps useless) plus one
    marker 10 + b filling the rest of the block."""
    n = nblocks * BLOCK_ROWS
    v = np.zeros(n, dtype=np.int64)
    for b in range(nblocks):
        v[b * BLOCK_ROWS:(b + 1) * BLOCK_ROWS] = 10 + b
        v[b * BLOCK_ROWS] = 0
        v[b * BLOCK_ROWS + 1] = 99999
    return {"id": np.arange(n, dtype=np.int64), "v": v}


@pytest.fixture(scope="module")
def blocky():
    out = _both()
    for s in out:
        s.create_table("t", _blocky())
    return out


@pytest.mark.parametrize("index,sql,rows,pruned", [
    ("set(100) GRANULARITY 1", "SELECT count() FROM t WHERE v = 12",
     BLOCK_ROWS - 2, 3),
    ("set(100)", "SELECT count() FROM t WHERE v > 20000", 4, 0),
    ("set(100)", "SELECT count() FROM t WHERE v > 99999", 0, 4),
    ("set(100)", "SELECT count() FROM t WHERE v IN (11, 13)",
     2 * (BLOCK_ROWS - 2), 2),
    ("set(100)", "SELECT count() FROM t WHERE 12 = v", BLOCK_ROWS - 2, 3),
    ("set(100)", "SELECT count() FROM t WHERE 12 >= v AND v >= 12",
     BLOCK_ROWS - 2, 0),
    ("bloom_filter(0.01)", "SELECT count() FROM t WHERE v = 11",
     BLOCK_ROWS - 2, None),
    ("bloom_filter(0.01)", "SELECT count() FROM t WHERE v = 424242", 0,
     None),
    ("bloom_filter", "SELECT count() FROM t WHERE v IN (10, 13)",
     2 * (BLOCK_ROWS - 2), None),
])
def test_index_prunes_where_zone_maps_cannot(blocky, index, sql, rows,
                                             pruned):
    j, p = blocky
    for s in (j, p):
        s.sql(f"ALTER TABLE t ADD INDEX ix v TYPE {index}")
    try:
        got = _same(j, p, sql)
    finally:
        for s in (j, p):
            s.sql("ALTER TABLE t DROP INDEX ix")
    assert got[0][0][0] == rows
    if pruned is not None:
        assert got[1] == pruned


def test_set_index_overfull_blocks_never_prune():
    rng = np.random.default_rng(0)
    n = 2 * BLOCK_ROWS
    v = rng.integers(10, 1 << 20, n).astype(np.int64)
    for b in range(2):
        v[b * BLOCK_ROWS] = 0
        v[b * BLOCK_ROWS + 1] = 1 << 21
    j, p = _both()
    for s in (j, p):
        s.create_table("t", {"v": v})
        s.sql("ALTER TABLE t ADD INDEX iv v TYPE set(8)")
    rows, pruned, _ = _same(j, p, "SELECT count() FROM t WHERE v = 7")
    assert pruned == 0


def test_bloom_index_string_column():
    nb = 3
    names = np.concatenate([np.repeat(f"name_{b}", BLOCK_ROWS)
                            for b in range(nb)])
    j, p = _both()
    for s in (j, p):
        s.create_table("t", {"id": np.arange(nb * BLOCK_ROWS,
                                             dtype=np.int64), "name": names})
        s.sql("ALTER TABLE t ADD INDEX bn name TYPE bloom_filter")
    rows, pruned, _ = _same(j, p,
                            "SELECT count() FROM t WHERE name = 'name_1'")
    assert rows[0][0] == BLOCK_ROWS and pruned >= nb - 2
    _same(j, p, "SELECT count() FROM t WHERE name = 'absent'")


def test_create_table_index_clause_and_system_table():
    j, p = _both()
    for s in (j, p):
        s.sql("CREATE TABLE ti (id Int64, v Int64, "
              "INDEX iv v TYPE set(50) GRANULARITY 2, "
              "INDEX bv v TYPE bloom_filter(0.01), "
              "INDEX tk (v) TYPE tokenbf_v1(256, 2, 0)) "
              "ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO ti VALUES (1, 10), (2, 20)")
    rows = _same(j, p, "SELECT table, name, column, type, type_full, "
                 "granularity FROM system.data_skipping_indices "
                 "ORDER BY name")[0]
    assert ("ti", "iv", "v", "set", "set(50)", 2) in rows
    _same(j, p, "SELECT count() FROM ti WHERE v = 10")


def test_create_and_drop_index_statements():
    j, p = _both()
    for s in (j, p):
        s.create_table("t", _blocky(2))
        s.sql("CREATE INDEX IF NOT EXISTS iv ON t(v) TYPE set(100) "
              "GRANULARITY 4")
    assert _same(j, p, "SELECT count() FROM t WHERE v = 11")[1] == 1
    for s in (j, p):
        s.sql("DROP INDEX IF EXISTS iv ON t")
    assert _same(j, p, "SELECT count() FROM t WHERE v = 11")[1:] == (0, 0)


def test_drop_index_stops_pruning_and_an_insert_rebuilds():
    j, p = _both()
    for s in (j, p):
        s.create_table("t", _blocky())
        s.sql("ALTER TABLE t ADD INDEX iv v TYPE set(100)")
    assert _same(j, p, "SELECT count() FROM t WHERE v = 12")[1] == 3
    for s in (j, p):
        s.sql(f"INSERT INTO t VALUES ({4 * BLOCK_ROWS}, 12)")
    rows = _same(j, p, "SELECT count() FROM t WHERE v = 12")[0]
    assert rows[0][0] == BLOCK_ROWS - 2 + 1
    for s in (j, p):
        s.sql("ALTER TABLE t DROP INDEX iv")
    assert _same(j, p, "SELECT count() FROM t WHERE v = 12")[1] == 0


def test_ngram_and_token_blooms_prune_like():
    nb = 3
    names = np.concatenate([
        np.array([f"log line {b} ok {i % 7}" for i in range(BLOCK_ROWS)],
                 dtype=object) for b in range(nb)])
    names[BLOCK_ROWS + 3] = "fatal error 42 occurred ZEBRA"
    j, p = _both()
    for s in (j, p):
        s.create_table("t", {"id": np.arange(nb * BLOCK_ROWS,
                                             dtype=np.int64), "name": names})
        s.sql("ALTER TABLE t ADD INDEX ng name TYPE ngrambf_v1(3, 256, 2, 0)")
        s.sql("ALTER TABLE t ADD INDEX tk name TYPE tokenbf_v1(256, 2, 0)")
    for pat, count in (("%ZEBRA%", 1), ("%QWXYZ%", 0), ("% error %", 1),
                       ("% warning %", 0), ("%line 2%", BLOCK_ROWS)):
        rows, pruned, checks = _same(
            j, p, f"SELECT count() FROM t WHERE name LIKE '{pat}'")
        assert rows[0][0] == count
        if count <= 1:
            assert pruned >= nb - 1


def test_like_variants_semantics():
    j, p = _both()
    for s in (j, p):
        s.create_table("t", {"x": np.array(["Foo", "bar", "foo"],
                                           dtype=object)})
    for sql in ("x LIKE 'foo'", "x NOT LIKE 'foo'", "x ILIKE 'foo'",
                "x NOT ILIKE 'foo'", "x ILIKE 'F%'"):
        _same(j, p, f"SELECT count() FROM t WHERE {sql}")


# --- the sidecars themselves ------------------------------------------------

def _column(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    if kind == "int32":
        return rng.integers(-50, 50, n).astype(np.int32)
    if kind == "uint32":
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "uint16":
        return rng.integers(0, 1 << 16, n).astype(np.uint16)
    if kind == "float32":
        a = rng.integers(-20, 20, n).astype(np.float32) / 4
        a[::97] = -0.0
        return a
    return rng.standard_normal(n)                      # float64


def _dev(a):
    return torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "u"
                           else a)


@pytest.mark.parametrize("kind", ["int64", "int32", "uint32", "uint16",
                                  "float32", "float64"])
@pytest.mark.parametrize("fp", [0.025, 0.001, 0.3])
def test_bloom_words_are_bit_equal(kind, fp):
    for n in (1, 1000, 2 * BLOCK_ROWS + 333):
        a = _column(kind, n, seed=n)
        want = jsk.build_bloom_sidecar(a, fp)
        got = psk.build_bloom_sidecar(_dev(a), fp)
        assert (got.m, got.k) == (want.m, want.k)
        assert got.bits.dtype == want.bits.dtype == np.uint64
        np.testing.assert_array_equal(got.bits, want.bits)


def test_bloom_chunking_is_invisible(monkeypatch):
    a = _column("int64", 5 * BLOCK_ROWS + 7, seed=3)
    whole = psk.build_bloom_sidecar(_dev(a), 0.025)
    monkeypatch.setattr(psk, "BLOOM_CHUNK_ROWS", BLOCK_ROWS)
    np.testing.assert_array_equal(
        psk.build_bloom_sidecar(_dev(a), 0.025).bits, whole.bits)


@pytest.mark.parametrize("kind", ["int64", "int32", "uint32", "uint16",
                                  "float32", "float64"])
@pytest.mark.parametrize("max_values", [8, 100, 5000])
def test_set_lists_are_bit_equal(kind, max_values):
    for n in (0, 7, 2 * BLOCK_ROWS + 333):
        a = _column(kind, n, seed=n + 1)
        if kind in ("int32", "float32"):
            a[:BLOCK_ROWS] = a[:BLOCK_ROWS] % 5      # one block under 8
        want = jsk.build_set_sidecar(a, max_values)
        got = psk.build_set_sidecar(_dev(a), max_values, a.dtype)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.dtype == w.dtype
                if kind.startswith("float"):
                    # a block holding 0.0 and -0.0 keeps one of them, and
                    # which one numpy's sort puts first is not fixed: the
                    # zeros are compared by value, every other bit as is
                    g, w = g + 0.0, w + 0.0
                np.testing.assert_array_equal(g.view(np.uint8),
                                              w.view(np.uint8))


def test_sidecar_is_cached_per_epoch():
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.create_table("t", _blocky(2))
    p.sql("ALTER TABLE t ADD INDEX iv v TYPE set(100)")
    idx = p._table_skip_indexes["t"][0]
    t = p.tables["t"]
    first = psk.sidecar_for(p, t, "v", idx)
    assert psk.sidecar_for(p, t, "v", idx) is first
    p.sql(f"INSERT INTO t VALUES ({2 * BLOCK_ROWS}, 11)")
    t2 = p.tables["t"]
    again = psk.sidecar_for(p, t2, "v", idx)
    assert again is not first and len(again) == 3
