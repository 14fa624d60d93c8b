"""Binary vectors through the port on the CPU, against the JAX package and
against tests/test_binary_vector.py's expected rows: the reference's
1024-row FixedString(4) table (00038_mqvs_binary_vector_feature), Hamming
with and without a filter, Jaccard under the table setting.  Also the
FixedString column and its packed sidecar against the JAX DDL's, the
string functions that build query vectors (unhex, unbin, char), the width
mismatch error, the empty Jaccard union, the streaming scan against one
block, a zone-map-pruned scan that must not use the cached sidecar, and
what stays outside the slice (batch_distance)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import myscaledb_tpu
from myscaledb_tpu.ops import binary_vector as JBV
from myscaledb_tpu.runtime.formats import ch_tsv_lines
from myscaledb_tpu.sql.executor import _binary_sidecar as jax_sidecar
import myscaledb_tpu_torch
from myscaledb_tpu_torch.config import TableSettings
from myscaledb_tpu_torch.core.table import Column, Table
from myscaledb_tpu_torch.errors import NotPortedError
from myscaledb_tpu_torch.interop import fixed_string_column
from myscaledb_tpu_torch.ops import binary_vector as PBV
from myscaledb_tpu_torch.sql.executor import _binary_sidecar
from myscaledb_tpu_torch.sql.format import format_tsv

from test_binary_vector import (HAMMING_FILTERED, HAMMING_TOP20,
                                JACCARD_TOP20)

torch.set_num_threads(1)

N = 1024
DIST = "distance(vector, char(100, 101, 102, 103))"


def _port_table(settings=None):
    s = myscaledb_tpu_torch.connect(device="cpu")
    # char(number, number, number, number) for number in [0, 1024)
    raw = np.repeat((np.arange(N) & 0xFF).astype(np.uint8)[:, None], 4, 1)
    s.register("test_binary", Table([
        Column.from_numpy("id", np.arange(N, dtype=np.uint32), device="cpu"),
        fixed_string_column("vector", raw, 4, device="cpu")]), settings)
    return s


@pytest.fixture(scope="module")
def jax_sess():
    s = myscaledb_tpu.session.Session()
    s.sql("CREATE TABLE test_binary(id UInt32, vector FixedString(4)) "
          "engine MergeTree primary key id")
    s.sql("INSERT INTO test_binary SELECT number, "
          "char(number, number, number, number) FROM numbers(1024)")
    return s


def _lines(s, q):
    return format_tsv(s.sql(q)).splitlines()


def test_hamming_brute_force():
    got = _lines(_port_table(), f"SELECT id, {DIST} AS dist FROM test_binary"
                 " ORDER BY dist,id LIMIT 20")
    assert got == HAMMING_TOP20


def test_hamming_with_filter():
    got = _lines(_port_table(), f"SELECT id, {DIST} AS dist FROM test_binary"
                 " WHERE id > 100 and id < 120 ORDER BY dist,id LIMIT 20")
    assert got == HAMMING_FILTERED


def test_jaccard_brute_force():
    s = _port_table(TableSettings(binary_vector_search_metric_type="Jaccard"))
    got = _lines(s, f"SELECT id, {DIST} AS dist FROM test_binary "
                 "ORDER BY dist,id LIMIT 20")
    assert got == JACCARD_TOP20


def test_column_and_sidecar_equal_the_jax_ddl(jax_sess):
    p = _port_table()
    jc, pc = jax_sess.tables["test_binary"]["vector"], \
        p.tables["test_binary"]["vector"]
    assert pc.field.fixed_len == jc.field.fixed_len == 4
    assert pc.dictionary.values == jc.dictionary.values
    np.testing.assert_array_equal(pc.data.numpy(), np.asarray(jc.data))
    jx3, jn = jax_sidecar(jax_sess, "test_binary",
                          jax_sess.tables["test_binary"], "vector")
    px3, pn = _binary_sidecar(p, "test_binary", p.tables["test_binary"],
                              "vector")
    assert pn == jn == N
    np.testing.assert_array_equal(px3.numpy(),
                                  np.asarray(jx3).view(np.int32))


def test_fixed_string_column_pads_and_refuses_long_values():
    c = fixed_string_column("v", [b"ab", None, "\xe9", b"abcd"], 4,
                            device="cpu")
    assert c.to_python() == ["ab\x00\x00", "\x00" * 4, "\xe9\x00\x00\x00",
                             "abcd"]
    assert c.field.fixed_len == 4 and not c.field.nullable
    with pytest.raises(ValueError, match="Too large value"):
        fixed_string_column("v", [b"abcde"], 4, device="cpu")


def test_string_functions_equal_the_jax_package():
    data = {"id": np.arange(6, dtype=np.int32),
            "h": ["41", "ff00", "", "0A0b", "7e", "41"],
            "b": ["0101", "", "11111111", "100000000", "1", "0101"]}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("s", data)
    p.create_table("s", data)
    for q in ("SELECT id, unhex(h), unbin(b), char(id, 65, 255) FROM s",
              "SELECT unhex('FFAA'), unbin('0101'), char(65, 255), "
              "char(321, 0) FROM s WHERE id < 2"):
        assert p.sql(q).to_rows() == j.sql(q).to_rows()


@pytest.mark.parametrize("qexpr", ["unhex('64656667')",
                                   "unbin('01100100011001010110011001100111')",
                                   "'defg'"])
def test_query_vector_expressions(jax_sess, qexpr):
    q = (f"SELECT id, distance(vector, {qexpr}) AS d FROM test_binary "
         "ORDER BY d LIMIT 12")
    assert _lines(_port_table(), q) == ch_tsv_lines(jax_sess.sql(q))


def test_query_vector_width_mismatch(jax_sess):
    q = ("SELECT id, distance(vector, char(1, 2)) AS d FROM test_binary "
         "ORDER BY d LIMIT 1")
    with pytest.raises(Exception) as want:
        jax_sess.sql(q)
    with pytest.raises(Exception, match="bytes") as got:
        _port_table().sql(q)
    assert str(got.value) == str(want.value)


def test_outside_the_slice_raises_not_ported():
    s = _port_table()
    with pytest.raises(NotPortedError):
        s.sql(f"SELECT id, {DIST} AS d FROM test_binary")


def test_batch_distance_equals_the_jax_package(jax_sess):
    q = ("SELECT id, batch_distance(vector, [unhex('64656667'), "
         "unhex('FFFFFFFF')]) AS d FROM test_binary ORDER BY d.1, d.2, id "
         "LIMIT 5 BY d.1")
    assert _lines(_port_table(), q) == ch_tsv_lines(jax_sess.sql(q))


def test_jaccard_empty_union():
    xw = PBV.pack_binary([b"\x00\x00", b"\x03\x00"], 2)
    qw = PBV.pack_binary([b"\x00\x00"], 2)
    d, ids = PBV.binary_distance_scan(xw, qw, metric="Jaccard", k=2)
    # empty union -> distance 1; row 1 has union 2, inter 0
    assert sorted(zip(ids[0].tolist(), d[0].tolist())) == [(0, 1.0),
                                                           (1, 1.0)]


def test_streaming_path_matches_single_block():
    """The chunked streaming path (n > block_rows) returns the same
    (score, id) rows as one block and as the JAX package, with ties by id,
    a mask and a tail that is not a whole chunk."""
    rng = np.random.default_rng(7)
    n, words, nq, k = 5000, 4, 3, 7
    xw = rng.integers(0, 1 << 32, (n, words), dtype=np.uint32)
    xw[1::9] = xw[0]
    qw = rng.integers(0, 1 << 32, (nq, words), dtype=np.uint32)
    mask = rng.random(n) < 0.5
    for metric in ("Hamming", "Jaccard"):
        for m in (None, mask):
            tm = None if m is None else torch.from_numpy(m)
            one_d, one_i = PBV.binary_distance_scan(xw, qw, metric, k,
                                                    mask=tm)
            got_d, got_i = PBV.binary_distance_scan(xw, qw, metric, k,
                                                    mask=tm, block_rows=512)
            jd, ji = JBV.binary_distance_scan(
                jnp.asarray(xw), jnp.asarray(qw), metric, k,
                mask=None if m is None else jnp.asarray(m), block_rows=512)
            assert torch.equal(one_i, got_i) and torch.equal(one_d, got_d)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(got_d.numpy(), np.asarray(jd))


def test_pruned_scan_skips_the_base_tables_sidecar():
    """A WHERE that zone-map pruning narrows to whole 64K-row blocks
    replaces the scanned column, so the packed sidecar a query on the whole
    table cached must not be used; the rows still equal a numpy oracle."""
    n = 70_000
    raw = np.random.default_rng(9).integers(0, 256, (n, 4), dtype=np.uint8)
    s = myscaledb_tpu_torch.connect(device="cpu")
    s.register("tb", Table([
        Column.from_numpy("id", np.arange(n, dtype=np.int64), device="cpu"),
        fixed_string_column("bv", raw, 4, device="cpu")]))
    q = raw[66_123]
    dist = np.unpackbits(raw ^ q, axis=1).sum(1).astype(np.float32)
    for lo in (0, 66_000):          # the second prunes the first block
        ids = np.arange(lo, n)
        top = ids[np.lexsort((ids, dist[lo:]))[:5]]
        rows = s.sql(f"SELECT id, distance(bv, unhex('{q.tobytes().hex()}'))"
                     f" AS d FROM tb WHERE id >= {lo} ORDER BY d LIMIT 5")
        assert rows.to_rows() == [(int(i), float(dist[i])) for i in top]
