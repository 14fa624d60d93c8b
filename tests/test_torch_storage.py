"""On-disk storage through both packages on the CPU: the cases of
tests/test_storage.py run through myscaledb_tpu_torch's storage/codecs.py,
part.py and table_store.py beside the JAX package's, with the same seeded
numpy inputs.  A codec frame and a part must be byte-identical whichever
package writes them (every codec; zstd where the ``zstandard`` module is
installed), and a part one package writes must read back in the other,
equal."""

import json
import os

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.core.table import Table as JTable
from myscaledb_tpu.storage import codecs as jcodecs
from myscaledb_tpu.storage.part import read_part as jread_part
from myscaledb_tpu.storage.part import write_part as jwrite_part
from myscaledb_tpu.storage.table_store import TableStore as JStore
from myscaledb_tpu_torch.core.table import BLOCK_ROWS, Table
from myscaledb_tpu_torch.storage import codecs
from myscaledb_tpu_torch.storage.background import BackgroundExecutor
from myscaledb_tpu_torch.storage.part import (PartError, parallel_map,
                                              read_part, write_part)
from myscaledb_tpu_torch.storage.table_store import TableStore, open_table

torch.set_num_threads(1)

CODECS = ["none", "zlib", "delta", "shuffle", "lz"] + (
    ["zstd", "deltazstd"] if codecs._zstd is not None else [])


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "id": np.arange(n, dtype=np.int64),
        "v": rng.integers(0, 100, n).astype(np.int32),
        "u": rng.integers(0, 1 << 32, n).astype(np.uint32),
        "f": rng.standard_normal(n).astype(np.float32),
        "s": [str(x) for x in rng.choice(["red", "green", "blue"], n)],
        "ns": [None if i % 7 == 0 else f"k{i % 5}" for i in range(n)],
        "emb": rng.standard_normal((n, 8)).astype(np.float32),
    }


def _tables(n, seed=0):
    d = _data(n, seed)
    return JTable.from_dict(d), Table.from_dict(d, device="cpu")


def _same_rows(t_port, t_jax):
    assert t_port.column_names == t_jax.column_names
    assert repr(t_port.to_rows()) == repr(t_jax.to_rows())


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", ["int64", "int32", "uint32", "float32"])
def test_codec_frames_are_identical(codec, dtype):
    rng = np.random.default_rng(1)
    arr = (rng.integers(-1000, 1000, 10000) if dtype != "float32"
           else rng.standard_normal(10000)).astype(dtype)
    if codec in ("delta", "deltazstd") and dtype == "float32":
        with pytest.raises(codecs.CodecError):
            codecs.encode(arr, codec)
        return
    buf = codecs.encode(arr, codec)
    assert buf == jcodecs.encode(arr, codec)
    np.testing.assert_array_equal(codecs.decode(buf, dtype, len(arr)), arr)
    np.testing.assert_array_equal(jcodecs.decode(buf, dtype, len(arr)), arr)


def test_parallel_map_keeps_order_and_nests():
    """The shared pool gives results in order, and a call made from one
    of its own threads (a file column that reads a part) runs serially
    in place of waiting on the pool it occupies."""
    items = list(range(4 * (os.cpu_count() or 1) + 3))
    inner = lambda i: parallel_map(lambda j: i * 1000 + j, list(range(5)))
    assert parallel_map(inner, items) == [
        [i * 1000 + j for j in range(5)] for i in items]


def test_codec_roundtrip_vectors_and_corruption():
    arr = np.random.default_rng(2).standard_normal((100, 16)).astype(
        np.float32)
    buf = codecs.encode(arr, "shuffle")
    np.testing.assert_array_equal(
        codecs.decode(buf, np.float32, arr.size).reshape(arr.shape), arr)
    bad = bytearray(codecs.encode(np.arange(100, dtype=np.int64), "zlib"))
    bad[-1] ^= 0xFF
    with pytest.raises(codecs.CodecError, match="checksum"):
        codecs.decode(bytes(bad), np.int64, 100)
    seq = np.arange(100000, dtype=np.int64)
    assert len(codecs.encode(seq, "delta")) < \
        len(codecs.encode(seq, "zlib")) / 5


def test_lz_decoder_refuses_a_truncated_frame():
    raw = np.tile(np.arange(64, dtype=np.int64), 64)
    buf = codecs.encode(raw, "lz")
    header, payload = buf[:17], buf[17:]
    import zlib
    import struct
    cut = payload[:len(payload) // 2]
    frame = header[:4] + struct.pack("<BQI", codecs.CODECS["lz"], raw.nbytes,
                                     zlib.crc32(cut) & 0xFFFFFFFF) + cut
    with pytest.raises(ValueError, match="msdb-lz"):
        codecs.decode(frame, np.int64, raw.size)


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("codec", ["zlib", "lz", None])
def test_part_is_byte_identical(tmp_path, codec):
    """The same table written by each package: meta.json and every file
    equal, for zlib and lz over every column and for the default codecs;
    a part spanning two granules."""
    jt, pt = _tables(BLOCK_ROWS + 1234)
    over = {c: codec for c in pt.column_names} if codec else None
    pp = write_part(str(tmp_path / "p" / "part_0_x"), pt, sort_key=["id"],
                    codec_overrides=over)
    jp = jwrite_part(str(tmp_path / "j" / "part_0_x"), jt, sort_key=["id"],
                     codec_overrides=over)
    pf, jf = _files(pp), _files(jp)
    assert sorted(pf) == sorted(jf)
    assert json.loads(pf["meta.json"]) == json.loads(jf["meta.json"])
    for name in pf:
        assert pf[name] == jf[name], name


@pytest.mark.parametrize("codec", ["zlib", "lz"])
def test_parts_read_across_packages(tmp_path, codec):
    jt, pt = _tables(3000, seed=3)
    over = {c: codec for c in pt.column_names}
    pp = write_part(str(tmp_path / "part_0_p"), pt, codec_overrides=over)
    jp = jwrite_part(str(tmp_path / "part_1_j"), jt, codec_overrides=over)
    _same_rows(read_part(jp, device="cpu"), jread_part(jp))
    _same_rows(read_part(pp, device="cpu"), jread_part(pp))
    _same_rows(read_part(pp, device="cpu"), jt)


def test_part_roundtrip_pruning_and_no_overwrite(tmp_path):
    jt, pt = _tables(1000)
    p = write_part(str(tmp_path / "part_0_1000"), pt)
    t2 = read_part(p, device="cpu")
    _same_rows(t2, jt)
    assert t2["emb"].field.vector_dim == 8
    assert t2["u"].to_numpy().dtype == np.uint32
    assert read_part(p, columns=["id", "s"], device="cpu").column_names \
        == ["id", "s"]
    with pytest.raises(PartError, match="already exists"):
        write_part(str(tmp_path / "part_0_1000"), pt)
    zm = t2["v"].zonemap
    np.testing.assert_array_equal(zm.mins, jread_part(p)["v"].zonemap.mins)


def test_array_column_is_refused(tmp_path):
    s = myscaledb_tpu_torch.connect(device="cpu")
    t = s.sql("SELECT number AS n, [number, 1] AS a FROM numbers(4)")
    with pytest.raises(PartError, match="ARRAY"):
        write_part(str(tmp_path / "part_0_4"), t)
    assert not os.listdir(tmp_path)


def test_granule_range_read(tmp_path):
    rng = np.random.default_rng(4)
    n = BLOCK_ROWS * 2 + 1234
    d = {"a": np.arange(n, dtype=np.int64),
         "f": rng.standard_normal(n).astype(np.float32)}
    p = write_part(str(tmp_path / "part_0_x"), Table.from_dict(d,
                                                               device="cpu"))
    for lo, hi in ((BLOCK_ROWS - 10, BLOCK_ROWS + 25), (n - 5, n), (0, 3)):
        sub = read_part(p, row_range=(lo, hi), device="cpu")
        want = jread_part(p, row_range=(lo, hi))
        assert sub["a"].to_numpy().tolist() == list(range(lo, hi))
        np.testing.assert_array_equal(sub["f"].to_numpy(),
                                      np.asarray(want["f"].data))
    assert read_part(p, device="cpu").n_rows == n


def test_store_insert_load_merge(tmp_path):
    store = TableStore(str(tmp_path / "t"), device="cpu")
    jstore = JStore(str(tmp_path / "j"))
    for n, seed in ((300, 5), (200, 6)):
        jt, pt = _tables(n, seed)
        store.insert(pt)
        jstore.insert(jt)
    assert len(store.parts()) == 2 and store.total_rows() == 500
    loaded = store.load()
    _same_rows(loaded, jstore.load())
    before = loaded.to_rows()
    store.merge_parts()
    jstore.merge_parts()
    assert len(store.parts()) == 1
    assert store.load().to_rows() == before
    # the merged part is the same but for the String columns' ids: the
    # JAX package's concat_tables widens them to int64, the port keeps
    # int32 (the dictionaries and the strings are equal)
    for pf, jf in zip(store.parts(), jstore.parts()):
        assert os.path.basename(pf) == os.path.basename(jf)
        a, b = _files(pf), _files(jf)
        assert sorted(a) == sorted(b)
        ma, mb = json.loads(a.pop("meta.json")), json.loads(b.pop(
            "meta.json"))
        for ca, cb in zip(ma.pop("columns"), mb.pop("columns")):
            if ca["name"] in ("s", "ns"):
                for key in ("dtype", "bytes", "marks", "codec"):
                    ca.pop(key), cb.pop(key)
            assert ca == cb
        assert ma == mb
        for name in a:
            if name.split(".")[0] not in ("s", "ns") or \
                    name.endswith((".dict.json", ".null.bin")):
                assert a[name] == b[name], name


def test_store_sorted_insert(tmp_path):
    jt, pt = _tables(100, seed=7)
    store = TableStore(str(tmp_path / "t"), device="cpu")
    jstore = JStore(str(tmp_path / "j"))
    store.insert(pt, sort_key=["s", "v", "id"])
    jstore.insert(jt, sort_key=["s", "v", "id"])
    _same_rows(store.load(), jstore.load())
    v = store.load()["v"].to_numpy()
    s = store.load()["s"].to_python()
    assert s == sorted(s)
    assert all(np.diff(v[np.asarray(s) == "red"]) >= 0)


def test_tmp_garbage_collected_and_numeric_part_order(tmp_path):
    store = TableStore(str(tmp_path / "t"), device="cpu")
    for i in range(12):
        store.insert(Table.from_dict({"v": np.array([i], dtype=np.int64)},
                                     device="cpu"))
    os.makedirs(str(tmp_path / "t" / "tmp_part_9_999_deadbeef"))
    store2 = TableStore(str(tmp_path / "t"), device="cpu")
    assert not any(d.startswith("tmp_")
                   for d in os.listdir(str(tmp_path / "t")))
    assert store2.total_rows() == 12
    assert store2.load()["v"].to_numpy().tolist() == list(range(12))


def test_checkpoint_restore_through_session(tmp_path):
    """Save a session table, reopen it in a new session, run the same
    query: equal to the JAX package's over its own checkpoint."""
    jt, pt = _tables(400, seed=8)
    q = "SELECT s, count(*), sum(v), min(u) FROM t GROUP BY s ORDER BY s"
    s = myscaledb_tpu_torch.connect(device="cpu")
    s.register("t", pt)
    want = s.sql_tsv(q)
    TableStore(str(tmp_path / "ckpt"), device="cpu").insert(pt)
    s2 = myscaledb_tpu_torch.connect(device="cpu")
    s2.register("t", open_table(str(tmp_path / "ckpt"), device="cpu"))
    assert s2.sql_tsv(q) == want
    j = myscaledb_tpu.connect()
    j.register("t", jt)
    assert j.sql_tsv(q) == want


def test_string_dictionary_merge_across_parts(tmp_path):
    store = TableStore(str(tmp_path / "t"), device="cpu")
    for s_, v in ((["a", "b", "a"], [1, 2, 3]), (["c", "b"], [4, 5])):
        store.insert(Table.from_dict({"s": s_, "v": np.array(
            v, dtype=np.int64)}, device="cpu"))
    loaded = store.load()
    assert loaded["s"].to_python() == ["a", "b", "a", "c", "b"]
    s = myscaledb_tpu_torch.connect(device="cpu")
    s.register("t", loaded)
    assert s.sql("SELECT sum(v) FROM t WHERE s = 'b'").to_rows()[0][0] == 7


@pytest.mark.parametrize("rep", range(20))
def test_background_merge_with_concurrent_inserts(tmp_path, rep):
    """Background compaction runs off the insert path; inserts and loads
    during the merge stay consistent.  Run 20 times: the JAX package's
    test of it fails now and then under xdist (ROADMAP section 3)."""
    ex = BackgroundExecutor(threads=1)
    try:
        store = TableStore(str(tmp_path / "t"), device="cpu")

        def batch(i):
            return Table.from_dict({"v": np.arange(i * 10, i * 10 + 10,
                                                   dtype=np.int64)},
                                   device="cpu")
        for i in range(8):
            store.insert(batch(i))
        assert store.maybe_schedule_merge(ex, min_parts=8, max_parts=8)
        for i in range(8, 11):
            store.insert(batch(i))
            got = np.sort(store.load()["v"].to_numpy())
            assert got.tolist() == list(range((i + 1) * 10))
        assert ex.wait_idle(30)
        assert np.sort(store.load()["v"].to_numpy()).tolist() == \
            list(range(110))
        assert len(store.parts()) <= 4     # 8 merged into 1 + 3 new
        assert not store.maybe_schedule_merge(ex, min_parts=8)
    finally:
        ex.shutdown()
