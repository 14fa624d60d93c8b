"""Immutable on-disk parts: the port of myscaledb_tpu/storage/part.py
(reference: src/Storages/MergeTree data parts, IMergeTreeDataPart.h — Wide
format: one file per column + checksums + count.txt + minmax indexes,
committed by directory rename).

Part layout (the JAX package's, byte for byte for the same columns and
codecs, so a part one package writes the other reads):
    <table>/part_<seq>_<rows>/
        meta.json        schema, row count, codecs, per-granule marks,
                         per-block zone maps, sort key
        <col>.bin        framed compressed column data (codecs.py)
        <col>.null.bin   validity of a Nullable column
        <col>.dict.json  dictionary values (STRING columns)

``write_part`` takes a Table of device tensors: each column is copied to the
host once, in its logical type's numpy dtype (UInt16/32 columns, stored
widened on the device, are written narrow, as the JAX package writes them),
and its zone map is taken on the device, so only the per-block minima and
maxima cross to the host for it.  ``read_part`` uploads each column once.

Writes go to a tmp_ directory renamed into place on success (the
reference's tmp_-prefix commit protocol, MergeTreeDataWriter.cpp
writeTempPart -> rename)."""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from myscaledb_tpu_torch.core.dictionary import StringDictionary
from myscaledb_tpu_torch.core.table import (BLOCK_ROWS, Column, Table,
                                            ZoneMap, to_tensor)
from myscaledb_tpu_torch.core.types import DataType, Field, physical_dtype
from myscaledb_tpu_torch.storage import codecs

# rows per on-disk granule: the mark-addressable read unit (reference:
# index_granularity + .mrk files mapping granule -> compressed offset,
# MergeTreeIndexGranularity.h).  The zone-map block, so a pruned block maps
# 1:1 to a granule read.
GRANULE_ROWS = BLOCK_ROWS


class PartError(RuntimeError):
    pass


_POOL = None
_POOL_LOCK = threading.Lock()
_IN_POOL = threading.local()


def _mark_pool_thread() -> None:
    _IN_POOL.worker = True


def parallel_map(fn, items: list) -> list:
    """fn over items on one shared thread pool, the results in order, so
    the bytes are the serial loop's: zlib, zstd, the native codec, the
    parsers and the row assembler release the interpreter lock, so a
    part's granules and a file's columns or row chunks work in parallel.
    A call from one of the pool's own threads runs serially: waiting on
    the pool from inside it could leave no thread to do the work."""
    global _POOL
    if len(items) < 2 or getattr(_IN_POOL, "worker", False):
        return [fn(x) for x in items]
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(os.cpu_count() or 1,
                                       thread_name_prefix="msdb-parallel",
                                       initializer=_mark_pool_thread)
    return list(_POOL.map(fn, items))


def _host_array(c: Column) -> np.ndarray:
    """The column's data on the host in the dtype the JAX package stores
    it in."""
    arr = c.data if c.is_host else c.data.cpu().numpy()
    if c.dtype.is_numeric or c.dtype in (DataType.DATE, DataType.DATETIME):
        arr = arr.astype(physical_dtype(c.dtype), copy=False)
    return np.ascontiguousarray(arr)


def write_part(dir_path: str, table: Table, sort_key: list[str] | None = None,
               codec_overrides: dict | None = None) -> str:
    """Write a Table as one immutable part directory; returns the final
    path."""
    codec_overrides = codec_overrides or {}
    for c in table.columns.values():
        if c.offsets is not None:
            # the JAX package writes an ARRAY column's elements without
            # its offsets, which reads back as a column of another length
            raise PartError(f"ARRAY column {c.name!r} cannot be written to "
                            "a part")
    parent = os.path.dirname(dir_path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, "tmp_" + os.path.basename(dir_path) + "_" +
                       uuid.uuid4().hex[:8])
    os.makedirs(tmp)
    try:
        meta = {"rows": table.n_rows, "columns": [], "sort_key": sort_key or [],
                "granule_rows": GRANULE_ROWS}
        for c in table.columns.values():
            arr = _host_array(c)
            codec = codec_overrides.get(c.name, codecs.default_codec(arr.dtype))
            # granule-framed column file: one compressed frame per
            # GRANULE_ROWS rows + a marks table of (byte offset, rows) so a
            # range read decompresses only the covering granules
            starts = list(range(0, max(arr.shape[0], 1), GRANULE_ROWS))
            frames = parallel_map(
                lambda g0, a=arr, k=codec: codecs.encode(
                    np.ascontiguousarray(a[g0:g0 + GRANULE_ROWS]), k),
                starts)
            marks, off = [], 0
            for g0, fbuf in zip(starts, frames):
                marks.append([off, int(arr[g0:g0 + GRANULE_ROWS].shape[0])])
                off += len(fbuf)
            buf = b"".join(frames)
            with open(os.path.join(tmp, f"{c.name}.bin"), "wb") as f:
                f.write(buf)
            colmeta = {
                "name": c.name,
                "type": c.dtype.value,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "codec": codec,
                "bytes": len(buf),
                "marks": marks,
                "nullable": c.valid is not None,
                "vector_dim": c.field.vector_dim,
            }
            if c.valid is not None:
                valid = c.valid if isinstance(c.valid, np.ndarray) \
                    else c.valid.cpu().numpy()
                with open(os.path.join(tmp, f"{c.name}.null.bin"), "wb") as f:
                    f.write(codecs.encode(valid, "zlib"))
            if c.dictionary is not None:
                with open(os.path.join(tmp, f"{c.name}.dict.json"), "w") as f:
                    json.dump(c.dictionary.values, f)
            if arr.ndim == 1 and c.dtype.is_numeric:
                zm = ZoneMap.build(arr) if c.is_host else \
                    ZoneMap.build_device(c.data, arr.dtype)
                colmeta["zonemap"] = {"mins": zm.mins.tolist(),
                                      "maxs": zm.maxs.tolist()}
            meta["columns"].append(colmeta)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(dir_path):
            raise PartError(f"part already exists: {dir_path}")
        os.rename(tmp, dir_path)
        return dir_path
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_frames(path: str, cm: dict, g0: int, g1: int) -> np.ndarray:
    """Granules g0..g1-1 of one column file, decoded and stacked."""
    marks = cm["marks"]
    tail = cm["shape"][1:]
    row_elems = int(np.prod(tail)) if tail else 1
    if g1 <= g0:
        return np.zeros([0] + tail, dtype=np.dtype(cm["dtype"]))
    base = marks[g0][0]
    stop = marks[g1][0] if g1 < len(marks) else cm["bytes"]
    with open(path, "rb") as f:
        f.seek(base)
        raw = memoryview(f.read(stop - base))

    def granule(g):
        off, nrows = marks[g]
        end = marks[g + 1][0] if g + 1 < len(marks) else cm["bytes"]
        return codecs.decode(bytes(raw[off - base:end - base]), cm["dtype"],
                             nrows * row_elems).reshape([nrows] + tail)

    pieces = parallel_map(granule, list(range(g0, g1)))
    if not pieces:
        return np.zeros([0] + tail, dtype=np.dtype(cm["dtype"]))
    return np.concatenate(pieces) if len(pieces) > 1 else pieces[0]


def read_part(dir_path: str, columns: list[str] | None = None,
              row_range: tuple[int, int] | None = None, *,
              device) -> Table:
    """Load a part into a Table on ``device``, each column uploaded once.

    row_range=(start, stop) reads ONLY the granules covering that row span
    (mark-addressed ranged read — MergeTreeRangeReader's read unit), then
    trims to the exact rows; zone maps come from meta.json for whole-part
    reads (they are part-aligned).  Parts written before the marks format
    load whole and slice."""
    with open(os.path.join(dir_path, "meta.json")) as f:
        meta = json.load(f)
    cols = []
    g_rows = meta.get("granule_rows", 0)
    for cm in meta["columns"]:
        if columns is not None and cm["name"] not in columns:
            continue
        path = os.path.join(dir_path, f"{cm['name']}.bin")
        marks = cm.get("marks")
        if marks and row_range is not None and g_rows:
            start, stop = row_range
            g0 = max(0, start // g_rows)
            g1 = min(len(marks), -(-stop // g_rows)) if stop > 0 else 0
            arr = _read_frames(path, cm, g0, g1)
            lo = start - g0 * g_rows
            arr = arr[max(lo, 0):lo + (stop - start)]
        elif marks:
            arr = _read_frames(path, cm, 0, len(marks))
            if arr.shape[0] == 0:
                arr = np.zeros(cm["shape"], dtype=np.dtype(cm["dtype"]))
        else:
            with open(path, "rb") as f:
                buf = f.read()
            arr = codecs.decode(buf, cm["dtype"], int(np.prod(cm["shape"]))
                                ).reshape(cm["shape"])
            if row_range is not None:
                arr = arr[row_range[0]:row_range[1]]
        valid = None
        if cm["nullable"]:
            with open(os.path.join(dir_path, f"{cm['name']}.null.bin"),
                      "rb") as f:
                valid = codecs.decode(f.read(), "bool", meta["rows"])
            if row_range is not None:
                valid = valid[row_range[0]:row_range[1]]
        dictionary = None
        dpath = os.path.join(dir_path, f"{cm['name']}.dict.json")
        if os.path.exists(dpath):
            with open(dpath) as f:
                dictionary = StringDictionary(json.load(f))
        dt = DataType(cm["type"]) if cm["type"] in \
            [t.value for t in DataType] else DataType.INT64
        fld = Field(cm["name"], dt, nullable=cm["nullable"],
                    vector_dim=cm.get("vector_dim", 0))
        zm = None
        if "zonemap" in cm and row_range is None:
            zm = ZoneMap(np.asarray(cm["zonemap"]["mins"]),
                         np.asarray(cm["zonemap"]["maxs"]))
        cols.append(Column(fld, to_tensor(arr, device),
                           to_tensor(valid, device) if valid is not None
                           else None, dictionary, zm))
    return Table(cols)


def part_rows(dir_path: str) -> int:
    with open(os.path.join(dir_path, "meta.json")) as f:
        return json.load(f)["rows"]
