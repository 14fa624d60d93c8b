"""ctypes bindings for the native host library: the port of
myscaledb_tpu/native.py, binding this package's copy of the source
(``csrc/host/msdb_host.cpp``), which ``ops/kernels/build.py`` compiles at
first use into ``_build/``.

Dictionary encoding, corpus tokenization, the LZ block codec of on-disk
parts and the file formats' column work (typed text parsers, the CSV
splitter, the JSONEachRow and RowBinary scanners and the row assembler of
the writers, runtime/formats.py) run in C++.  ``load()`` builds the
library or raises: there is no Python fallback.  The JAX module's
partition hashing (``msdb_partition32``) has no caller there: a
distributed INSERT hashes its shard key on the device, in both packages
(parallel/dist_table.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    from myscaledb_tpu_torch.ops.kernels.build import host_library
    lib = ctypes.CDLL(str(host_library()))
    c = ctypes
    i64, i64p, i32p = c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int32)
    charp, voidp = c.c_char_p, c.c_void_p
    lib.msdb_dict_encode.argtypes = [charp, i64p, i64, charp, i64p, i64]
    lib.msdb_dict_encode.restype = voidp
    lib.msdb_dict_result_n_uniq.argtypes = [voidp]
    lib.msdb_dict_result_n_uniq.restype = i64
    lib.msdb_dict_result_uniq_bytes.argtypes = [voidp]
    lib.msdb_dict_result_uniq_bytes.restype = i64
    lib.msdb_dict_result_copy.argtypes = [voidp, i32p, c.c_char_p, i64p]
    lib.msdb_dict_result_free.argtypes = [voidp]
    lib.msdb_tokenize_corpus.argtypes = [charp, i64p, i64]
    lib.msdb_tokenize_corpus.restype = voidp
    lib.msdb_tok_n_tokens.argtypes = [voidp]
    lib.msdb_tok_n_tokens.restype = i64
    lib.msdb_tok_n_vocab.argtypes = [voidp]
    lib.msdb_tok_n_vocab.restype = i64
    lib.msdb_tok_vocab_bytes.argtypes = [voidp]
    lib.msdb_tok_vocab_bytes.restype = i64
    lib.msdb_tok_copy.argtypes = [voidp, i32p, i32p, c.c_char_p, i64p]
    lib.msdb_tok_free.argtypes = [voidp]
    lib.msdb_lz_compress_bound.argtypes = [i64]
    lib.msdb_lz_compress_bound.restype = i64
    lib.msdb_lz_compress.argtypes = [charp, i64, charp]
    lib.msdb_lz_compress.restype = i64
    lib.msdb_lz_decompress.argtypes = [charp, i64, charp, i64]
    lib.msdb_lz_decompress.restype = i64
    vp = c.c_void_p
    for name in ("int64", "float32", "float64", "date", "datetime"):
        f = getattr(lib, f"msdb_parse_{name}_spans")
        f.argtypes = [vp, vp, vp, i64, vp]
        f.restype = i64
    for name in ("int64", "float32"):
        f = getattr(lib, f"msdb_parse_{name}_column")
        f.argtypes = [vp, vp, i64, vp]
        f.restype = i64
    lib.msdb_dict_encode_spans.argtypes = [vp, vp, vp, i64]
    lib.msdb_dict_encode_spans.restype = voidp
    lib.msdb_csv_split.argtypes = [vp, i64, c.c_char, vp, vp, i64, vp, i64]
    lib.msdb_csv_split.restype = i64
    lib.msdb_format_rows.argtypes = [i64, i64, i64, vp, vp, vp, vp, vp, vp,
                                     vp, vp, vp]
    lib.msdb_format_rows.restype = i64
    lib.msdb_rowbinary_scan.argtypes = [vp, i64, i64, i64, vp, vp, i64, vp,
                                        vp, vp, vp]
    lib.msdb_rowbinary_scan.restype = i64
    lib.msdb_json_scan.argtypes = [vp, i64, i64, vp, vp, i64, vp, vp, vp, vp]
    lib.msdb_json_scan.restype = i64
    _lib = lib
    return lib


def _concat_strings(strings) -> tuple[bytes, np.ndarray]:
    bs = [(s or "").encode() for s in strings]
    offsets = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bs], out=offsets[1:])
    return b"".join(bs), offsets


def dict_encode(strings, seed_values: Optional[list] = None):
    """Encode strings to int32 ids.  Returns (ids, all_values list) where
    all_values extends seed_values with newly seen strings in order."""
    lib = load()
    seed_values = seed_values or []
    data, offsets = _concat_strings(strings)
    sdata, soffsets = _concat_strings(seed_values)
    h = lib.msdb_dict_encode(
        data, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(strings), sdata,
        soffsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seed_values))
    try:
        n_uniq = lib.msdb_dict_result_n_uniq(h)
        nbytes = lib.msdb_dict_result_uniq_bytes(h)
        ids = np.empty(len(strings), dtype=np.int32)
        ubytes = ctypes.create_string_buffer(max(nbytes, 1))
        uoffsets = np.empty(n_uniq + 1, dtype=np.int64)
        lib.msdb_dict_result_copy(
            h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ubytes,
            uoffsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        raw = ubytes.raw[:nbytes]
        values = [raw[uoffsets[i]:uoffsets[i + 1]].decode()
                  for i in range(n_uniq)]
        return ids, values
    finally:
        lib.msdb_dict_result_free(h)


def tokenize_corpus(docs):
    """Tokenize all docs at once.  Returns (term_ids, doc_ids, vocab list)."""
    lib = load()
    data, offsets = _concat_strings(docs)
    h = lib.msdb_tokenize_corpus(
        data, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(docs))
    try:
        nt = lib.msdb_tok_n_tokens(h)
        nv = lib.msdb_tok_n_vocab(h)
        nbytes = lib.msdb_tok_vocab_bytes(h)
        term_ids = np.empty(nt, dtype=np.int32)
        doc_ids = np.empty(nt, dtype=np.int32)
        vbytes = ctypes.create_string_buffer(max(nbytes, 1))
        voffsets = np.empty(nv + 1, dtype=np.int64)
        lib.msdb_tok_copy(
            h, term_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vbytes, voffsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        raw = vbytes.raw[:nbytes]
        vocab = [raw[voffsets[i]:voffsets[i + 1]].decode()
                 for i in range(nv)]
        return term_ids, doc_ids, vocab
    finally:
        lib.msdb_tok_free(h)



def lz_compress(data: bytes) -> bytes:
    """One "msdb-lz" frame payload, byte for byte the JAX library's."""
    lib = load()
    out = ctypes.create_string_buffer(lib.msdb_lz_compress_bound(len(data)))
    n = lib.msdb_lz_compress(data, len(data), out)
    return out.raw[:n]


def lz_decompress(data: bytes, raw_size: int) -> bytes:
    """Inverse of ``lz_compress``; raises on a frame that does not decode
    to exactly ``raw_size`` bytes."""
    lib = load()
    out = ctypes.create_string_buffer(max(raw_size, 1))
    n = lib.msdb_lz_decompress(data, len(data), out, raw_size)
    if n != raw_size:
        raise ValueError(f"msdb-lz decompression error (got {n}, "
                         f"want {raw_size})")
    return out.raw[:raw_size]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _ptrs(arrays) -> ctypes.Array:
    """A C array of the arrays' data pointers (None -> NULL)."""
    return (ctypes.c_void_p * max(len(arrays), 1))(
        *[None if a is None else a.ctypes.data for a in arrays])


def _column(strings, fn: str, dtype) -> np.ndarray:
    lib = load()
    data, offsets = _concat_strings(strings)
    buf = np.frombuffer(data, dtype=np.uint8) if data else \
        np.zeros(1, dtype=np.uint8)
    out = np.empty(len(strings), dtype=dtype)
    n = getattr(lib, f"msdb_parse_{fn}_column")(_ptr(buf), _ptr(offsets),
                                                len(strings), _ptr(out))
    if n != len(strings):
        label = "Int64" if fn == "int64" else "Float32"
        raise ValueError(f"cannot parse {strings[n]!r} as {label} (row {n})")
    return out


def parse_int64(strings) -> np.ndarray:
    """The JAX library's typed Int64 parse of a list of strings."""
    return _column(strings, "int64", np.int64)


def parse_float32(strings) -> np.ndarray:
    """The JAX library's typed Float32 parse of a list of strings."""
    return _column(strings, "float32", np.float32)


_SPAN_DTYPES = {"int64": np.int64, "float32": np.float32,
                "float64": np.float64, "date": np.int32,
                "datetime": np.int64}


def parse_spans(kind: str, buf: np.ndarray, starts: np.ndarray,
                ends: np.ndarray) -> tuple[np.ndarray, int]:
    """Parse the fields buf[starts[i]:ends[i]] as ``kind`` (int64,
    float32, float64, date, datetime).  Returns (values, n parsed): where
    n < len(starts), field n is the first the parser does not take."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out = np.empty(len(starts), dtype=_SPAN_DTYPES[kind])
    n = getattr(load(), f"msdb_parse_{kind}_spans")(
        _ptr(buf), _ptr(starts), _ptr(ends), len(starts), _ptr(out))
    return out, int(n)


def dict_encode_spans(buf: np.ndarray, starts: np.ndarray,
                      ends: np.ndarray) -> tuple[np.ndarray, list]:
    """Dictionary-encode the fields buf[starts[i]:ends[i]] (UTF-8) in
    order of first appearance; a negative start is NULL (id -1).  Returns
    (int32 ids, the distinct values)."""
    lib = load()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    h = lib.msdb_dict_encode_spans(_ptr(buf), _ptr(starts), _ptr(ends),
                                   len(starts))
    try:
        n_uniq = lib.msdb_dict_result_n_uniq(h)
        nbytes = lib.msdb_dict_result_uniq_bytes(h)
        ids = np.empty(len(starts), dtype=np.int32)
        ubytes = ctypes.create_string_buffer(max(nbytes, 1))
        uoffsets = np.empty(n_uniq + 1, dtype=np.int64)
        lib.msdb_dict_result_copy(
            h, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ubytes,
            uoffsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        raw = ubytes.raw[:nbytes]
        values = [raw[uoffsets[i]:uoffsets[i + 1]].decode()
                  for i in range(n_uniq)]
        return ids, values
    finally:
        lib.msdb_dict_result_free(h)


def csv_split(buf: np.ndarray, delimiter: str):
    """Split a CSV/TSV buffer (uint8) into fields as Python's csv.reader
    does.  Returns (field bytes, field offsets (f + 1,), record first
    fields (r + 1,))."""
    nl = int(np.count_nonzero(buf == 10)) + int(np.count_nonzero(buf == 13))
    nd = int(np.count_nonzero(buf == ord(delimiter)))
    out = np.empty(max(len(buf), 1), dtype=np.uint8)
    field_cap = nl + nd + 3
    rec_cap = nl + 3
    field_offs = np.empty(field_cap, dtype=np.int64)
    rec_first = np.empty(rec_cap, dtype=np.int64)
    nr = load().msdb_csv_split(_ptr(buf), len(buf), delimiter.encode(),
                               _ptr(out), _ptr(field_offs), field_cap,
                               _ptr(rec_first), rec_cap)
    if nr < 0:
        raise ValueError("CSV split: capacity exceeded")
    rec_first = rec_first[:nr + 1]
    return out, field_offs[:int(rec_first[-1]) + 1], rec_first


FK_I64, FK_U64, FK_DICT, FK_BLOB, FK_DATE, FK_DATETIME, FK_RAW = range(7)


def format_rows(cols: list, row_end: bytes, r0: int, r1: int) -> bytes:
    """Assemble rows [r0, r1) of a row format.  Each column is a dict:
    kind (FK_*), data (numpy), width (FK_RAW), blob + offs (FK_DICT /
    FK_BLOB), valid (bool numpy or None) and lead / pre / post / null
    (bytes)."""
    lib = load()
    nc = len(cols)
    kinds = np.asarray([c["kind"] for c in cols], dtype=np.int32)
    widths = np.asarray([c.get("width", 0) for c in cols], dtype=np.int64)
    texts = []
    for c in cols:
        texts += [c.get("lead", b""), c.get("pre", b""), c.get("post", b""),
                  c.get("null", b"")]
    texts.append(row_end)
    text_offs = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in texts], out=text_offs[1:])
    tbuf = np.frombuffer(b"".join(texts) or b"\0", dtype=np.uint8)
    valid = [None if c.get("valid") is None else
             np.ascontiguousarray(c["valid"], dtype=np.uint8) for c in cols]
    args = [nc, _ptr(kinds), _ptrs([c.get("data") for c in cols]),
            _ptr(widths), _ptrs([c.get("blob") for c in cols]),
            _ptrs([c.get("offs") for c in cols]), _ptrs(valid), _ptr(tbuf),
            _ptr(text_offs)]
    size = lib.msdb_format_rows(r0, r1, *args, None)
    if size < 0:
        raise OverflowError("date value out of range")
    out = np.empty(max(size, 1), dtype=np.uint8)
    lib.msdb_format_rows(r0, r1, *args, _ptr(out))
    return out[:size].tobytes()


def rowbinary_scan(buf: np.ndarray, pos: int, widths: list,
                   nullable: list):
    """Decode RowBinary rows from buf[pos:]: column c is widths[c]
    little-endian bytes, or (width 0) a varint-prefixed string.  Returns
    (rows, fixed (bytes per column or None), string spans ((starts, ends)
    or None), null flags (uint8 or None))."""
    lib = load()
    nc = len(widths)
    w = np.asarray(widths, dtype=np.int64)
    nl = np.asarray(nullable, dtype=np.uint8)
    none = _ptrs([None] * nc)
    n = lib.msdb_rowbinary_scan(_ptr(buf), len(buf), pos, nc, _ptr(w),
                                _ptr(nl), -1, none, none, none, none)
    if n < 0:
        raise ValueError("RowBinary data ends inside a row")
    fixed = [np.empty(max(n * x, 1), dtype=np.uint8) if x else None
             for x in widths]
    st = [None if x else np.empty(max(n, 1), dtype=np.int64) for x in widths]
    en = [None if x else np.empty(max(n, 1), dtype=np.int64) for x in widths]
    nulls = [np.empty(max(n, 1), dtype=np.uint8) if z else None
             for z in nullable]
    lib.msdb_rowbinary_scan(_ptr(buf), len(buf), pos, nc, _ptr(w), _ptr(nl),
                            n, _ptrs(fixed), _ptrs(st), _ptrs(en),
                            _ptrs(nulls))
    return (n, [None if f is None else f[:n * x]
                for f, x in zip(fixed, widths)],
            [None if s is None else (s[:n], e[:n]) for s, e in zip(st, en)],
            [None if z is None else z[:n] for z in nulls])


def json_scan(buf: np.ndarray, names: list):
    """Scan JSONEachRow lines for the columns ``names``.  Returns None
    when a line is beyond the scanner (the caller then reads the file with
    Python's json module), else (rows, out bytes, starts, ends, kinds),
    the last three (rows, len(names))."""
    lib = load()
    nc = len(names)
    enc = [n.encode() for n in names]
    name_offs = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum([len(b) for b in enc], out=name_offs[1:])
    nbuf = np.frombuffer(b"".join(enc) or b"\0", dtype=np.uint8)
    max_rows = int(np.count_nonzero(buf == 10)) + \
        int(np.count_nonzero(buf == 13)) + 1
    out = np.empty(max(len(buf), 1), dtype=np.uint8)
    cells = max(max_rows * nc, 1)
    st = np.empty(cells, dtype=np.int64)
    en = np.empty(cells, dtype=np.int64)
    kinds = np.empty(cells, dtype=np.int8)
    n = lib.msdb_json_scan(_ptr(buf), len(buf), nc, _ptr(nbuf),
                           _ptr(name_offs), max_rows, _ptr(out), _ptr(st),
                           _ptr(en), _ptr(kinds))
    if n < 0:
        return None
    shape = (n, nc)
    return (n, out, st[:n * nc].reshape(shape), en[:n * nc].reshape(shape),
            kinds[:n * nc].reshape(shape))
