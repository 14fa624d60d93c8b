"""ctypes bindings for the native host library: the port of
myscaledb_tpu/native.py, binding this package's copy of the source
(``csrc/host/msdb_host.cpp``), which ``ops/kernels/build.py`` compiles at
first use into ``_build/``.

Dictionary encoding, corpus tokenization and the LZ block codec of
on-disk parts run in C++.  ``load()`` builds the library or raises: there
is no Python fallback.  The JAX module's partition hashing and CSV parsing
come with the slices that call them.
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
