"""Data-skipping indexes: per-block set and bloom-filter sidecars, the
port of myscaledb_tpu/storage/skip_index.py (reference: MergeTree skip
indexes, src/Storages/MergeTree/MergeTreeIndexSet.cpp,
MergeTreeIndexBloomFilter.cpp, MergeTreeIndexFullText.cpp) declared as
``INDEX name col TYPE set(N) GRANULARITY g`` in CREATE TABLE and consulted
during range selection.

The unit of skipping is the 64k-row zone-map block (core/table.py
BLOCK_ROWS).  A skip index adds, per block, either

  set(N)        the sorted distinct values of the block (None when the
                block has more than N distinct values — that block can
                never be pruned), supporting =, IN and range terms,
  bloom_filter  an m-bit double-hashed bloom filter over the block's
                values, supporting = and IN (absence is proof), or
  ngrambf_v1 / tokenbf_v1
                a bloom over the n-grams (tokens) of the block's strings,
                pruning LIKE.

The set and value-bloom sidecars of a numeric or String column are built
on the column's device: one sort of (block, value) for the set lists, the
bloom positions by SplitMix64 in int64 bit patterns and one ``torch.unique``
of (block, position) for the words; only the sidecar itself crosses to the
host, where the pruning tests run in numpy as in the JAX package.  The set
lists and bloom words are bit-equal to the JAX package's numpy builds.  The
n-gram blooms hash each dictionary value on the host, as the JAX package
does.  ``sidecar_for`` keeps a sidecar per (table, index, mutation epoch)
in the session's derived-state cache.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from myscaledb_tpu_torch.core.derived import _derived
from myscaledb_tpu_torch.core.table import BLOCK_ROWS
from myscaledb_tpu_torch.core.types import physical_dtype
from myscaledb_tpu_torch.ops.hash import _shr64, _to_i64_bits

# rows of the column whose bloom positions are made in one pass (bounds the
# (rows x k) position tensors on the device)
BLOOM_CHUNK_ROWS = 1 << 24


@dataclass(frozen=True)
class SkipIndexDef:
    """One declared skipping index (system.data_skipping_indices row)."""
    name: str
    column: str
    kind: str              # "set" | "bloom_filter" | "ngrambf" | "tokenbf"
    param: float = 0.0     # set: max distinct values; bloom: fp rate
    granularity: int = 1


# --- set index -------------------------------------------------------------

def build_set_sidecar(data: torch.Tensor, max_values: int, host_dtype,
                      block_rows: int = BLOCK_ROWS) -> list:
    """Per-block sorted distinct values (numpy, ``host_dtype``); None marks
    an over-full block.  One stable sort by value, then by block, on the
    device; the distinct values of the blocks that keep them come to the
    host in one copy."""
    n = int(data.shape[0])
    nblocks = max(1, -(-n // block_rows))
    if n == 0:
        return [np.zeros(0, dtype=host_dtype)]
    dev = data.device
    blk = torch.arange(n, device=dev) // block_rows
    order = torch.sort(data, stable=True).indices
    order = order[torch.sort(blk[order], stable=True).indices]
    v, b = data[order], blk[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (b[1:] != b[:-1]) | (v[1:] != v[:-1])
    counts = torch.bincount(b[first], minlength=nblocks)
    keep_blk = counts <= max_values
    take = first & keep_blk[b]
    vals = v[take].cpu().numpy().astype(host_dtype, copy=False)
    counts_np = counts.cpu().numpy()
    keep_np = keep_blk.cpu().numpy()
    out, pos = [], 0
    for i in range(nblocks):
        if keep_np[i]:
            out.append(vals[pos:pos + counts_np[i]])
            pos += counts_np[i]
        else:
            out.append(None)
    return out


def set_blocks_possible(sidecar: list, op: str, key) -> np.ndarray:
    """Which blocks may contain a row satisfying ``col <op> key``.

    A block is possible iff SOME stored value satisfies the comparison
    (MergeTreeIndexSet's mayBeTrueOnGranule).  Over-full blocks are always
    possible."""
    ok = np.ones(len(sidecar), dtype=bool)
    for b, vals in enumerate(sidecar):
        if vals is None or len(vals) == 0:
            ok[b] = vals is None     # empty block proves emptiness
            continue
        if op == "=":
            i = np.searchsorted(vals, key)
            ok[b] = bool(i < len(vals) and vals[i] == key)
        elif op == "<":
            ok[b] = bool(vals[0] < key)
        elif op == "<=":
            ok[b] = bool(vals[0] <= key)
        elif op == ">":
            ok[b] = bool(vals[-1] > key)
        elif op == ">=":
            ok[b] = bool(vals[-1] >= key)
        else:                        # unknown op: cannot prune
            ok[b] = True
    return ok


def set_blocks_possible_in(sidecar: list, keys) -> np.ndarray:
    """IN-list variant: block possible iff it stores any of the keys."""
    ok = np.zeros(len(sidecar), dtype=bool)
    keys = np.asarray(sorted(keys))
    for b, vals in enumerate(sidecar):
        if vals is None:
            ok[b] = True
            continue
        if len(vals) == 0 or len(keys) == 0:
            continue
        pos = np.searchsorted(vals, keys)
        pos = np.minimum(pos, len(vals) - 1)
        ok[b] = bool((vals[pos] == keys).any())
    return ok


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — a full-avalanche 64-bit mix (public domain
    constant schedule; the reference uses CityHash for the same role)."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def _bloom_geometry(block_rows: int, fp_rate: float) -> tuple[int, int]:
    """(m bits rounded up to a word multiple, k hash functions)."""
    fp_rate = min(max(fp_rate, 1e-6), 0.5)
    m = int(math.ceil(-block_rows * math.log(fp_rate) / (math.log(2) ** 2)))
    m = max(64, (m + 63) // 64 * 64)
    k = max(1, round(m / block_rows * math.log(2)))
    return m, min(k, 8)


def _bloom_positions(keys_u64: np.ndarray, m: int, k: int) -> np.ndarray:
    """(len(keys), k) bit positions via double hashing h1 + i*h2."""
    h1 = _splitmix64(keys_u64)
    h2 = _splitmix64(keys_u64 ^ np.uint64(0xA5A5A5A5A5A5A5A5)) | np.uint64(1)
    i = np.arange(k, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        return ((h1[:, None] + i * h2[:, None]) % np.uint64(m))


def _to_u64_keys(data_np: np.ndarray) -> np.ndarray:
    """Canonical 64-bit key image of a column for hashing.  Integers and
    dictionary ids widen losslessly; floats hash their binary64 image with
    -0.0 folded to +0.0 so 0.0 == -0.0 keeps one image."""
    if data_np.dtype.kind == "f":
        d = data_np.astype(np.float64)
        d = np.where(d == 0.0, 0.0, d)
        return d.view(np.uint64)
    return data_np.astype(np.int64).view(np.uint64)


class BloomSidecar:
    """Per-block bloom filters: ``bits`` is (nblocks, m//64) uint64."""

    __slots__ = ("bits", "m", "k")

    def __init__(self, bits: np.ndarray, m: int, k: int):
        self.bits = bits
        self.m = m
        self.k = k

    def may_contain(self, key_u64: np.ndarray) -> np.ndarray:
        """(nblocks,) bool: block may contain ANY of the given keys."""
        key_u64 = np.atleast_1d(np.asarray(key_u64, dtype=np.uint64))
        if len(key_u64) == 0:
            return np.zeros(self.bits.shape[0], dtype=bool)
        pos = _bloom_positions(key_u64, self.m, self.k)      # (nk, k)
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        # block x key: all k bits set for that key
        present = (self.bits[:, word] & bit[None, :, :]) != 0  # (nb, nk, k)
        return present.all(axis=2).any(axis=1)


_GOLDEN = _to_i64_bits(0x9E3779B97F4A7C15)
_MIX1 = _to_i64_bits(0xBF58476D1CE4E5B9)
_MIX2 = _to_i64_bits(0x94D049BB133111EB)
_SALT = _to_i64_bits(0xA5A5A5A5A5A5A5A5)


def _splitmix64_bits(x: torch.Tensor) -> torch.Tensor:
    """``_splitmix64`` over int64 tensors holding the uint64 bits: int64
    adds and multiplies wrap modulo 2^64 as uint64's do, and the shifts are
    logical."""
    x = x + _GOLDEN
    x = (x ^ _shr64(x, 30)) * _MIX1
    x = (x ^ _shr64(x, 27)) * _MIX2
    return x ^ _shr64(x, 31)


def _umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """The uint64 value of int64 bits ``x`` modulo m (m < 2^62)."""
    r = torch.remainder(x, m)                       # floor mod: [0, m)
    return torch.where(x < 0, torch.remainder(r + (1 << 64) % m, m), r)


def _u64_key_bits(data: torch.Tensor) -> torch.Tensor:
    """``_to_u64_keys`` on the device: floats as their binary64 image
    with -0.0 folded to +0.0, integers and dictionary ids widened."""
    if data.is_floating_point():
        d = data.to(torch.float64)
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
        return d.view(torch.int64)
    return data.to(torch.int64)


def build_bloom_sidecar(data: torch.Tensor, fp_rate: float = 0.025,
                        block_rows: int = BLOCK_ROWS) -> "BloomSidecar":
    """Per-block bloom filters of a column's values, made on its device:
    the k positions h1 + i h2 of every row, one ``torch.unique`` of
    (block, position) per chunk of rows, and the set bits summed into
    their words (distinct bits of a word sum to their OR)."""
    n = int(data.shape[0])
    nblocks = max(1, -(-n // block_rows))
    m, k = _bloom_geometry(min(block_rows, max(n, 1)), fp_rate or 0.025)
    words = m // 64
    dev = data.device
    bits = torch.zeros(nblocks * words, dtype=torch.int64, device=dev)
    steps = torch.arange(k, dtype=torch.int64, device=dev)
    chunk = max(block_rows, BLOOM_CHUNK_ROWS // block_rows * block_rows)
    for r0 in range(0, n, chunk):
        keys = _u64_key_bits(data[r0:r0 + chunk])
        h1 = _splitmix64_bits(keys)
        h2 = _splitmix64_bits(keys ^ _SALT) | 1
        pos = _umod(h1[:, None] + steps[None, :] * h2[:, None], m)
        blk = (torch.arange(r0, r0 + keys.shape[0], device=dev)
               // block_rows)[:, None]
        flat = torch.unique((blk * m + pos).reshape(-1))
        b, p = flat // m, flat % m
        bits.index_add_(0, b * words + (p >> 6),
                        torch.ones_like(p) << (p & 63))
    host = bits.cpu().numpy().view(np.uint64).reshape(nblocks, words)
    return BloomSidecar(host, m, k)


# --- ngram / token bloom (string LIKE pruning) -----------------------------

def ngrams_of(s: str, n: int) -> set:
    b = s.encode("latin-1", "replace")
    return {b[i:i + n] for i in range(len(b) - n + 1)}


_TOKEN_SPLIT = None


def tokens_of(s: str) -> set:
    import re
    global _TOKEN_SPLIT
    if _TOKEN_SPLIT is None:
        _TOKEN_SPLIT = re.compile(r"[0-9A-Za-z_]+")
    return set(t.encode("latin-1", "replace")
               for t in _TOKEN_SPLIT.findall(s))


def _hash_grams(grams) -> np.ndarray:
    import hashlib
    return np.asarray(
        [int.from_bytes(hashlib.blake2b(g, digest_size=8).digest(),
                        "little") for g in sorted(grams)], dtype=np.uint64)


def pattern_required_grams(pattern: str, kind: str, n: int) -> list:
    """Byte-grams a row MUST contain to match LIKE ``pattern`` — the
    pruning key extraction of MergeTreeIndexFullText's
    likeStringToBloomFilter.  ngram: every n-gram of every literal segment
    (position-free, always safe).  token: only tokens strictly INSIDE a
    literal segment (bounded by non-word chars on both sides) — a token
    touching a %%/_ boundary could extend in the data."""
    import re
    # literal segments via the SAME left-to-right escape scan as the
    # evaluator (exec/expr.py _like_to_re): backslash escapes the next
    # char.  A regex split on (?<!\\)[%_] mishandles "\\\\%" (escaped
    # backslash then wildcard) and diverges from the evaluator, wrongly
    # pruning blocks that contain matching rows.
    segs, cur = [], []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            cur.append(pattern[i + 1])
            i += 2
            continue
        if ch in "%_":
            segs.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    segs.append("".join(cur))
    out = set()
    if kind == "ngrambf":
        for seg in segs:
            out |= ngrams_of(seg, n)
    else:
        tok = re.compile(r"[0-9A-Za-z_]+")
        for seg in segs:
            for m in tok.finditer(seg):
                if m.start() > 0 and m.end() < len(seg):
                    out.add(m.group().encode("latin-1", "replace"))
    return sorted(out)


class NgramBloomSidecar:
    """Per-block bloom over the ngram/token set of the block's strings
    (reference: MergeTreeIndexFullText.cpp ngrambf_v1 / tokenbf_v1).
    Pruning semantics differ from the value bloom: a block is possible
    only if ALL required grams may be present."""

    __slots__ = ("bits", "m", "k")

    def __init__(self, bits: np.ndarray, m: int, k: int):
        self.bits = bits
        self.m = m
        self.k = k

    def may_contain_all(self, gram_hashes: np.ndarray) -> np.ndarray:
        """(nblocks,) bool: every gram hash present in the block filter."""
        gram_hashes = np.atleast_1d(np.asarray(gram_hashes, dtype=np.uint64))
        if len(gram_hashes) == 0:
            return np.ones(self.bits.shape[0], dtype=bool)
        pos = _bloom_positions(gram_hashes, self.m, self.k)
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        present = (self.bits[:, word] & bit[None, :, :]) != 0  # (nb, ng, k)
        return present.all(axis=2).all(axis=1)


def build_ngram_sidecar(ids_np: np.ndarray, dictionary, kind: str, n: int,
                        block_rows: int = BLOCK_ROWS) -> NgramBloomSidecar:
    """Grams are computed ONCE per dictionary value, then unioned per block
    over the ids present — dictionary encoding makes the n^2 substring work
    proportional to distinct strings, not rows."""
    values = dictionary.values if dictionary is not None else []
    per_value = []
    for s in values:
        s = "" if s is None else str(s)
        per_value.append(_hash_grams(ngrams_of(s, n) if kind == "ngrambf"
                                     else tokens_of(s)))
    nrows = len(ids_np)
    nblocks = max(1, -(-nrows // block_rows))
    # geometry sized for the expected gram cardinality per block
    est = max((len(h) for h in per_value), default=1)
    m, k = _bloom_geometry(min(block_rows, max(nrows, 1)) * max(est, 1) // 4,
                           0.01)
    bits = np.zeros((nblocks, m // 64), dtype=np.uint64)
    for b in range(nblocks):
        chunk = ids_np[b * block_rows:(b + 1) * block_rows]
        hs = [per_value[i] for i in np.unique(chunk)
              if 0 <= i < len(per_value)]
        if not hs:
            continue
        allh = np.unique(np.concatenate(hs)) if hs else \
            np.zeros(0, dtype=np.uint64)
        if not len(allh):
            continue
        pos = _bloom_positions(allh, m, k).ravel()
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        np.bitwise_or.at(bits[b], word, bit)
    return NgramBloomSidecar(bits, m, k)


# --- session-cached lookup -------------------------------------------------

def build_sidecar(col, idx: SkipIndexDef):
    """The sidecar of one index over one column: a set list, a
    BloomSidecar or an NgramBloomSidecar; None where the column cannot be
    indexed (vector and array columns, an n-gram index on a non-String
    column)."""
    if col.offsets is not None or col.data.ndim != 1:
        return None
    data = col.data if not col.is_host else torch.from_numpy(col.data)
    if idx.kind == "set":
        host_dtype = np.int32 if col.dictionary is not None \
            else physical_dtype(col.dtype)
        return build_set_sidecar(data, int(idx.param) or 100, host_dtype)
    if idx.kind == "bloom_filter":
        return build_bloom_sidecar(data, float(idx.param) or 0.025)
    if idx.kind in ("ngrambf", "tokenbf"):
        if col.dictionary is None:
            return None
        return build_ngram_sidecar(data.cpu().numpy(), col.dictionary,
                                   idx.kind, int(idx.param) or 3)
    return None


def sidecar_for(session, table, column_name: str, idx: SkipIndexDef):
    """Build-or-fetch the sidecar for one (table, index) at the session's
    current mutation epoch (the session's derived-state cache, which drops
    earlier epochs and rebuilds when the column is no longer the one the
    entry was built from)."""
    return _derived(session, ("skip", idx), table.name, table, column_name,
                    lambda col: build_sidecar(col, idx))
