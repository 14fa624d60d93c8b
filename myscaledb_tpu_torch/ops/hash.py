"""Integer hashing on the device: the port of myscaledb_tpu/ops/hash.py.

The reference dispatches to cityhash/xxhash and specialized integer hash
tables (src/Common/HashTable/Hash.h: intHash32/intHash64, CRC-based).  The
engine keeps two families, in plain integer tensor ops:

* ``hash32`` — murmur3 finalizer (avalanche) for 32-bit keys
* ``hash64`` — splitmix64 finalizer for 64-bit keys (folded to 32 bits)

Both are used for radix partitioning (shard/bucket = hash & (P-1)) and for
open-addressing table slots.  They only need avalanche quality, not
cryptographic strength — same contract as the reference's intHash32.

torch has no uint32/uint64 arithmetic, so the 32-bit hashes are computed in
int64 lanes masked to 32 bits and returned as int64 holding the uint32
value; the 64-bit one works on int64 bit patterns, whose wrapping multiply
and logical shifts (an arithmetic shift masked to the shifted-in width)
give the uint64 results bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _to_i64_bits(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _shr64(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def hash32(x) -> torch.Tensor:
    """Murmur3 fmix32 over 32-bit lanes; returns the uint32 values as
    int64.  int64 input takes ``hash64``, as int64/uint64 input does in
    the JAX package; a UInt32 column, stored widened to int64, must be
    passed as its 32-bit values to get the JAX package's ``hash32``."""
    h = torch.as_tensor(x)
    if h.dtype == torch.int64:
        return hash64(h)
    h = h.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return h


def hash64(x) -> torch.Tensor:
    """splitmix64 finalizer folded to uint32 (as int64)."""
    h = torch.as_tensor(x).to(torch.int64)
    h = (h ^ _shr64(h, 30)) * _to_i64_bits(0xBF58476D1CE4E5B9)
    h = (h ^ _shr64(h, 27)) * _to_i64_bits(0x94D049BB133111EB)
    h = h ^ _shr64(h, 31)
    return (h ^ _shr64(h, 32)) & _M32


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Combine two uint32 hashes (boost-style)."""
    a = a.to(torch.int64) & _M32
    b = b.to(torch.int64) & _M32
    return (a ^ ((b + 0x9E3779B9 + ((a << 6) & _M32) + (a >> 2)) & _M32)) \
        & _M32


def hash_columns(cols) -> torch.Tensor:
    """Hash a list of integer key columns into one uint32 (as int64) per
    row."""
    h = hash32(cols[0])
    for c in cols[1:]:
        h = hash_combine(h, hash32(c))
    return h


def float_bits_key(x: torch.Tensor) -> torch.Tensor:
    """Canonical integer key for float grouping/joining: bit pattern with
    -0.0 normalized to +0.0 (the reference hashes float bits the same
    way)."""
    f = torch.as_tensor(x).to(torch.float32)
    f = torch.where(f == 0.0, torch.zeros((), dtype=torch.float32,
                                          device=f.device), f)
    return f.view(torch.int32)


# host-side mirror (numpy) for oracle tests
def np_hash32(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):   # uint32 wrap-around is the algorithm
        h = np.asarray(x).astype(np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h
