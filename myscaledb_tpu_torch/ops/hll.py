"""HyperLogLog sketch for uniqHLL12 / uniqCombined: the port of
myscaledb_tpu/ops/hll.py.

Reference: src/AggregateFunctions/AggregateFunctionUniq.h (uniqHLL12 =
HyperLogLogWithSmallSetOptimization<.., 2^12 registers>) and
uniqCombined.h (exact small set below a threshold, HLL above).  A
re-derivation from the published HyperLogLog algorithm (Flajolet et al.):
registers live in a dense (G, 4096) int32 tensor updated by one
scatter-max, and merge with an elementwise maximum.

The 64-bit hashes are int64 tensors holding the uint64 bits (wrapping
multiply and add, logical shifts masked: ops/hash.py), so registers are
the JAX package's bit for bit.  Estimates are approximate by design (the
reference's are too); uniq/uniqExact/countDistinct stay exact.
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.hash import _shr64, _to_i64_bits, popcount64

M_BITS = 12
M = 1 << M_BITS                  # 4096 registers
_ALPHA = 0.7213 / (1.0 + 1.079 / M)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer — a public-domain 64-bit mixer — over int64
    bit patterns."""
    x = x.to(torch.int64) + _to_i64_bits(0x9E3779B97F4A7C15)
    x = (x ^ _shr64(x, 30)) * _to_i64_bits(0xBF58476D1CE4E5B9)
    x = (x ^ _shr64(x, 27)) * _to_i64_bits(0x94D049BB133111EB)
    return x ^ _shr64(x, 31)


def _rho52(w: torch.Tensor) -> torch.Tensor:
    """Position (1-based) of the first set bit in the low 52 bits of w,
    scanning from the MSB of that 52-bit window; 53 when all-zero."""
    w = w & ((1 << 52) - 1)
    # smear the leading bit downward, popcount gives bit-length
    for s in (1, 2, 4, 8, 16, 32):
        w = w | (w >> s)             # w >= 0 here: the shift is logical
    return (53 - popcount64(w)).to(torch.int32)


def hll_registers(h64: torch.Tensor, gid: torch.Tensor, mask: torch.Tensor,
                  num_groups: int) -> torch.Tensor:
    """(G, M) int32 register tensor from 64-bit hashed keys.

    bucket = top 12 hash bits, rho over the remaining 52.  One scatter-max
    (masked rows land in a spill slot that is dropped).
    """
    bucket = _shr64(h64, 64 - M_BITS)
    tgt = torch.where(mask.to(torch.bool), gid.to(torch.int64) * M + bucket,
                      num_groups * M)
    regs = torch.zeros(num_groups * M + 1, dtype=torch.int32,
                       device=h64.device)
    regs.scatter_reduce_(0, tgt, _rho52(h64), "amax")
    return regs[:num_groups * M].reshape(num_groups, M)


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """HLL estimate per group from (G, M) registers, with the standard
    small-range linear-counting correction (no large-range correction is
    needed at 64-bit hashes)."""
    r = regs.to(torch.float64)
    z = torch.sum(torch.pow(2.0, -r), dim=-1)
    e = _ALPHA * M * M / z
    v = torch.sum(regs == 0, dim=-1).to(torch.float64)
    small = torch.where(v > 0, M * torch.log(torch.where(v > 0, M / v, 1.0)),
                        e)
    est = torch.where(e <= 2.5 * M, small, e)
    return torch.round(est).to(torch.int64)


def hash_key_columns(cols) -> torch.Tensor:
    """Combine one or more integer-encoded key columns into one 64-bit hash
    per row (splitmix64 chain).  A 64-bit column hashes its bits, a
    narrower one its value widened (the JAX package's astype(uint64)).
    NULL handling is the caller's: fold row validity into the mask passed
    to hll_registers (uniq skips NULLs, matching the reference)."""
    h = None
    for c in cols:
        if c.dtype == torch.bool:
            c = c.to(torch.int32)
        x = splitmix64(c.to(torch.int64))
        h = x if h is None else splitmix64(h ^ x)
    return h

