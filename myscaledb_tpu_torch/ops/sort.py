"""ORDER BY / ORDER BY ... LIMIT: the port of the subset of
myscaledb_tpu/ops/sort.py that the vector slice uses (``SortKey``,
``encode_sort_key``, ``sort_permutation``, ``topn_permutation``).

Every key column is encoded into a signed integer whose ascending order is
the requested (ASC/DESC, NULLS LAST/FIRST) order — floats by their bit
pattern, NaN above +inf — and the permutation comes from stable sorts, so
ties keep ascending row id: the JAX package's ``lax.sort`` with a trailing
iota key, and its ``lax.top_k`` lowest-index tie rule.  (The JAX package's
segment-max prefilter for large single-key LIMITs is an optimization with
the same result; it is not ported.)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from myscaledb_tpu_torch.ops.topk import total_order_key


class SortKey(NamedTuple):
    values: torch.Tensor                 # (n,) numeric column
    ascending: bool = True
    valid: Optional[torch.Tensor] = None  # None = no nulls
    nulls_last: bool = True


def _ascending_code(arr: torch.Tensor) -> torch.Tensor:
    """Map numerics to signed ints preserving ascending order.
    NaNs land above +inf (ClickHouse puts NaN last in ASC order)."""
    if arr.dtype == torch.float64:
        arr = arr.float()               # the engine compares floats at f32
    if arr.dtype == torch.float32:
        return total_order_key(arr)
    if arr.dtype == torch.bool:
        return arr.to(torch.int32)
    if arr.dtype in (torch.int8, torch.int16, torch.int32, torch.int64,
                     torch.uint8):
        return arr
    raise TypeError(f"unsortable dtype {arr.dtype}")


def encode_sort_key(key: SortKey) -> list[torch.Tensor]:
    """Encode one SortKey into ascending operands.  Returns
    [null_rank?, code] — nulls get their own leading operand so they order
    strictly before/after every real value."""
    code = _ascending_code(key.values)
    if not key.ascending:
        code = ~code                    # reverses the order of signed ints
    ops = []
    if key.valid is not None:
        rank_valid, rank_null = (0, 1) if key.nulls_last else (1, 0)
        ops.append(torch.where(key.valid.bool(), rank_valid, rank_null))
    ops.append(code)
    return ops


def sort_permutation(keys: Sequence[SortKey]) -> torch.Tensor:
    """Full-sort permutation (n,) int64; ties by ascending row id
    (stable sorts from the last operand to the first)."""
    operands = []
    for k in keys:
        operands.extend(encode_sort_key(k))
    n = operands[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for op in reversed(operands):
        order = torch.sort(op[perm], stable=True).indices
        perm = perm[order]
    return perm


def topn_permutation(keys: Sequence[SortKey], k: int, n: int) -> torch.Tensor:
    """Top-k permutation (k,) int64 for ORDER BY ... LIMIT k."""
    return sort_permutation(keys)[:min(k, n)]
