"""ORDER BY / ORDER BY ... LIMIT: the port of myscaledb_tpu/ops/sort.py
(``SortKey``, ``encode_sort_key``, ``sort_permutation``,
``topn_permutation`` with its segment-max prefilter, and
``streaming_topn_permutation``).

Every key column is encoded into a signed integer whose ascending order is
the requested (ASC/DESC, NULLS LAST/FIRST) order — floats by their bit
pattern, NaN above +inf — and the full permutation comes from stable sorts,
so ties keep ascending row id: the JAX package's ``lax.sort`` with a
trailing iota key.

LIMIT k over one plain key skips the full sort.  The JAX package selects
with ``lax.top_k``, which gives ties to the lowest index; ``torch.topk``
does not (ops/topk.py), so ``_smallest_k`` selects on keys made unique by
their position.  From 2^19 rows on, a prefilter reads the column once into
each 128-row segment's best code; the k best rows lie in the k best
segments by (best code, segment id), and above 2^17 segments a second
level prunes the segment array the same way.  Only the k * 128 rows of the
chosen segments are encoded and cut.  The result is exactly
``sort_permutation(keys)[:k]``.

Here, unlike in the JAX package's codes, smaller is better after the
direction is applied: a DESC key's codes are the bitwise complement of its
ascending codes (which reverses signed order), taken only on the small
arrays — the segment bests and the candidates — never on the column.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import to_tensor
from myscaledb_tpu_torch.ops.topk import total_order_key


class SortKey(NamedTuple):
    # (n,) numeric column; a host numpy array only for a host-resident
    # column on its way to streaming_topn_permutation
    values: Union[torch.Tensor, np.ndarray]
    ascending: bool = True
    valid: Optional[Union[torch.Tensor, np.ndarray]] = None  # None = no nulls
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


def _smallest_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """Positions (k,) int64 of the k smallest entries of the 1-D ``key``,
    in (key, position) order: ``lax.top_k``'s lowest-index tie rule.

    Keys of at most 32 bits are packed with their position into unique
    int64s, so ``torch.topk``'s order is exact.  int64 keys take the k-th
    smallest value as a threshold: every key below it, then the
    lowest-positioned keys equal to it, ordered by a stable sort of the k."""
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=key.device)
    pos = torch.arange(key.shape[0], dtype=torch.int64, device=key.device)
    if key.dtype != torch.int64:
        packed = key.to(torch.int64) * (1 << 32) + pos
        return torch.topk(packed, k, largest=False).values & 0xFFFFFFFF
    kth = torch.topk(key, k, largest=False).values[k - 1]
    below = key < kth
    at = key == kth
    take = below | (at & (torch.cumsum(at, 0) <= k - below.sum()))
    idx = torch.nonzero(take).flatten()
    return idx[torch.sort(key[idx], stable=True).indices]


_SEG = 128          # rows per segment of the prefilter
_SEG_MIN_N = 1 << 19   # below this, one selection over every row


def _segment_rows_best(x2: torch.Tensor, ascending: bool) -> torch.Tensor:
    """Best code of each row of ``x2`` (segments x rows), smaller better.

    A DESC float32 key needs one read: the maximum of the total-order key
    (ops/topk.py) is the int32 view's maximum where that is non-negative,
    and otherwise (every value's sign bit set) the mirror of the view's
    minimum.  Every other key is encoded first, then reduced (integer
    codes are the values themselves, so no pass is added for them)."""
    if x2.dtype == torch.float32 and not ascending:
        lo, hi = torch.aminmax(x2.view(torch.int32), dim=1)
        return ~torch.where(hi >= 0, hi, lo ^ 0x7FFFFFFF)
    code = _ascending_code(x2)
    return code.amin(dim=1) if ascending else ~code.amax(dim=1)


def _segment_best(values: torch.Tensor, ascending: bool) -> torch.Tensor:
    """(ceil(n / 128),) best code of each 128-row segment, smaller better;
    the last segment may be short (no padded copy of the column)."""
    n = values.shape[0]
    nfull = n // _SEG
    parts = []
    if nfull:
        parts.append(_segment_rows_best(
            values[:nfull * _SEG].view(nfull, _SEG), ascending))
    if n > nfull * _SEG:
        parts.append(_segment_rows_best(
            values[nfull * _SEG:].view(1, -1), ascending))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _rows_of(segidx: torch.Tensor) -> torch.Tensor:
    """Row ids (len(segidx) * 128,) of the given segments, in order."""
    lane = torch.arange(_SEG, dtype=torch.int64, device=segidx.device)
    return (segidx[:, None] * _SEG + lane[None, :]).reshape(-1)


def _topn_single_segmented(values: torch.Tensor, k: int,
                           ascending: bool) -> torch.Tensor:
    """Exact top-k of one key through the per-segment best prefilter: the k
    first rows by (code, id) lie in the k best segments by (best code,
    segment id).  Above 2^17 segments a second level takes the k best
    groups of 128 segments first.  Positions past n (the short last
    segment, the padded last group) carry the worst code and the highest
    positions, so they lose every tie and are never chosen."""
    values = values.contiguous()
    n = values.shape[0]
    best = _segment_best(values, ascending)
    nseg = best.shape[0]
    kseg = min(k, nseg)

    if nseg >= (1 << 17) and kseg * _SEG <= nseg:
        n2 = -(-nseg // _SEG)
        sm = torch.full((n2 * _SEG,), torch.iinfo(best.dtype).max,
                        dtype=best.dtype, device=best.device)
        sm[:nseg] = best
        sm2 = sm.view(n2, _SEG)
        sup = torch.sort(_smallest_k(sm2.amin(dim=1), kseg)).values
        seg_cand = sm2[sup].reshape(-1)             # (kseg * 128,)
        segidx = _rows_of(sup)[_smallest_k(seg_cand, kseg)]
    else:
        segidx = _smallest_k(best, kseg)

    segidx = torch.sort(segidx).values   # candidate order == row-id order
    cid = _rows_of(segidx)
    code = _ascending_code(values[cid.clamp(max=n - 1)])
    if not ascending:
        code = ~code
    cand = torch.where(cid < n, code, torch.iinfo(code.dtype).max)
    return cid[_smallest_k(cand, k)]


def topn_permutation(keys: Sequence[SortKey], k: int, n: int) -> torch.Tensor:
    """Top-k permutation (k,) int64 for ORDER BY ... LIMIT k.

    Single plain key -> a selection with the segment prefilter for large n;
    otherwise full sort + slice.
    """
    k = min(k, n)
    if len(keys) == 1 and keys[0].valid is None:
        key = keys[0]
        if n >= _SEG_MIN_N and k * _SEG <= n:
            return _topn_single_segmented(key.values, k, key.ascending)
        return _smallest_k(encode_sort_key(key)[0], k)
    return sort_permutation(keys)[:k]


def _rows_to(a, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a host array or a tensor, as a tensor on
    ``device``."""
    if isinstance(a, np.ndarray):
        return to_tensor(a[lo:hi], device)
    return a[lo:hi].to(device)


def _gather_to(a, rows: torch.Tensor, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        return to_tensor(a[rows.cpu().numpy()], device)
    return a[rows.to(a.device)].to(device)


def streaming_topn_permutation(keys: Sequence[SortKey], k: int, n: int,
                               chunk_rows: int = 8 << 20, *,
                               device) -> torch.Tensor:
    """ORDER BY ... LIMIT k over host-resident columns: stream the sort-key
    columns to ``device`` chunk by chunk, keep each chunk's top-k candidate
    rows, and cut the final k from the candidate union (the external-sort
    analog — MergeSortingTransform.h:29-31 spill + remerge — with host RAM
    as the spill tier; only ``chunk_rows`` rows of a key and ~k * n_chunks
    candidates are ever on the device at once).

    Exact and deterministic: ties broken by global row id ascending, same
    as the resident path.  Returns (k,) int64 global row indices on
    ``device``."""
    k = min(k, n)
    if k == 0 or n == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    cand_parts = []
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        cks = [SortKey(_rows_to(sk.values, s, e, device), sk.ascending,
                       None if sk.valid is None
                       else _rows_to(sk.valid, s, e, device), sk.nulls_last)
               for sk in keys]
        cand_parts.append(topn_permutation(cks, k, e - s) + s)
    cand = torch.cat(cand_parts)
    fks = [SortKey(_gather_to(sk.values, cand, device), sk.ascending,
                   None if sk.valid is None
                   else _gather_to(sk.valid, cand, device), sk.nulls_last)
           for sk in keys]
    # candidates arrive in ascending global row id, so the cut's tie rule
    # (lowest position) is the global-row-id rule
    return cand[topn_permutation(fks, k, len(cand))]
