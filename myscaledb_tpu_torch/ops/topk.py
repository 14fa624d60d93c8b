"""Exact k-selection primitives: the port of myscaledb_tpu/ops/topk.py
(``block_topk_min``, ``merge_sorted_topk``).

Tie semantics (the engine's contract): equal scores order by ascending row
id.  ``jax.lax.top_k`` gives ties to the lowest index and orders floats by
their total order (-0.0 before 0.0); ``torch.topk`` guarantees neither (on
the CPU, ``torch.topk(torch.zeros(8), 3, largest=False)`` returns ids
[6, 5, 4]).  So selection here is a stable sort of a total-order integer
key, sliced.  The JAX merge is a two-key ``lax.sort((s, i), num_keys=2)``,
which compares floats by value (-0.0 == 0.0): here it is a stable sort by
id followed by a stable sort by score.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")
POS_INF = float("inf")


def total_order_key(s: torch.Tensor) -> torch.Tensor:
    """int32 key whose ascending order is the IEEE total order of the
    float32 values: -NaN < -inf < ... < -0.0 < 0.0 < ... < inf < NaN."""
    i = s.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def stable_argsort_min(s: torch.Tensor) -> torch.Tensor:
    """Indices that order the last axis ascending, ties by lowest index
    (the order ``lax.top_k(-s, ...)`` selects in)."""
    return torch.sort(total_order_key(s), dim=-1, stable=True).indices


def block_topk_min(s: torch.Tensor, k: int):
    """Top-k smallest along the last axis.

    Returns (vals, idx): vals ascending; ties resolved to the lowest index.
    """
    idx = stable_argsort_min(s)[..., :k]
    return torch.gather(s, -1, idx), idx


def sort_by_score_then_id(s: torch.Tensor, i: torch.Tensor):
    """Lexicographic (score asc, id asc) sort along the last axis — the
    ``lax.sort((s, i), num_keys=2)`` of the JAX package."""
    by_id = torch.sort(i, dim=-1, stable=True).indices
    s = torch.gather(s, -1, by_id)
    i = torch.gather(i, -1, by_id)
    by_s = torch.sort(s, dim=-1, stable=True).indices
    return torch.gather(s, -1, by_s), torch.gather(i, -1, by_s)


def merge_sorted_topk(sa, ia, sb, ib, k: int):
    """Merge two (…, ka) / (…, kb) candidate sets into the k best.

    Both inputs need not be sorted; the merge sorts the union
    lexicographically by (score asc, id asc) and keeps the first k.
    """
    s = torch.cat([sa, sb], dim=-1)
    i = torch.cat([ia, ib], dim=-1)
    s_sorted, i_sorted = sort_by_score_then_id(s, i)
    return s_sorted[..., :k], i_sorted[..., :k]
