"""Hybrid search fusion: the port of myscaledb_tpu/text/fusion.py
(``_normalized``, ``relative_score_fusion``, ``reciprocal_rank_fusion``),
with the reference's semantics (src/VectorIndex/Utils/HybridSearchUtils.cpp).

RSF (Relative Score Fusion, :212): min-max normalize each candidate list
independently over the candidate set (num_candidates = k * multiple); if
min == max every normalized score is 1.0.  Fused score =
    w * norm(bm25) + (1 - w) * (direction == -1 ? norm(dist) : 1 - norm(dist))
where direction -1 means descending metric (IP).

RRF (Reciprocal Rank Fusion, :164): fused = sum over lists of
    1 / (fusion_k + rank + 1)     (0-based rank, default fusion_k = 60);
missing membership contributes 0.

The lists hold at most k * hybrid_search_top_k_multiple_base candidates
and the executor reads the fused ids on the host, so the fusion runs in
host numpy, vectorized where the JAX package loops over Python dicts.  It
keeps that package's arithmetic exactly: normalization in float32, each
id's contributions added in float64 (the vector's first, then the
text's), the order taken on the float64 sums — (-score, id) — and only
then the cast to float32.  Sorting after the cast would swap two ids whose
sums differ only in float64.
"""

from __future__ import annotations

import numpy as np


def _normalized(scores: np.ndarray) -> np.ndarray:
    if len(scores) == 0:
        return scores
    lo, hi = float(np.min(scores)), float(np.max(scores))
    if hi == lo:
        return np.ones_like(scores, dtype=np.float32)
    return ((scores - lo) / (hi - lo)).astype(np.float32)


def _fused_order(ids: np.ndarray, parts: list) -> tuple:
    """Sum each id's float64 contributions in list order; (ids, f32
    scores) sorted by (-sum, id).  ``parts`` holds (ids, contributions)
    per list, each id at most once in a list."""
    uniq = np.unique(ids)
    total = np.zeros(len(uniq), dtype=np.float64)
    for pids, contrib in parts:
        add = np.zeros(len(uniq), dtype=np.float64)
        add[np.searchsorted(uniq, pids)] = contrib
        total = total + add            # x + 0.0 == x: absent adds nothing
    order = np.lexsort((uniq, -total))
    return uniq[order], total[order].astype(np.float32)


def relative_score_fusion(vec_ids, vec_dists, text_ids, text_scores,
                          weight: float = 0.5,
                          vector_descending: bool = False):
    """Returns (ids, fused_scores) sorted by fused score desc, ties by id asc.

    vec_dists: distances in metric convention (asc lists for L2/Cosine,
    desc for IP -> vector_descending=True).  text_scores: BM25 desc.
    """
    vec_ids = np.asarray(vec_ids).astype(np.int64)
    text_ids = np.asarray(text_ids).astype(np.int64)
    nv = _normalized(np.asarray(vec_dists, dtype=np.float32))
    nt = _normalized(np.asarray(text_scores, dtype=np.float32))
    # 1 - norm in float32, as the JAX package's float32 scalar arithmetic
    contrib = nv if vector_descending else np.float32(1.0) - nv
    parts = [(vec_ids, (1.0 - weight) * contrib.astype(np.float64)),
             (text_ids, weight * nt.astype(np.float64))]
    return _fused_order(np.concatenate([vec_ids, text_ids]), parts)


def reciprocal_rank_fusion(id_lists, fusion_k: int = 60):
    """id_lists: sequence of ranked id arrays (best first)."""
    lists = [np.asarray(ids).astype(np.int64) for ids in id_lists]
    parts = [(ids, 1.0 / (fusion_k + np.arange(len(ids), dtype=np.float64)
                          + 1.0)) for ids in lists]
    allids = np.concatenate(lists) if lists else np.zeros(0, np.int64)
    return _fused_order(allids, parts)
