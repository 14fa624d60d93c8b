"""Distributed text search: per-shard BM25 sub-searches with global
statistics, merged at the initiator.  The port of
myscaledb_tpu/text/distributed.py.

Reference: StorageDistributed fans a TextSearch/HybridSearch out to every
shard; each shard scores its own rows with BM25 under GLOBAL statistics
aggregated first (BM25InfoInDataParts: df, doc and token counts summed
across parts and shards), ships its top-k, and the initiator merges them
(FusionSortingStep).

Here each shard's part of the row-split text column gets its own BM25
index on the shard's card (one tokenization of the column's dictionary
serves them all); the per-term statistics, host integers every index
keeps, are summed on the host (the psum of this layer) and every shard
scores with them on its card — bit-identical to the undistributed table,
since BM25 is per doc given (N, avg_len, df) — and the initiator merges
the shards' candidate lists by score descending, then global row id
ascending.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.derived import derived_state
from myscaledb_tpu_torch.core.table import Column
from myscaledb_tpu_torch.text.bm25 import BM25Index, tokenize


def _shard_indexes(session, table_name: str, table, text_col: str) -> list:
    """Per-shard BM25 indexes over the row-split text column, kept in the
    session's derived state per (table, column, epoch) like the vector
    sidecars."""
    from myscaledb_tpu_torch import native
    from myscaledb_tpu_torch.parallel.dist_table import ROW_VALID
    from myscaledb_tpu_torch.parallel.mesh import row_slices
    c = table[text_col]
    mesh = table.mesh

    def build():
        tokens = native.tokenize_corpus(c.dictionary.values)
        datas = row_slices(mesh, c.data)
        valids = row_slices(mesh, c.valid)
        rvs = row_slices(mesh, table[ROW_VALID].data)
        return [BM25Index.from_column(
            Column(c.field, datas[p], valids[p], c.dictionary),
            mesh.device(p), doc_valid=rvs[p], tokens=tokens)
            for p in range(mesh.size)]

    return derived_state(session, ("bm25_shards", table_name, text_col),
                         c.data, build)


def global_stats(shards, query: str) -> dict:
    """The shards' statistics for the query's terms merged (the
    BM25InfoInDataParts aggregation: doc counts, token counts and each
    term's df summed)."""
    df = {t: sum(ix.term_df(t) for ix in shards) for t in set(tokenize(query))}
    return {"n_docs": sum(ix.stat_docs for ix in shards),
            "total_tokens": sum(ix.total_tokens for ix in shards), "df": df}


def sharded_text_search(session, table_name: str, table, text_col: str,
                        query: str, k: int, mask=None,
                        operator: str = "OR"):
    """Per-shard BM25 top-k and the initiator's merge.  ``mask``: the
    statement's WHERE mask, one tensor per shard (or None).  Returns
    (scores (k,), global ids (k,)) tensors on the session's device,
    INVALID_ID-padded, bit-identical to the undistributed
    ``BM25Index.search`` over the whole table."""
    from myscaledb_tpu_torch.ops.vector import INVALID_ID
    from myscaledb_tpu_torch.parallel.mesh import row_slices
    shards = _shard_indexes(session, table_name, table, text_col)
    stats = global_stats(shards, query)
    masks = row_slices(table.mesh, mask)
    cand_s, cand_i = [], []
    for p, ix in enumerate(shards):
        s = ix.scores(query, operator, global_stats=stats)
        if masks[p] is not None:
            s = torch.where(masks[p].bool(), s, 0.0)
        # the shard's top-k: score desc, local id asc
        top = torch.sort(-s, stable=True).indices[:min(k, ix.n_docs)]
        keep = s[top] > 0
        cand_s.append(s[top][keep])
        cand_i.append(top[keep] + p * ix.n_docs)
    scores = np.concatenate([t.cpu().numpy() for t in cand_s])
    gids = np.concatenate([t.cpu().numpy() for t in cand_i])
    # the initiator's merge: score desc, global id asc
    order = np.lexsort((gids, -scores))[:k]
    out_s = np.zeros(k, dtype=np.float32)
    out_i = np.full(k, INVALID_ID, dtype=np.int64)
    out_s[:len(order)] = scores[order]
    out_i[:len(order)] = gids[order]
    dev = session.device
    return torch.as_tensor(out_s, device=dev), \
        torch.as_tensor(out_i, device=dev)
