"""Distributed operators: shard bodies merged by the mesh's collectives.
The port of myscaledb_tpu/parallel/ops.py.

Maps the reference's distribution mechanisms onto the mesh:

  shard fan-out + initiator top-k merge (StorageDistributed +
  RemoteQueryExecutor + MergingSorted)
     -> a shard-local exact top-k, an all_gather of the (nsh, nq, k)
        candidates and one (score, id) cut; a ppermute butterfly takes over
        when nsh * nq * k gets large.
  two-level aggregation (WithMergeableState)
     -> dense partial states per shard merged by psum / pmin / pmax.
  ORDER BY ... LIMIT over shards
     -> a shard-local top-n, its candidates gathered and cut.

Shard p owns global rows [p * n_loc, (p + 1) * n_loc), so a local row id
lifts to a global one with one offset add.  Each operator takes its
row-split inputs as a ``RowSplit``, a list of per-shard tensors or a
global tensor (split by ``shard_rows``); every shard body runs on its
shard's device, and the merges run on ``mesh.device(0)``, where the
replicated results live.

The JAX shard body scans with XLA's plain block scan; here it is the
port's local ``distance_scan`` over the shard's rows with no SQ8 sidecar:
the f32 stage 1 (K2, ``segmin_f32``, where the scan takes it) and the
exact rescore.  Ids are the JAX package's; distances agree within the
scan's tolerance (ROADMAP section 3).
"""

from __future__ import annotations

from typing import Sequence

import torch

from myscaledb_tpu_torch.ops.aggregate import (kept_rows_only,
                                               partial_aggregate_matmul)
from myscaledb_tpu_torch.ops.sort import SortKey, topn_permutation
from myscaledb_tpu_torch.ops.topk import sort_by_score_then_id
from myscaledb_tpu_torch.ops.vector import (INVALID_ID, distance_scan,
                                            precompute_sqnorm)
from myscaledb_tpu_torch.parallel.mesh import (Mesh, all_gather, pmax,
                                               pmin, ppermute, psum,
                                               row_slices, rows_per_shard)

# rows of a shard whose squared norms are taken at once (bounds the
# temporary of x * x)
SQNORM_CHUNK_ROWS = 1 << 20


def _merge_minscore_topk(s, i, k: int):
    """(nq, m) candidate min-scores + global ids -> best k by (score, id)."""
    ss, ii = sort_by_score_then_id(s, i)
    return ss[..., :k], ii[..., :k]


def _butterfly_topk(ss: list, ids: list, k: int):
    """Tree-reduced top-k merge: log2(nsh) ppermute rounds with XOR
    partners; after the last round every shard holds the global top-k
    (O(k log P) exchanged per shard instead of the all_gather's O(k P))."""
    nsh = len(ss)
    for r in range((nsh - 1).bit_length()):
        h = 1 << r
        perm = [(i, i ^ h) for i in range(nsh)]
        ps = ppermute(ss, perm)
        pi = ppermute(ids, perm)
        merged = [_merge_minscore_topk(torch.cat([ss[p], ps[p]], dim=-1),
                                       torch.cat([ids[p], pi[p]], dim=-1), k)
                  for p in range(nsh)]
        ss = [m[0] for m in merged]
        ids = [m[1] for m in merged]
    return ss[0], ids[0]


def use_butterfly(nsh: int, nq: int, k: int) -> bool:
    """The JAX package's choice: one all_gather and a local cut wins for
    small candidate sets; the butterfly from 2^18 gathered entries on a
    power-of-two mesh of at least 4 shards."""
    return nsh & (nsh - 1) == 0 and nsh >= 4 and nsh * nq * k >= (1 << 18)


def sqnorm_rows(x: torch.Tensor) -> torch.Tensor:
    """Squared row norms of ``x``, SQNORM_CHUNK_ROWS rows at a time."""
    n = x.shape[0]
    if n <= SQNORM_CHUNK_ROWS:
        return precompute_sqnorm(x)
    return torch.cat([precompute_sqnorm(x[s:s + SQNORM_CHUNK_ROWS])
                      for s in range(0, n, SQNORM_CHUNK_ROWS)])


def _shard_distance_topk(x_loc, q, mask_loc, metric: str, k: int,
                         block_rows: int, p: int, n_loc: int, sqn_loc=None):
    """Shard body: the exact top-k of the shard's rows as internal
    min-scores (+inf where absent) and global ids, on the shard's
    device."""
    q = q.to(x_loc.device)
    if sqn_loc is None:
        sqn_loc = sqnorm_rows(x_loc.float())
    d, i = distance_scan(x_loc, q, metric=metric, k=k, mask=mask_loc,
                         block_rows=min(block_rows, n_loc),
                         x_sqnorm=sqn_loc)
    s = torch.where(torch.isinf(d), float("inf"),
                    -d if metric == "IP" else d)
    gids = torch.where(i == INVALID_ID, INVALID_ID, i + p * n_loc)
    return s, gids


def _merge_distance_topk(ss: list, ids: list, k: int, metric: str):
    """Cross-shard merge of the shards' candidates by (score, id); the
    replicated (dist (nq, k), global ids (nq, k)) in the metric's native
    convention."""
    nsh = len(ss)
    nq = ss[0].shape[0]
    if use_butterfly(nsh, nq, k):
        ms, mi = _butterfly_topk(ss, ids, k)
    else:
        kk = ss[0].shape[1]                      # the local cut may be < k
        all_s = all_gather(ss).transpose(0, 1).reshape(nq, nsh * kk)
        all_i = all_gather(ids).transpose(0, 1).reshape(nq, nsh * kk)
        ms, mi = _merge_minscore_topk(all_s, all_i, k)
    md = torch.where(torch.isposinf(ms),
                     float("-inf") if metric == "IP" else float("inf"),
                     -ms if metric == "IP" else ms)
    return md, mi


def _local_distance_topk(mesh: Mesh, x, q, mask, metric: str, k: int,
                         block_rows: int, x_sqnorm=None):
    """Every shard's exact top-k and their merge (the fused pipeline reuses
    it between its exchange and its join count)."""
    nsh = mesh.size
    xs = row_slices(mesh, x)
    n_loc = rows_per_shard(xs)
    ms = row_slices(mesh, mask)
    sqs = row_slices(mesh, x_sqnorm)
    ss, ids = [], []
    for p in range(nsh):
        s, g = _shard_distance_topk(xs[p], q, ms[p], metric, k, block_rows,
                                    p, n_loc, sqs[p])
        ss.append(s)
        ids.append(g)
    return _merge_distance_topk(ss, ids, k, metric)


def sharded_distance_topk(mesh: Mesh, x, q, metric: str = "L2", k: int = 10,
                          mask=None, block_rows: int = 32768, x_sqnorm=None):
    """Distributed exact top-k distance scan.

    x: (N, D) row-split over the mesh (N a multiple of the shard count);
    q: (nq, D) replicated; mask: optional (N,) row-split (a shard's part
    may be None); x_sqnorm: optional (N,) row-split squared norms (else
    each shard takes its own).  Returns replicated (dist (nq, k), global
    ids (nq, k)) on ``mesh.device(0)``."""
    xs = row_slices(mesh, x)
    q = torch.as_tensor(q, device=mesh.device(0)).float()
    if q.dim() == 1:
        q = q[None, :]
    masks = [None if m is None else m.bool()
             for m in row_slices(mesh, mask)]
    return _local_distance_topk(mesh, xs, q, masks, metric, int(k),
                                int(block_rows), x_sqnorm)


def sqnorm_parts(x) -> list:
    """Each shard's squared row norms on its own device."""
    return [sqnorm_rows(t.float()) for t in x.parts]


def _merge_agg_states(fns, states: list, gcs: list):
    """Cross-shard merge of dense per-group partial states (the
    WithMergeableState combine): sums and counts psum'd in shard order,
    min/max by pmin/pmax, ``any`` from the lowest shard whose group has
    rows.  ``states``: per shard, the tuple of its states."""
    gc_tot = psum(gcs)
    merged = []
    for j, fn in enumerate(fns):
        per = [st[j] for st in states]
        if fn in ("sum", "count"):
            merged.append(psum(per))
        elif fn == "avg":
            merged.append((psum([s[0] for s in per]),
                           psum([s[1] for s in per])))
        elif fn == "min":
            merged.append(pmin(per))
        elif fn == "max":
            merged.append(pmax(per))
        elif fn == "any":
            all_v = all_gather(per)                    # (nsh, G)
            all_has = all_gather([g > 0 for g in gcs])
            first = torch.argmax(all_has.to(torch.int8), dim=0)
            merged.append(torch.gather(all_v, 0, first[None, :])[0])
        else:
            raise ValueError(fn)
    return tuple(merged), gc_tot


def sharded_group_aggregate(mesh: Mesh, gid, mask, args, fns: tuple,
                            num_groups: int, arg_valids=None,
                            arg_ranges=None, logical_dtypes=None,
                            route_rows=None, compact_min_rows=None):
    """Distributed GROUP BY: per-shard dense partial states from
    ``partial_aggregate_matmul`` (K3 for sum/count/avg up to 256 groups
    without per-argument validity) merged with psum/pmin/pmax.
    gid/mask/args row-split (an arg may be None where the aggregate reads
    none, a count); arg_valids: optional per-aggregate validity (None where
    the argument has no nulls).  ``route_rows``: the row count each
    shard's route is chosen for (None: the shard's); ``compact_min_rows``:
    from this many rows a shard whose mask keeps under half of them
    aggregates its kept rows alone (``kept_rows_only``).  Returns
    replicated (states, group_count)."""
    fns = tuple(fns)
    nsh = mesh.size
    gids = row_slices(mesh, gid)
    rows_per_shard(gids)
    masks = row_slices(mesh, mask)
    arg_sl = [row_slices(mesh, a) for a in args]
    val_sl = [row_slices(mesh, v) for v in arg_valids] \
        if arg_valids is not None else None
    states, gcs = [], []
    for p in range(nsh):
        g, m, a, v = gids[p], masks[p], [x[p] for x in arg_sl], \
            None if val_sl is None else [x[p] for x in val_sl]
        if compact_min_rows is not None:
            g, m, a, v = kept_rows_only(m, g, m, num_groups, a,
                                        v or [None] * len(a),
                                        compact_min_rows)
        st, gc = partial_aggregate_matmul(
            g, m, tuple(a), fns, num_groups,
            None if v is None else tuple(v), arg_ranges, logical_dtypes,
            route_rows=route_rows)
        states.append(st)
        gcs.append(gc)
    return _merge_agg_states(fns, states, gcs)


def sharded_topn(mesh: Mesh, keys: Sequence[SortKey], k: int) -> torch.Tensor:
    """Distributed ORDER BY ... LIMIT k -> replicated global row ids.

    Each shard takes the top-n of its rows on the order-encoded keys (ties
    by row) on its device, then the nsh * k candidates are gathered to
    ``mesh.device(0)`` and cut (the initiator's merge); equal keys keep
    global row order.  A key's values and validity are row-split."""
    nsh = mesh.size
    vals = [row_slices(mesh, sk.values) for sk in keys]
    n_loc = rows_per_shard(vals[0])
    kk = min(k, n_loc)
    valids = [row_slices(mesh, sk.valid) for sk in keys]
    cand_vals = [[] for _ in keys]
    cand_valids = [[] for _ in keys]
    gids = []
    for p in range(nsh):
        sks = [SortKey(v[p], sk.ascending, vl[p], sk.nulls_last)
               for sk, v, vl in zip(keys, vals, valids)]
        loc = topn_permutation(sks, kk, n_loc)
        gids.append(loc + p * n_loc)
        for j, sk in enumerate(sks):
            cand_vals[j].append(sk.values[loc])
            if sk.valid is not None:
                cand_valids[j].append(sk.valid[loc])
    all_ids = all_gather(gids, tiled=True)
    merged = [SortKey(all_gather(cand_vals[j], tiled=True), sk.ascending,
                      all_gather(cand_valids[j], tiled=True)
                      if sk.valid is not None else None, sk.nulls_last)
              for j, sk in enumerate(keys)]
    # candidates sit in global row order within equal keys, so the
    # stable cut breaks ties by global id as the JAX merge does
    cut = topn_permutation(merged, min(k, nsh * kk), all_ids.shape[0])
    return all_ids[cut]
