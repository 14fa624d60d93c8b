"""BASELINE config 5's whole distributed step in one call: the port of
myscaledb_tpu/parallel/pipeline.py.

The JAX package issues the join shuffle's all_to_alls before the top-k
distance matmul inside one shard_map, so XLA's async collectives overlap
the exchange with the scan.  Here the steps keep that order: the
exchange's copies are queued first, then every shard's scan, join count
and group partials on its own card.  The host queues the shard bodies one
after another and waits for none of them, so shards on distinct cards run
at once; on one card they run in turn.  Overlapping the exchange with the
scan on a side stream is a later speed change (ROADMAP).
"""

from __future__ import annotations

import torch

from myscaledb_tpu_torch.ops.aggregate import partial_aggregate_matmul
from myscaledb_tpu_torch.parallel.mesh import (Mesh, psum, row_slices,
                                               rows_per_shard)
from myscaledb_tpu_torch.parallel.ops import (_local_distance_topk,
                                              _merge_agg_states)
from myscaledb_tpu_torch.parallel.shuffle import _all_pair_count, _exchange


def fused_topk_join_agg(mesh: Mesh, x, q, metric: str, k: int, fact_key,
                        dim_key, gid, mask, vals, fns: tuple,
                        num_groups: int, block_rows: int = 32768,
                        x_sqnorm=None):
    """Config 5 over the mesh:

      1. the join shuffle of both key columns (fact rows in buckets of
         n_loc, dim rows in buckets of n_dim / nsh),
      2. every shard's exact top-k distance scan (K2 where the scan takes
         it) and
      3. the cross-shard top-k merge,
      4. the join count of each shard's received keys, psum'd,
      5. the group-aggregate partials of each shard (K3 up to 256 groups)
         and their merge.

    Every row-split argument is a RowSplit, a list of per-shard tensors or
    a global tensor (``row_slices``).  Returns replicated (top-k dist (nq,
    k), top-k ids (nq, k), join count (0-d int64), aggregate states, group
    count) on ``mesh.device(0)``."""
    nsh = mesh.size
    xs = row_slices(mesh, x)
    n_loc = rows_per_shard(xs)
    fks = row_slices(mesh, fact_key)
    dks = row_slices(mesh, dim_key)
    cap_f = max(n_loc, 1)
    cap_d = max(int(dks[0].shape[0]), 1)
    fns = tuple(fns)
    q = torch.as_tensor(q, device=mesh.device(0)).float()
    # 1. exchange first
    fk_rx, _, fv_rx = _exchange(mesh, fks, [], [torch.ones_like(
        f, dtype=torch.bool) for f in fks], cap_f)
    dk_rx, _, dv_rx = _exchange(mesh, dks, [], [torch.ones_like(
        d, dtype=torch.bool) for d in dks], cap_d)
    # 2-3. the scans and their merge
    md, mi = _local_distance_topk(mesh, xs, q, None, metric, int(k),
                                  int(block_rows), x_sqnorm)
    # 4. the join count over colocated keys
    cnt = psum([_all_pair_count(fk_rx[p], fv_rx[p], dk_rx[p], dv_rx[p])
                for p in range(nsh)])
    # 5. GROUP BY partials and their merge
    gids, masks, vs = (row_slices(mesh, gid), row_slices(mesh, mask),
                       row_slices(mesh, vals))
    states, gcs = [], []
    for p in range(nsh):
        st, gc = partial_aggregate_matmul(gids[p], masks[p], (vs[p],), fns,
                                          num_groups)
        states.append(st)
        gcs.append(gc)
    states, gc = _merge_agg_states(fns, states, gcs)
    return md, mi, cnt, states, gc
