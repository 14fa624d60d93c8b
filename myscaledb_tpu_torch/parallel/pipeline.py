"""BASELINE config 5's whole distributed step in one call: the port of
myscaledb_tpu/parallel/pipeline.py, with its exchange/compute overlap.

The JAX package issues the join shuffle's all_to_alls before the top-k
distance matmul inside one shard_map, so XLA's async collectives overlap
the exchange with the scan.  Here the step forks into two branches that
share no tensor:

- the join branch (the shuffle of both key columns, each shard's join
  count, their psum) is queued first, on a side stream of every card of
  the mesh (``Mesh.side_streams()``), each of which first waits for what
  its card's current stream has queued (the caller's inputs);
- the scan branch (each shard's distance scan, K2, the top-k merge, the
  group partials, K3, and their merge) is queued after it on each card's
  current stream, where the kernel wrappers launch.

The side streams are current on every card at once while the join branch
is queued: a peer copy is ordered on the current streams of both cards,
so the exchange's copies stay off the scans' streams.  Shards that share
a card share its side stream.  Device 0's current stream then waits for
every side stream, so the count is ready wherever the caller reads the
results; the host waits for nothing.

The caching allocator hands a freed block to new work on the stream that
allocated it without waiting for other streams.  So every tensor read on
a stream other than its own is recorded there (``record_stream``): the
key columns the join branch reads, and the count that device 0's current
stream reads.  A CPU mesh has no streams: the branches run in the same
order, one after the other, with no CUDA call.
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager

import torch

from myscaledb_tpu_torch.ops.aggregate import partial_aggregate_matmul
from myscaledb_tpu_torch.parallel.mesh import (Mesh, psum, row_slices,
                                               rows_per_shard)
from myscaledb_tpu_torch.parallel.ops import (_local_distance_topk,
                                              _merge_agg_states)
from myscaledb_tpu_torch.parallel.shuffle import _all_pair_count, _exchange


@contextmanager
def _forked(side: dict):
    """Each side stream current on its card for the block, after waiting
    for the work queued so far on that card's current stream."""
    with ExitStack() as stack:
        for dev, s in side.items():
            s.wait_stream(torch.cuda.current_stream(dev))
            stack.enter_context(torch.cuda.stream(s))
        yield


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

    1 and 4 run on the side streams, 2, 3 and 5 on the current streams
    (module docstring).  Every row-split argument is a RowSplit, a list of
    per-shard tensors or a global tensor (``row_slices``).  Returns
    replicated (top-k dist (nq, k), top-k ids (nq, k), join count (0-d
    int64), aggregate states, group count) on ``mesh.device(0)``."""
    nsh = mesh.size
    xs = row_slices(mesh, x)
    n_loc = rows_per_shard(xs)
    fks = row_slices(mesh, fact_key)
    dks = row_slices(mesh, dim_key)
    cap_f = max(n_loc, 1)
    cap_d = max(int(dks[0].shape[0]), 1)
    fns = tuple(fns)
    q = torch.as_tensor(q, device=mesh.device(0)).float()
    side = mesh.side_streams()
    # 1 and 4, the join branch, queued first
    with _forked(side):
        for t in fks + dks:
            if t.device in side:
                t.record_stream(side[t.device])
        fk_rx, _, fv_rx = _exchange(mesh, fks, [], [torch.ones_like(
            f, dtype=torch.bool) for f in fks], cap_f)
        dk_rx, _, dv_rx = _exchange(mesh, dks, [], [torch.ones_like(
            d, dtype=torch.bool) for d in dks], cap_d)
        cnt = psum([_all_pair_count(fk_rx[p], fv_rx[p], dk_rx[p], dv_rx[p])
                    for p in range(nsh)])
    # 2-3. the scans and their merge
    md, mi = _local_distance_topk(mesh, xs, q, None, metric, int(k),
                                  int(block_rows), x_sqnorm)
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
    # the join: device 0's current stream waits for every side stream
    if side:
        main = torch.cuda.current_stream(mesh.device(0))
        for s in side.values():
            main.wait_stream(s)
        cnt.record_stream(main)
    return md, mi, cnt, states, gc
