"""All-to-all shuffle: hash-repartition rows across the mesh.  The port of
myscaledb_tpu/parallel/shuffle.py.

Reference analog: distributed aggregation and join repartitioning, blocks
scattered by key hash (DistributedSink.cpp).  The exchange is one tiled
``all_to_all`` of padded buckets: every shard sorts its rows by
destination (stable), packs them into an (nsh, cap) buffer, exchanges,
and keeps the received rows with a validity mask; raggedness is carried
as padding.  After a shuffle by key hash every occurrence of a key lives
on one shard, so joins and aggregations become shard-local.

Each shard routes and packs its rows on its own device; the all_to_all
copies each bucket to its destination shard's device, where the shard's
join or grouping then runs.  Shard p receives its rows from shard 0
first, each source's rows in their row order: an ANY join's lowest build row and the pairs' order follow
from that, as in the JAX package.  The shard-local join count is the JAX
package's sort-based count, its run starts carried by a scatter and a
gather where the JAX package takes a cummax
(``ops.hashtable.at_run_start``).  A
shard body reads nothing back to the host, so the host queues every
shard's exchange and count without waiting (on distinct cards they run
at once).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from myscaledb_tpu_torch.ops.hash import hash32
from myscaledb_tpu_torch.ops.hashtable import (INT32_MAX, _cat_keys, _ranks,
                                               at_run_start,
                                               group_ids_static,
                                               merge_join_any)
from myscaledb_tpu_torch.ops.aggregate import partial_aggregate
from myscaledb_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                               all_to_all, psum, row_slices,
                                               rows_per_shard)


def _dest_of(key: torch.Tensor, nsh: int) -> torch.Tensor:
    return (hash32(key) % nsh).to(torch.int32)


def _route(key_loc, vmask, nsh: int, cap: int):
    """Destination routing shared by the exchange variants: (order, slot,
    n_dropped) — rows sorted by destination shard (stable), their packed
    slot in an (nsh, cap) buffer (nsh * cap: dropped), and how many valid
    rows overflowed the per-destination capacity (0 whenever cap is the
    worst case)."""
    n_loc = key_loc.shape[0]
    dev = key_loc.device
    dest = torch.where(vmask.bool(), _dest_of(key_loc, nsh), nsh)
    order = torch.sort(dest, stable=True).indices
    sdest = dest[order].long()
    # each destination's first sorted position (bincount would read its
    # size back to the host)
    starts = torch.searchsorted(
        sdest, torch.arange(nsh + 1, dtype=torch.int64, device=dev))
    within = torch.arange(n_loc, device=dev) - starts[sdest]
    real = sdest < nsh
    ok = real & (within < cap)
    slot = torch.where(ok, sdest * cap + within, nsh * cap)
    n_dropped = (real & (within >= cap)).sum(dtype=torch.int64)
    return order, slot, n_dropped


def _pack(col: torch.Tensor, order, slot, size: int) -> torch.Tensor:
    """col's rows in route order scattered to their slots of a (size,)
    buffer; slot ``size`` is the dropped one."""
    buf = torch.zeros((size + 1,) + tuple(col.shape[1:]), dtype=col.dtype,
                      device=col.device)
    buf[slot] = col[order]
    return buf[:size]


def _flag(slot, size: int, dev) -> torch.Tensor:
    buf = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    buf.index_fill_(0, slot, True)      # no host scalar copied in
    return buf[:size]


def _exchange(mesh: Mesh, keys: list, cols: Sequence[list], vmasks: list,
              cap: int, force_exchange: bool = False):
    """The shuffle over per-shard lists: route each shard's rows to
    destination buckets of ``cap`` rows and all_to_all them.  Returns
    (keys_rx, cols_rx, valid_rx), each a list of per-shard (nsh * cap,)
    tensors.  ``force_exchange`` prices the full route, pack and
    all_to_all even on one shard (a benchmark baseline's)."""
    nsh = mesh.size
    n_loc = keys[0].shape[0]
    cols = [list(c) for c in cols]
    if nsh == 1 and cap == n_loc and not force_exchange:
        # one shard: every row is already local
        return list(keys), cols, [v.bool() for v in vmasks]
    size = nsh * cap
    kb, cb, vb = [], [[] for _ in cols], []
    for p in range(nsh):
        order, slot, _ = _route(keys[p], vmasks[p], nsh, cap)
        kb.append(_pack(keys[p], order, slot, size))
        for j, c in enumerate(cols):
            cb[j].append(_pack(c[p], order, slot, size))
        vb.append(_flag(slot, size, keys[p].device))
    return all_to_all(kb), [all_to_all(b) for b in cb], all_to_all(vb)


def exchange_pair(mesh: Mesh, lks: list, lvs: list, rks: list, rvs: list,
                  cap_l: int, cap_r: int):
    """Two-sided exchange for shuffle joins: routes both sides and ships
    them in one all_to_all of an (nsh, cap_l + cap_r) buffer (keys in a
    common dtype) plus one validity all_to_all.  The caps may be
    optimistic: the returned dropped count (a replicated 0-d tensor) is
    exact, so a caller retries at the worst case when it is not zero.
    Returns per-shard lists (lk_rx, lv_rx, rk_rx, rv_rx) and dropped."""
    nsh = mesh.size
    kdt = torch.promote_types(lks[0].dtype, rks[0].dtype)
    span = cap_l + cap_r
    size = nsh * span
    bufs, vbufs, drops = [], [], []
    for p in range(nsh):
        ord_l, slot_l, drop_l = _route(lks[p], lvs[p], nsh, cap_l)
        ord_r, slot_r, drop_r = _route(rks[p], rvs[p], nsh, cap_r)
        # per destination: [0, cap_l) left keys | [cap_l, span) right keys
        dst_l = torch.where(slot_l >= nsh * cap_l, size,
                            (slot_l // cap_l) * span + slot_l % cap_l)
        dst_r = torch.where(slot_r >= nsh * cap_r, size,
                            (slot_r // cap_r) * span + cap_l
                            + slot_r % cap_r)
        buf = torch.zeros(size + 1, dtype=kdt, device=lks[p].device)
        buf[dst_l] = lks[p][ord_l].to(kdt)
        buf[dst_r] = rks[p][ord_r].to(kdt)
        vbuf = torch.zeros(size + 1, dtype=torch.bool, device=buf.device)
        vbuf[dst_l] = True
        vbuf[dst_r] = True
        bufs.append(buf[:size])
        vbufs.append(vbuf[:size])
        drops.append(drop_l + drop_r)
    rx = [b.reshape(nsh, span) for b in all_to_all(bufs)]
    vrx = [b.reshape(nsh, span) for b in all_to_all(vbufs)]
    return ([r[:, :cap_l].reshape(-1) for r in rx],
            [v[:, :cap_l].reshape(-1) for v in vrx],
            [r[:, cap_l:].reshape(-1) for r in rx],
            [v[:, cap_l:].reshape(-1) for v in vrx],
            psum(drops))


def _ones(mesh: Mesh, n_loc: int) -> list:
    return [torch.ones(n_loc, dtype=torch.bool, device=mesh.device(p))
            for p in range(mesh.size)]


def shuffle_by_key(mesh: Mesh, key, arrays: Sequence, valid=None,
                   cap: int | None = None):
    """Repartition rows so equal keys colocate: row -> shard hash(key) %
    nsh.  key: (n,) row-split integer key; arrays: columns moved with it;
    valid: optional row validity (padding rows excluded); cap: bucket
    capacity (worst case n_loc when None).  Returns (key_out, arrays_out,
    valid_out) in the global view on ``mesh.device(0)``: shard p's (nsh *
    cap,) received rows at [p * nsh * cap, (p + 1) * nsh * cap)."""
    keys = row_slices(mesh, key)
    n_loc = rows_per_shard(keys)
    cap = int(cap or n_loc)
    k_rx, c_rx, v_rx = _exchange(mesh, keys,
                                 [row_slices(mesh, a) for a in arrays],
                                 _split_valid(mesh, valid, n_loc), cap)
    return (all_gather(k_rx, tiled=True),
            tuple(all_gather(c, tiled=True) for c in c_rx),
            all_gather(v_rx, tiled=True))


def _split_valid(mesh, valid, n_loc):
    return row_slices(mesh, valid) if valid is not None \
        else _ones(mesh, n_loc)


def _row_ids(mesh: Mesh, n_loc: int) -> list:
    """Each shard's global row ids (int32) on its own device."""
    return [torch.arange(p * n_loc, (p + 1) * n_loc, dtype=torch.int32,
                         device=mesh.device(p)) for p in range(mesh.size)]


def sharded_shuffle_join_pairs(mesh: Mesh, left_key, right_key,
                               how: str = "ALL", left_valid=None,
                               right_valid=None):
    """Distributed shuffle join: both sides hash-repartitioned by key so
    matches colocate, then every shard joins its received rows.  Returns
    the matched (left global row, right global row) pairs as int32 numpy
    arrays.  how: "ALL" (full multiplicity; pairs ordered by left row, then
    right row, as hash_join_all orders them) or "ANY" (the lowest right
    row per left row; pairs in the shards' received order)."""
    nsh = mesh.size
    lks, rks = row_slices(mesh, left_key), row_slices(mesh, right_key)
    cap_l, cap_r = rows_per_shard(lks), rows_per_shard(rks)
    n_r = nsh * cap_r
    lk_rx, (lid_rx,), lv_rx = _exchange(
        mesh, lks, [_row_ids(mesh, cap_l)],
        _split_valid(mesh, left_valid, cap_l), cap_l)
    rk_rx, (rid_rx,), rv_rx = _exchange(
        mesh, rks, [_row_ids(mesh, cap_r)],
        _split_valid(mesh, right_valid, cap_r), cap_r)
    if how == "ANY":
        out_l, out_r = [], []
        for p in range(nsh):
            brow, found = merge_join_any((rk_rx[p],), (lk_rx[p],),
                                         build_valid=rv_rx[p],
                                         probe_valid=lv_rx[p])
            safe = torch.where(found, brow, 0).long()
            out_l.append(lid_rx[p][found])
            out_r.append(rid_rx[p][safe][found])
        return (all_gather(out_l, tiled=True).cpu().numpy()
                .astype(np.int32),
                all_gather(out_r, tiled=True).cpu().numpy()
                .astype(np.int32))
    # ALL: a count pass per shard sizes the expansion (one host sync)
    totals = [int(t) for t in all_gather(
        [_all_pair_count(lk_rx[p], lv_rx[p], rk_rx[p], rv_rx[p])
         for p in range(nsh)]).cpu()]
    cap_out = max(1, max(totals))
    pl, pr = [], []
    for p in range(nsh):
        pi, bi, pv = _all_pairs_padded(lk_rx[p], lid_rx[p], lv_rx[p],
                                       rk_rx[p], rid_rx[p], rv_rx[p],
                                       cap_out, totals[p])
        pl.append(pi[pv])
        pr.append(bi[pv])
    # by left row, then right row, sorted on shard 0's device
    out_l = all_gather(pl, tiled=True).long()
    out_r = all_gather(pr, tiled=True).long()
    o = torch.sort(out_l * max(n_r, 1) + out_r).indices
    return (out_l[o].cpu().numpy().astype(np.int32),
            out_r[o].cpu().numpy().astype(np.int32))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def sharded_shuffle_join_count(mesh: Mesh, left_key, right_key,
                               left_valid=None, right_valid=None,
                               force_exchange: bool = False) -> torch.Tensor:
    """Distributed join count: both sides shuffled by key hash in one
    exchange (``exchange_pair``), (left, right) matches counted per shard,
    psum'd.  The buckets default to an optimistic 2x-uniform capacity;
    overflow is counted exactly and retried once at the worst case, so the
    count is always exact.  Returns a replicated 0-d int64 tensor."""
    nsh = mesh.size
    lks, rks = row_slices(mesh, left_key), row_slices(mesh, right_key)
    full_l, full_r = max(rows_per_shard(lks), 1), max(rows_per_shard(rks), 1)
    lvs = _split_valid(mesh, left_valid, rows_per_shard(lks))
    rvs = _split_valid(mesh, right_valid, rows_per_shard(rks))

    def run(cap_l: int, cap_r: int):
        if nsh == 1 and not force_exchange:
            lk_rx, _, lv_rx = _exchange(mesh, lks, [], lvs, full_l)
            rk_rx, _, rv_rx = _exchange(mesh, rks, [], rvs, full_r)
            dropped = 0
        else:
            lk_rx, lv_rx, rk_rx, rv_rx, dropped = exchange_pair(
                mesh, lks, lvs, rks, rvs, cap_l, cap_r)
        cnt = psum([_all_pair_count(lk_rx[p], lv_rx[p], rk_rx[p], rv_rx[p])
                    for p in range(nsh)])
        return cnt, dropped

    if nsh > 1:
        cap_l = min(full_l, _round_up(2 * full_l // nsh + 64, 64))
        cap_r = min(full_r, _round_up(2 * full_r // nsh + 64, 64))
        cnt, dropped = run(cap_l, cap_r)
        if int(dropped) == 0:
            return cnt
    cnt, _ = run(full_l, full_r)
    return cnt


def _sort_key_rank(keys_all, rank):
    """Sort (key, rank) lexicographically.  A key of at most 32 bits and
    its rank (0..2) fuse into one int64 (key * 4 + rank), sorted once and
    split again; wider keys take two stable sorts."""
    key = keys_all[0]
    if len(keys_all) == 1 and not key.is_floating_point() and \
            torch.iinfo(key.dtype).bits <= 32 and key.dtype != torch.bool:
        s = torch.sort(key.to(torch.int64) * 4 + rank.to(torch.int64)).values
        return (s >> 2,), (s & 3).to(torch.int32)
    perm = torch.arange(rank.shape[0], device=rank.device)
    for op in reversed(tuple(keys_all) + (rank,)):
        perm = perm[torch.sort(op[perm], stable=True).indices]
    return tuple(k[perm] for k in keys_all), rank[perm]


def _run_starts(s_keys) -> torch.Tensor:
    n = s_keys[0].shape[0]
    start = torch.zeros(n, dtype=torch.bool, device=s_keys[0].device)
    start[:1].fill_(True)               # no host scalar copied in
    for k in s_keys:
        start[1:] |= k[1:] != k[:-1]
    return start


def _builds_in_run(s_keys, s_rank):
    """Per sorted position, the build rows (rank 0) of its key run up to
    and including it; the run starts and each position's run index."""
    is_b = (s_rank == 0).to(torch.int32)
    run_start = _run_starts(s_keys)
    bcount = torch.cumsum(is_b, 0, dtype=torch.int32)
    run_idx = torch.cumsum(run_start, 0) - 1
    before = at_run_start(bcount - is_b, run_start, run_idx)
    return bcount - before, run_start, run_idx


def _all_pair_count(lk, lv, rk, rv) -> torch.Tensor:
    """Number of (left, right) key matches among valid rows (0-d int64)."""
    keys_all = _cat_keys((rk,), (lk,))
    rank = _ranks(rv, lv, rk.shape[0], lk.shape[0])
    s_keys, s_rank = _sort_key_rank(keys_all, rank)
    bir, _, _ = _builds_in_run(s_keys, s_rank)
    return torch.where(s_rank == 1, bir, 0).sum(dtype=torch.int64)


def _all_pairs_padded(lk, lid, lv, rk, rid, rv, cap: int, total: int):
    """ALL-join (left id, right id) pairs padded to ``cap``, with their
    validity; ``total`` is this shard's pair count (the count pass's)."""
    dev = lk.device
    keys_all = _cat_keys((rk,), (lk,))
    rank = _ranks(rv, lv, rk.shape[0], lk.shape[0])
    idx = torch.cat([rid, lid])
    n = idx.shape[0]
    perm = torch.arange(n, device=dev)
    for op in (rank, keys_all[0]):
        perm = perm[torch.sort(op[perm], stable=True).indices]
    s_keys, s_rank, s_idx = (keys_all[0][perm],), rank[perm], idx[perm]
    bir, run_start, run_idx = _builds_in_run(s_keys, s_rank)
    start_of = at_run_start(torch.arange(n, dtype=torch.int64, device=dev),
                             run_start, run_idx)
    per_pos = torch.where(s_rank == 1, bir, 0).to(torch.int64)
    # pair t belongs to sorted probe position rep[t] and is its j-th build
    # counted from the run start
    rep = torch.repeat_interleave(torch.arange(n, device=dev), per_pos,
                                  output_size=total)
    offsets = torch.cumsum(per_pos, 0) - per_pos
    t = torch.arange(total, dtype=torch.int64, device=dev)
    bpos = start_of[rep] + (t - offsets[rep])
    probe_ids = torch.zeros(cap, dtype=idx.dtype, device=dev)
    build_ids = torch.zeros(cap, dtype=idx.dtype, device=dev)
    probe_ids[:total] = s_idx[rep]
    build_ids[:total] = s_idx[bpos]
    valid = torch.arange(cap, device=dev) < total
    return probe_ids, build_ids, valid


def _shuffle_groups(mesh: Mesh, key, mask, cols: list):
    """The high-cardinality GROUP BY's shard bodies: rows shuffled by key
    (worst-case buckets), then grouped per shard.  Returns per shard (local
    group ids, the group -> key map, received columns, received
    validity)."""
    nsh = mesh.size
    keys = row_slices(mesh, key)
    k_rx, c_rx, v_rx = _exchange(mesh, keys,
                                 [row_slices(mesh, c) for c in cols],
                                 row_slices(mesh, mask), rows_per_shard(keys))
    out = []
    for p in range(nsh):
        lgid, (rep,), _ng = group_ids_static((k_rx[p],), v_rx[p])
        lgid = torch.where(lgid == INT32_MAX, 0, lgid)
        out.append((lgid, rep, [c[p] for c in c_rx], v_rx[p]))
    return out


def sharded_shuffle_aggregate(mesh: Mesh, key, mask, args, fns: tuple):
    """High-cardinality distributed GROUP BY keyed by the raw key: rows
    repartitioned by key hash, aggregated per shard (each key lives on one
    shard).  Returns (keys (m,), per-aggregate results, counts (m,)) as
    numpy; the initiator's merge is a concatenation (keys disjoint)."""
    fns = tuple(fns)
    # received rows per shard (padded)
    m = mesh.size * rows_per_shard(row_slices(mesh, key))
    reps, states, gcs = [], [], []
    for lgid, rep, a_rx, v_rx in _shuffle_groups(mesh, key, mask,
                                                 list(args)):
        st, gc = partial_aggregate(lgid, v_rx, tuple(a_rx), fns, m)
        reps.append(rep)
        states.append(st)
        gcs.append(gc)
    gc_np = all_gather(gcs, tiled=True).cpu().numpy()
    present = np.flatnonzero(gc_np > 0)
    keys = all_gather(reps, tiled=True).cpu().numpy()[present]
    outs = []
    for j, fn in enumerate(fns):
        if fn == "avg":
            ssum = all_gather([s[j][0] for s in states],
                              tiled=True).cpu().numpy()
            cnt = all_gather([s[j][1] for s in states],
                             tiled=True).cpu().numpy()
            ssum = ssum.astype(np.float64)[present]
            cnt = cnt.astype(np.float64)[present]
            with np.errstate(divide="ignore", invalid="ignore"):
                outs.append(np.where(cnt > 0, ssum / cnt, np.nan))
        else:
            outs.append(all_gather([s[j] for s in states], tiled=True)
                        .cpu().numpy()[present])
    return keys, outs, gc_np[present]


def sharded_shuffle_group_states(mesh: Mesh, gid, mask, args, fns: tuple,
                                 num_groups: int, arg_valids=None):
    """High-cardinality distributed GROUP BY keyed by a dense global group
    id: rows repartitioned by gid so every group lands on one shard,
    aggregated per shard at the received cardinality, and the dense (G,)
    states assembled on the device with one scatter a shard (groups are
    disjoint across shards).  Exchanged bytes scale with the rows, not
    with G times the shards (the reference's
    distributed_aggregation_memory_efficient).  An arg may be None where
    the aggregate reads none; arg_valids: None where an argument has no
    nulls.  Returns (states, group_count) in ``partial_aggregate``'s dense
    layout, as the psum route returns them."""
    fns = tuple(fns)
    n_args = len(args)
    moved = [i for i, a in enumerate(args) if a is not None]
    vmoved = [i for i, v in enumerate(arg_valids or ()) if v is not None]
    cols = [args[i] for i in moved] + [arg_valids[i] for i in vmoved]
    m = mesh.size * rows_per_shard(row_slices(mesh, gid))
    dev = mesh.device(0)
    G = num_groups
    gc_dense = torch.zeros(G, dtype=torch.int64, device=dev)
    dense: list = [None] * len(fns)
    for lgid, rep, c_rx, v_rx in _shuffle_groups(mesh, gid, mask, cols):
        loc_args = [None] * n_args
        for i, c in zip(moved, c_rx):
            loc_args[i] = c
        loc_valids = None
        if arg_valids is not None:
            loc_valids = [None] * n_args
            for i, c in zip(vmoved, c_rx[len(moved):]):
                loc_valids[i] = c
        st, gc = partial_aggregate(lgid, v_rx, tuple(loc_args), fns, m,
                                   None if loc_valids is None
                                   else tuple(loc_valids))
        # each shard's groups scattered into the dense states on shard 0's
        # device
        sel = gc > 0
        tgt = rep[sel].long().to(dev)
        gc_dense[tgt] = gc[sel].to(dev)
        for j, fn in enumerate(fns):
            parts = st[j] if fn == "avg" else (st[j],)
            if dense[j] is None:
                dense[j] = [torch.zeros(G, dtype=s.dtype, device=dev)
                            for s in parts]
            for d, s in zip(dense[j], parts):
                d[tgt] = s[sel].to(dev)
    states = tuple(tuple(d) if fn == "avg" else d[0]
                   for fn, d in zip(fns, dense))
    return states, gc_dense
