"""Grouping and lookup on sorted runs: the port of
myscaledb_tpu/ops/hashtable.py (``HashTable``, ``next_pow2``,
``_as_sortable``, ``_group_ids_impl``, ``build_group_ids``,
``_merge_count_eligible``, ``group_ids_static``, ``ht_insert``,
``_merged_run_fill``, ``_ranks``, ``_cat_keys``, ``_merge_lookup_impl``,
``_merge_count_impl``, ``ht_count_matches``, ``ht_lookup``,
``merge_join_any``).

The reference keeps 40+ specialized CPU hash tables for aggregation and
joins (src/Common/HashTable/, src/Interpreters/Aggregator.h:563).  The JAX
package rebuilt the family on sort, and the port keeps that design so that
group ids, representatives and join matches come out identical:

  build   sort rows by (valid, key columns) stably; equal keys become one
          contiguous run; the run's first element (lowest original row id,
          by stability) is the group representative.  Group id = dense run
          index in sorted order.

  lookup  merge-join: concatenate build and probe rows, sort by (key
          columns, side-rank, payload), hand every position its key run's
          representative by one scatter of the run starts and one gather
          (``at_run_start``), and match on key equality.  Build rows sort
          before probe rows of the same key, so the lowest build row wins
          (ANY semantics, deterministic — HashJoin.h:147
          any_take_last_row = false).

``lax.sort(..., num_keys)`` becomes successive stable ``torch.sort``s,
least significant key first, starting from the identity permutation (so
ties keep ascending row id).  The JAX package's ``lax.cummax`` over
packed run-start snapshots becomes ``at_run_start``: on the card a
``torch.cummax`` over 17M rows took 45 ms, the scatter and gather well
under one.
Join builds of one narrow integer key also keep the sorted layout of the
count probe, K4 (ops/kernels/merge_count.py), which ``ht_count_matches``
runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from myscaledb_tpu_torch.runtime.tracing import sync
from myscaledb_tpu_torch.ops.kernels.merge_count import (CountIndex,
                                                        build_count_index,
                                                        merge_count,
                                                        prepare_build)

INT32_MAX = 2 ** 31 - 1


def _charge_sort(n_rows: int, n_ops: int, site: str) -> None:
    """Budget a group sort: operands + sorted copies + payloads (~3x the
    operand bytes, 8B per element worst case).  Raises MemoryLimitExceeded
    inside a query scope when over budget (MemoryTracker.h:50 analog)."""
    from myscaledb_tpu_torch.runtime.memory import charge
    charge(3 * 8 * n_rows * max(n_ops, 1), site)


class HashTable(NamedTuple):
    """Build-side state of a grouping.

    slot ids are dense group ids in [0, capacity); ``slot_row[slot]`` is the
    lowest original build row of that group (INT32_MAX for unused slots).

    For a single narrow-integer key, a join build also keeps the count
    probe's layout: ``sorted_keys`` (n,) int32 ascending with invalid rows
    at INT32_MAX, and ``sorted_has_max`` (0-d bool), from K4's
    ``prepare_build`` — the JAX package's ``sorted_keys2d`` without its
    TPU padding and margin rows — and ``count_index``, K4's radix
    directory over them (``build_count_index``), built once per build.
    """
    key_cols: tuple              # original build key columns, each (n,)
    valid: torch.Tensor          # (n,) bool
    gid_of_row: torch.Tensor     # (n,) int32 dense group id, INT32_MAX invalid
    slot_row: torch.Tensor       # (capacity,) int32 lowest row per group
    capacity: int
    sorted_keys: Optional[torch.Tensor] = None
    sorted_has_max: Optional[torch.Tensor] = None
    count_index: Optional[CountIndex] = None


def next_pow2(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


def _as_sortable(c: torch.Tensor) -> torch.Tensor:
    c = torch.as_tensor(c)
    if c.dtype == torch.bool:
        return c.to(torch.int32)
    return c


def _sorted_runs(key_cols, mask):
    """Stable sort by (invalid, keys..., row), then the dense group id of
    every row in input order.  Returns (gid int32, num_groups 0-d int64,
    s_row int64, s_keys, is_start, run_idx int64), the last four in sorted
    order."""
    key_cols = tuple(_as_sortable(c) for c in key_cols)
    n = key_cols[0].shape[0]
    dev = key_cols[0].device
    invalid = ~torch.as_tensor(mask, dtype=torch.bool, device=dev)
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    for op in reversed((invalid.to(torch.int32),) + key_cols):
        perm = perm[torch.sort(op[perm], stable=True).indices]
    s_invalid = invalid[perm]
    s_keys = [k[perm] for k in key_cols]
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    with sync("hashtable._sorted_runs.first"):
        changed[0] = True
    for k in s_keys:
        changed[1:] |= k[1:] != k[:-1]
    is_start = changed & ~s_invalid
    run_idx = torch.cumsum(is_start.to(torch.int64), 0) - 1
    # scatter back to original row order (one O(n) scatter)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    gid[perm] = torch.where(s_invalid, INT32_MAX, run_idx).to(torch.int32)
    num_groups = torch.where(is_start.any(), run_idx[-1] + 1, 0)
    return gid, num_groups, perm, s_keys, is_start, run_idx


def _group_ids_impl(key_cols, mask, cap: int):
    gid, num_groups, s_row, _s_keys, is_start, run_idx = _sorted_runs(
        key_cols, mask)
    # representative (lowest) row per group: the run start's row id (the
    # sort is stable).  Only the starts are written: a scatter of every
    # other row into one spare slot would queue them all on one address
    with sync("hashtable._group_ids_impl.starts"):
        starts = torch.nonzero(is_start).flatten()
    slot_row = torch.full((cap,), INT32_MAX, dtype=torch.int32,
                          device=gid.device)
    slot_row[run_idx[starts]] = s_row[starts].to(torch.int32)
    return gid, slot_row, num_groups


def build_group_ids(key_cols, mask=None, num_groups_hint: Optional[int] = None,
                    max_probes: int = 256, prepare_count_probe: bool = False):
    """Group rows by key tuple.  Returns (table, gid (n,) int32, capacity).

    gid is a DENSE group id in [0, capacity); masked-out rows get INT32_MAX.
    Equal keys share a gid; the group representative table.slot_row[g] is
    the lowest original row id of group g.  num_groups_hint/max_probes are
    accepted for API compatibility and ignored (sort needs neither).

    prepare_count_probe: also keep the sorted count-probe layout (an extra
    sort of the key column) — join builds pass True, because
    ht_count_matches consumes it; GROUP BY builds never probe and skip it.
    """
    key_cols = tuple(torch.as_tensor(c) for c in key_cols)
    n = key_cols[0].shape[0]
    dev = key_cols[0].device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    if n == 0:
        table = HashTable(key_cols, mask,
                          torch.zeros(0, dtype=torch.int32, device=dev),
                          torch.full((1,), INT32_MAX, dtype=torch.int32,
                                     device=dev), 1)
        return table, torch.zeros(0, dtype=torch.int32, device=dev), 1
    _charge_sort(n, len(key_cols) + 2, "group_by_sort")
    gid, slot_row, num_groups = _group_ids_impl(key_cols, mask, n)
    with sync("hashtable.build_group_ids.groups"):
        cap = max(int(num_groups), 1)       # one host sync, like the
    slot_row = slot_row[:cap]               # reference's table growth
    sorted_keys = has_max = index = None
    if (prepare_count_probe and len(key_cols) == 1
            and _merge_count_eligible(key_cols[0])):
        sorted_keys, has_max = prepare_build(key_cols[0], mask)
        index = build_count_index(sorted_keys)
    table = HashTable(key_cols, mask, gid, slot_row, cap, sorted_keys,
                      has_max, index)
    return table, gid, cap


def _merge_count_eligible(col) -> bool:
    """Single-key count probes take K4 when the key is an integer of <= 32
    bits (wider keys would truncate in its int32 layout).  The test reads
    the storage dtype, which follows the logical type as the JAX package's
    does: UInt16 is stored as int32 and is admitted, as uint16 is there;
    UInt32 is stored widened to int64 and is excluded, as uint32 is
    there."""
    dt = torch.as_tensor(col).dtype
    return (not dt.is_floating_point and not dt.is_complex
            and dt != torch.bool and torch.iinfo(dt).bits <= 32)


def ht_insert(key_cols, mask, capacity: int = 0, max_probes: int = 256):
    """Compatibility wrapper: returns (table, gid, ok=True)."""
    table, gid, _cap = build_group_ids(tuple(key_cols), mask)
    return table, gid, torch.tensor(True)


def group_ids_static(key_cols, mask=None):
    """Dense grouping with no host sync: returns (gid (n,) int32 dense in
    [0, n), INT32_MAX for masked rows; rep_keys: per key column an
    (n,)-sized tensor mapping group id -> key value; num_groups 0-d
    int64).  The capacity is statically n."""
    key_cols = tuple(torch.as_tensor(c) for c in key_cols)
    n = key_cols[0].shape[0]
    dev = key_cols[0].device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    gid, num_groups, _s_row, s_keys, is_start, run_idx = _sorted_runs(
        key_cols, mask)
    # run starts scatter to their group id; every other row to slot n,
    # which is dropped
    tgt = torch.where(is_start, run_idx, n)
    rep_keys = tuple(
        torch.zeros(n + 1, dtype=k.dtype, device=dev).scatter_(0, tgt, k)[:n]
        for k in s_keys)
    return gid, rep_keys, num_groups


def at_run_start(values, run_start, run_idx):
    """Per position, ``values`` at its run's first position: each run start
    scattered to its run's slot (every other position to a dropped slot),
    gathered back by run.  ``run_idx`` is the run index of every position
    (``cumsum(run_start) - 1``)."""
    n = values.shape[0]
    slot = torch.where(run_start, run_idx, n)
    buf = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    buf.scatter_(0, slot, values)
    return buf[run_idx]


def _merged_run_fill(keys_all, rank, payload, extra_payload=()):
    """Core of every lookup: sort the concatenated (build+probe) rows by
    (keys..., rank, payload), then hand each row its key run's
    representative (``at_run_start``).

    Within a key run the sort places valid build rows (rank 0) first,
    ordered by payload ascending — so the run's FIRST element is the lowest
    build payload.  Each run start holds payload+1 if it is a valid build
    row, else 0.

    Returns (s_rank, found_at, rep_payload, extra_sorted): per sorted
    position, whether the run has a valid build row and its payload.
    """
    n = keys_all[0].shape[0]
    dev = keys_all[0].device
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    for op in reversed(tuple(keys_all) + (rank, payload)):
        perm = perm[torch.sort(op[perm], stable=True).indices]
    s_keys = [k[perm] for k in keys_all]
    s_rank = rank[perm]
    s_pay = payload[perm]
    s_extra = tuple(e[perm] for e in extra_payload)
    run_start = torch.zeros(n, dtype=torch.bool, device=dev)
    run_start[0] = True
    for k in s_keys:
        run_start[1:] |= k[1:] != k[:-1]
    run_idx = torch.cumsum(run_start, 0) - 1
    rep = torch.where(run_start & (s_rank == 0), s_pay.to(torch.int64) + 1, 0)
    rep = at_run_start(rep, run_start, run_idx)
    found_at = rep > 0
    rep_payload = (rep - 1).to(torch.int32)
    return s_rank, found_at, rep_payload, s_extra


def _ranks(build_valid, probe_mask, nb, npr):
    dev = build_valid.device
    b_rank = torch.where(torch.as_tensor(build_valid, dtype=torch.bool,
                                         device=dev), 0, 2).to(torch.int32)
    if probe_mask is not None:
        p_rank = torch.where(torch.as_tensor(probe_mask, dtype=torch.bool,
                                             device=dev), 1, 2
                             ).to(torch.int32)
    else:
        p_rank = torch.ones(npr, dtype=torch.int32, device=dev)
    return torch.cat([b_rank, p_rank])


def _cat_keys(build_keys, probe_keys):
    build_keys = tuple(_as_sortable(c) for c in build_keys)
    probe_keys = tuple(_as_sortable(c).to(b.dtype)
                       for c, b in zip(probe_keys, build_keys))
    return tuple(torch.cat([b, p]) for b, p in zip(build_keys, probe_keys))


def _scatter_to_probes(s_rank, s_idx, values, npr, fill):
    """Write the probe rows' values (in sorted order) back to probe order;
    build rows go to a dropped slot."""
    probe_pos = torch.where(s_rank == 1, s_idx, npr)
    out = torch.full((npr + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[probe_pos] = values
    return out[:npr]


def _merge_lookup_impl(build_keys, build_valid, build_gid,
                       probe_keys, probe_mask):
    """Merge lookup: returns (slot (np,), found (np,)) in probe order."""
    nb = build_keys[0].shape[0]
    npr = probe_keys[0].shape[0]
    dev = build_keys[0].device
    keys_all = _cat_keys(build_keys, probe_keys)
    rank = _ranks(build_valid, probe_mask, nb, npr)
    payload = torch.cat([build_gid.to(torch.int32),
                         torch.full((npr,), INT32_MAX, dtype=torch.int32,
                                    device=dev)])
    idx = torch.cat([torch.arange(nb, device=dev),
                     torch.arange(npr, device=dev)])
    s_rank, found_at, rep_gid, (s_idx,) = _merged_run_fill(
        keys_all, rank, payload, (idx,))
    match = (s_rank == 1) & found_at
    found = _scatter_to_probes(s_rank, s_idx, match, npr, False)
    slot = _scatter_to_probes(s_rank, s_idx,
                              torch.where(match, rep_gid, INT32_MAX), npr,
                              INT32_MAX)
    return slot, found


def _merge_count_impl(build_keys, build_valid, probe_keys, probe_mask):
    """Count-only lookup: skips the O(n) scatter back to probe order (used
    when the consumer is order-insensitive, e.g. JOIN feeding an
    aggregate)."""
    nb = build_keys[0].shape[0]
    npr = probe_keys[0].shape[0]
    dev = build_keys[0].device
    keys_all = _cat_keys(build_keys, probe_keys)
    rank = _ranks(build_valid, probe_mask, nb, npr)
    payload = torch.cat([torch.zeros(nb, dtype=torch.int32, device=dev),
                         torch.full((npr,), INT32_MAX, dtype=torch.int32,
                                    device=dev)])
    s_rank, found_at, _rep, _ = _merged_run_fill(keys_all, rank, payload)
    return ((s_rank == 1) & found_at).sum(dtype=torch.int64)


def ht_count_matches(table: HashTable, probe_cols, mask=None) -> torch.Tensor:
    """Number of probe rows whose key exists in the table (order-insensitive
    path: no result scatter), as a 0-d int64 tensor.

    A single narrow-integer key with a cached sorted build side goes to
    K4 (ops/kernels/merge_count.py); multi-column keys and masked probes
    keep the packed merge sort."""
    probe_cols = tuple(torch.as_tensor(c) for c in probe_cols)
    if table.key_cols[0].shape[0] == 0 or probe_cols[0].shape[0] == 0:
        return torch.zeros((), dtype=torch.int64,
                           device=probe_cols[0].device)
    if (len(probe_cols) == 1 and mask is None
            and table.sorted_keys is not None
            and _merge_count_eligible(probe_cols[0])):
        from myscaledb_tpu_torch.runtime.memory import charge
        charge(8 * probe_cols[0].shape[0] * 3, "join_merge_count")
        return merge_count(table.sorted_keys, probe_cols[0],
                           table.sorted_has_max, table.count_index)
    _charge_sort(table.key_cols[0].shape[0] + probe_cols[0].shape[0],
                 len(probe_cols) + 1, "join_count_sort")
    return _merge_count_impl(table.key_cols, table.valid, probe_cols, mask)


def ht_lookup(table: HashTable, probe_cols, mask=None, max_probes: int = 256):
    """Probe the table.  Returns (slot (np,) int32, found (np,) bool); for
    found rows table.slot_row[slot] is the lowest matching build row
    (ANY-join semantics, deterministic)."""
    probe_cols = tuple(torch.as_tensor(c) for c in probe_cols)
    npr = probe_cols[0].shape[0]
    dev = probe_cols[0].device
    if table.key_cols[0].shape[0] == 0 or npr == 0:
        return (torch.full((npr,), INT32_MAX, dtype=torch.int32, device=dev),
                torch.zeros(npr, dtype=torch.bool, device=dev))
    _charge_sort(table.key_cols[0].shape[0] + npr, len(probe_cols) + 3,
                 "join_lookup_sort")
    return _merge_lookup_impl(table.key_cols, table.valid, table.gid_of_row,
                              probe_cols, mask)


def merge_join_any(build_keys, probe_keys, build_valid=None,
                   probe_valid=None):
    """ANY join without host syncs: returns (build_row (np,) int32 with
    INT32_MAX for misses, found (np,) bool) in probe order.  Lowest build
    row per key wins (deterministic)."""
    build_keys = tuple(torch.as_tensor(b) for b in build_keys)
    probe_keys = tuple(torch.as_tensor(p) for p in probe_keys)
    nb = build_keys[0].shape[0]
    npr = probe_keys[0].shape[0]
    dev = build_keys[0].device
    bv = torch.ones(nb, dtype=torch.bool, device=dev) \
        if build_valid is None else torch.as_tensor(build_valid, device=dev)
    keys_all = _cat_keys(build_keys, probe_keys)
    rank = _ranks(bv, probe_valid, nb, npr)
    payload = torch.cat([torch.arange(nb, dtype=torch.int32, device=dev),
                         torch.full((npr,), INT32_MAX, dtype=torch.int32,
                                    device=dev)])
    idx = torch.cat([torch.arange(nb, device=dev),
                     torch.arange(npr, device=dev)])
    s_rank, found_at, rep_row, (s_idx,) = _merged_run_fill(
        keys_all, rank, payload, (idx,))
    match = (s_rank == 1) & found_at
    found = _scatter_to_probes(s_rank, s_idx, match, npr, False)
    build_row = _scatter_to_probes(s_rank, s_idx,
                                   torch.where(match, rep_row, INT32_MAX),
                                   npr, INT32_MAX)
    return build_row, found
