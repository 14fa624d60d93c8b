"""Hash join: build + probe over the sorted-run hash table.  The port of
myscaledb_tpu/ops/join.py (``JoinResult``, ``build_join_table``,
``probe_join_table``, ``DirectTable``, ``try_build_direct``,
``probe_direct``, ``hash_join_any``, ``_partition_ids``,
``grace_hash_join_any``, ``grace_hash_join_all``, ``JoinExpansion``,
``hash_join_all``).

Reference analog: HashJoin (src/Interpreters/HashJoin.h:147) — right-table
build, block-at-a-time probe.  ANY joins give at most one match per probe
row, the lowest build row, deterministically (INNER/LEFT, and SEMI/ANTI
from the ``found`` mask); ALL joins fan probe rows out over every matching
build row, with one host synchronisation for the output size.  The grace
variants partition both sides by key hash on the host and join one
partition at a time on the device (GraceHashJoin.cpp).

Join keys are tensors on one device; results come back on it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from myscaledb_tpu_torch.ops.hash import hash32, hash_combine
from myscaledb_tpu_torch.ops.hashtable import (HashTable, build_group_ids,
                                               ht_lookup, INT32_MAX)


class JoinResult(NamedTuple):
    build_row: torch.Tensor   # (n_probe,) int32 matched build row (INT32_MAX where not found)
    found: torch.Tensor       # (n_probe,) bool


class JoinExpansion(NamedTuple):
    """ALL-join result: matched (probe, build) row pairs, dense."""
    probe_idx: torch.Tensor   # (n_out,) int64
    build_idx: torch.Tensor   # (n_out,) int64
    found: torch.Tensor       # (n_probe,) bool — probe rows with >= 1 match


def build_join_table(build_keys, build_mask=None,
                     num_keys_hint: Optional[int] = None) -> HashTable:
    """Build side -> hash table.  Duplicate keys: lowest row id wins (ANY)."""
    table, _, _ = build_group_ids(tuple(build_keys), mask=build_mask,
                                  num_groups_hint=num_keys_hint,
                                  prepare_count_probe=True)
    return table


def probe_join_table(table: HashTable, probe_keys,
                     probe_mask=None) -> JoinResult:
    slot, found = ht_lookup(table, tuple(probe_keys), mask=probe_mask)
    safe_slot = torch.where(found, slot, 0).long()
    build_row = torch.where(found, table.slot_row[safe_slot], INT32_MAX)
    return JoinResult(build_row, found)


class DirectTable(NamedTuple):
    """Dense-key join table: build row per key via one gather (reference
    analog: DirectJoin, src/Interpreters/DirectJoin.h).  Duplicate build
    keys: lowest row id wins (ANY)."""
    lookup: torch.Tensor      # (range,) int32 build row, INT32_MAX = absent
    lo: int


def try_build_direct(build_keys, build_mask=None,
                     max_range_factor: int = 8) -> Optional[DirectTable]:
    """A DirectTable when the (single, integer) build key occupies a dense
    range; None otherwise."""
    if len(build_keys) != 1:
        return None
    k = torch.as_tensor(build_keys[0])
    if k.is_floating_point() or k.dtype == torch.bool:
        return None
    n = k.shape[0]
    if n == 0:
        return None
    if build_mask is not None:
        m = torch.as_tensor(build_mask, dtype=torch.bool, device=k.device)
        lo = int(torch.where(m, k, torch.iinfo(k.dtype).max).min())
        hi = int(torch.where(m, k, torch.iinfo(k.dtype).min).max())
    else:
        lo, hi = int(k.min()), int(k.max())
    rng = hi - lo + 1
    if rng <= 0 or rng > max(max_range_factor * n, 1 << 16):
        return None
    rows = torch.arange(n, dtype=torch.int32, device=k.device)
    tgt = k.to(torch.int64) - lo
    if build_mask is not None:
        tgt = torch.where(m, tgt, rng)
    lookup = torch.full((rng + 1,), INT32_MAX, dtype=torch.int32,
                        device=k.device)
    lookup.scatter_reduce_(0, tgt, rows, "amin")
    return DirectTable(lookup[:rng], lo)


def probe_direct(table: DirectTable, probe_keys,
                 probe_mask=None) -> JoinResult:
    k = torch.as_tensor(probe_keys[0])
    idx = k.to(torch.int64) - table.lo
    in_range = (idx >= 0) & (idx < table.lookup.shape[0])
    if probe_mask is not None:
        in_range &= torch.as_tensor(probe_mask, dtype=torch.bool,
                                    device=k.device)
    safe = torch.where(in_range, idx, 0)
    row = torch.where(in_range, table.lookup[safe], INT32_MAX)
    return JoinResult(row, row != INT32_MAX)


def hash_join_any(build_keys, probe_keys, build_mask=None,
                  probe_mask=None) -> JoinResult:
    direct = try_build_direct(build_keys, build_mask)
    if direct is not None:
        return probe_direct(direct, probe_keys, probe_mask)
    table = build_join_table(build_keys, build_mask)
    return probe_join_table(table, probe_keys, probe_mask)


def _partition_ids(keys, n_partitions: int) -> torch.Tensor:
    """Radix partition id from the HIGH bits of the key hash (the same trick
    as the reference's TwoLevelHashTable bucket byte,
    src/Common/HashTable/TwoLevelHashTable.h)."""
    h = hash32(torch.as_tensor(keys[0]))
    for c in keys[1:]:
        h = hash_combine(h, hash32(torch.as_tensor(c)))
    shift = 32 - (n_partitions.bit_length() - 1)
    return (h >> shift).to(torch.int32)


def _grace_partitions(build_keys, probe_keys, build_mask, probe_mask,
                      n_partitions: int):
    """Host partition ids of both sides (-1 where a mask drops the row)."""
    if n_partitions <= 0 or n_partitions & (n_partitions - 1):
        raise ValueError(f"grace hash join: n_partitions = {n_partitions} "
                         "must be a power of two")
    bpid = _partition_ids(build_keys, n_partitions).cpu().numpy()
    ppid = _partition_ids(probe_keys, n_partitions).cpu().numpy()
    if build_mask is not None:
        bpid = np.where(torch.as_tensor(build_mask).cpu().numpy(), bpid, -1)
    if probe_mask is not None:
        ppid = np.where(torch.as_tensor(probe_mask).cpu().numpy(), ppid, -1)
    return bpid, ppid


def grace_hash_join_any(build_keys, probe_keys, build_mask=None,
                        probe_mask=None, n_partitions: int = 8) -> JoinResult:
    """Partitioned ANY join for build sides larger than device memory
    (reference: GraceHashJoin.cpp — bucketed spill-to-disk; here partitions
    stay in host RAM and go to the device one at a time)."""
    build_keys = tuple(torch.as_tensor(b) for b in build_keys)
    probe_keys = tuple(torch.as_tensor(p) for p in probe_keys)
    dev = probe_keys[0].device
    n_probe = probe_keys[0].shape[0]
    bpid, ppid = _grace_partitions(build_keys, probe_keys, build_mask,
                                   probe_mask, n_partitions)
    found = np.zeros(n_probe, dtype=bool)
    build_row = np.full(n_probe, INT32_MAX, dtype=np.int64)
    for p in range(n_partitions):
        psel = np.flatnonzero(ppid == p)
        bsel = np.flatnonzero(bpid == p)
        if len(psel) == 0 or len(bsel) == 0:
            continue
        ps, bs = torch.as_tensor(psel, device=dev), \
            torch.as_tensor(bsel, device=dev)
        res = hash_join_any(tuple(b[bs] for b in build_keys),
                            tuple(q[ps] for q in probe_keys))
        f = res.found.cpu().numpy()
        br = res.build_row.cpu().numpy()
        found[psel] = f
        build_row[psel[f]] = bsel[br[f]]
    return JoinResult(torch.as_tensor(build_row.astype(np.int32), device=dev),
                      torch.as_tensor(found, device=dev))


def grace_hash_join_all(build_keys, probe_keys, build_mask=None,
                        probe_mask=None,
                        n_partitions: int = 8) -> JoinExpansion:
    """Partitioned ALL join; output pairs are re-sorted by probe row so the
    result is identical to hash_join_all (within a probe row, matches
    ascend by build row in both)."""
    build_keys = tuple(torch.as_tensor(b) for b in build_keys)
    probe_keys = tuple(torch.as_tensor(p) for p in probe_keys)
    dev = probe_keys[0].device
    n_probe = probe_keys[0].shape[0]
    bpid, ppid = _grace_partitions(build_keys, probe_keys, build_mask,
                                   probe_mask, n_partitions)
    found = np.zeros(n_probe, dtype=bool)
    pi_parts, bi_parts = [], []
    for p in range(n_partitions):
        psel = np.flatnonzero(ppid == p)
        bsel = np.flatnonzero(bpid == p)
        if len(psel) == 0 or len(bsel) == 0:
            continue
        ps, bs = torch.as_tensor(psel, device=dev), \
            torch.as_tensor(bsel, device=dev)
        exp = hash_join_all(tuple(b[bs] for b in build_keys),
                            tuple(q[ps] for q in probe_keys))
        found[psel] = exp.found.cpu().numpy()
        pi_parts.append(psel[exp.probe_idx.cpu().numpy()])
        bi_parts.append(bsel[exp.build_idx.cpu().numpy()])
    if not pi_parts:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return JoinExpansion(empty, empty, torch.as_tensor(found, device=dev))
    pi = np.concatenate(pi_parts)
    bi = np.concatenate(bi_parts)
    order = np.argsort(pi, kind="stable")
    return JoinExpansion(torch.as_tensor(pi[order], device=dev),
                         torch.as_tensor(bi[order], device=dev),
                         torch.as_tensor(found, device=dev))


def hash_join_all(build_keys, probe_keys, build_mask=None,
                  probe_mask=None) -> JoinExpansion:
    """ALL-strictness join: every (probe, build) key match becomes an output
    pair (reference: HashJoin MapsAll row-ref lists, HashJoin.cpp).

    Build rows are bucketed per slot (a stable sort by slot gives
    contiguous runs); the probe fans out with one host sync for the output
    cardinality.  Within a probe row, matches ascend by build row.
    """
    build_keys = tuple(torch.as_tensor(b) for b in build_keys)
    probe_keys = tuple(torch.as_tensor(p) for p in probe_keys)
    n_build = build_keys[0].shape[0]
    dev = probe_keys[0].device
    table, slot_of_build, _ = build_group_ids(
        build_keys, mask=build_mask, num_groups_hint=min(n_build, 1 << 16))
    cap = table.capacity
    # bucket build rows by slot: counts, starts, and slot-sorted row ids
    safe_slot = torch.where(slot_of_build != INT32_MAX, slot_of_build,
                            cap).long()
    counts = torch.bincount(safe_slot, minlength=cap + 1)[:cap]
    rows_by_slot = torch.sort(safe_slot, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts

    pslot, found = ht_lookup(table, probe_keys, mask=probe_mask)
    safe_pslot = torch.where(found, pslot, 0).long()
    match_count = torch.where(found, counts[safe_pslot], 0)
    total = int(match_count.sum())                    # host sync (one)
    if total == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return JoinExpansion(empty, empty, found)
    n_probe = pslot.shape[0]
    probe_idx = torch.repeat_interleave(
        torch.arange(n_probe, device=dev), match_count, output_size=total)
    offsets = torch.cumsum(match_count, 0) - match_count
    j = torch.arange(total, device=dev) - offsets[probe_idx]
    build_idx = rows_by_slot[starts[safe_pslot[probe_idx]] + j]
    return JoinExpansion(probe_idx, build_idx, found)
