"""Hash join: build + probe over the sorted-run hash table.  The port of
myscaledb_tpu/ops/join.py (``JoinResult``, ``build_join_table``,
``probe_join_table``, ``DirectTable``, ``hash_join_any``,
``_partition_ids``, ``grace_hash_join_any``, ``grace_hash_join_all``,
``JoinExpansion``, ``hash_join_all``), and the port's sorted build
(``SortedBuild``), which takes the place of ``try_build_direct`` and
``probe_direct``.

Reference analog: HashJoin (src/Interpreters/HashJoin.h:147) — right-table
build, block-at-a-time probe.  ANY joins give at most one match per probe
row, the lowest build row, deterministically (INNER/LEFT, and SEMI/ANTI
from the ``found`` mask); ALL joins fan probe rows out over every matching
build row, with one host synchronisation for the output size.  The grace
variants partition both sides by key hash on the host and join one
partition at a time on the device (GraceHashJoin.cpp).

How a join's keys are matched is decided here alone: ``build_join``
builds the probe structure from what the build keys are, ``probe_any``
gives each probe row its lowest matching build row and ``probe_all``
every match, and ``probe`` answers an ALL join over unique build keys
with the ANY probe.  SQL joins, the broadcast join, joinGet,
``hash_join_any``/``hash_join_all`` and the grace partitions all go
through them.  One integer key is sorted once (``build_sorted``) and
probed without sorting the probe side: by a direct lookup where its keys
occupy a dense range (one pass of K7, ops/kernels/join_probe.py), else
by binary search (``probe_sorted``, ``probe_sorted_all``).  Several
keys, or a float key, take the hash table (``build_join_table``,
``probe_join_table``, ``probe_table_all``): the merge sort of build plus
probe rows (ops/hashtable.py).  Each step charges its tensors to the
query's memory budget (runtime/memory.py).

Join keys are tensors on one device; results come back on it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from myscaledb_tpu_torch.ops.hash import hash32, hash_combine
from myscaledb_tpu_torch.ops.hashtable import (HashTable, build_group_ids,
                                               ht_lookup, INT32_MAX,
                                               _charge_sort)
from myscaledb_tpu_torch.ops.kernels.join_probe import (KEY_DTYPES,
                                                        probe_direct)
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.memory import charge
from myscaledb_tpu_torch.runtime.tracing import sync


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
    analog: DirectJoin, src/Interpreters/DirectJoin.h).  Repeated build
    keys: the lowest row wins (ANY)."""
    lookup: torch.Tensor      # (range,) int32 build row, INT32_MAX = absent
    lo: int


def build_join(build_keys, build_mask=None, probe_rows: int = 0):
    """The build side's probe structure, chosen from its keys: one integer
    key is sorted (``build_sorted``, probed by a direct lookup or by
    binary search; ``probe_rows`` sizes the lookup); several keys, or a
    float key, take the hash table (``build_join_table``)."""
    build_keys = tuple(torch.as_tensor(k) for k in build_keys)
    if sortable_key(build_keys):
        return build_sorted(build_keys[0], build_mask, probe_rows)
    return build_join_table(build_keys, build_mask)


def probe_any(b, probe_keys, probe_mask=None) -> JoinResult:
    """Each probe row's lowest matching build row, from ``build_join``."""
    if isinstance(b, SortedBuild):
        return probe_sorted(b, torch.as_tensor(probe_keys[0]), probe_mask)
    return probe_join_table(b, probe_keys, probe_mask)


def probe_all(b, probe_keys, probe_mask=None) -> JoinExpansion:
    """Every (probe, build) match, from ``build_join``."""
    if isinstance(b, SortedBuild):
        return probe_sorted_all(b, torch.as_tensor(probe_keys[0]),
                                probe_mask)
    return probe_table_all(b, probe_keys, probe_mask)


def probe(b, probe_keys, all_rows: bool):
    """An ANY probe, or with ``all_rows`` an ALL probe.  An ALL join over
    unique build keys is an ANY join: its ``JoinResult`` has the one match
    a probe row can have."""
    if all_rows and not (isinstance(b, SortedBuild) and b.unique):
        return probe_all(b, probe_keys)
    return probe_any(b, probe_keys)


def hash_join_any(build_keys, probe_keys, build_mask=None,
                  probe_mask=None) -> JoinResult:
    b = build_join(build_keys, build_mask, len(probe_keys[0]))
    return probe_any(b, probe_keys, probe_mask)


def _partition_ids(keys, n_partitions: int) -> torch.Tensor:
    """Radix partition id from the HIGH bits of the key hash (the same trick
    as the reference's TwoLevelHashTable bucket byte,
    src/Common/HashTable/TwoLevelHashTable.h)."""
    h = hash32(torch.as_tensor(keys[0]))
    for c in keys[1:]:
        h = hash_combine(h, hash32(torch.as_tensor(c)))
    shift = 32 - (n_partitions.bit_length() - 1)
    return (h >> shift).to(torch.int32)


def rows_to_host(t: torch.Tensor, site: str) -> np.ndarray:
    """A join's row indexes or mask copied to the host, counted in
    ``JoinRowsToHost``."""
    M.increment(M.JOIN_ROWS_TO_HOST, int(t.numel()))
    with sync(site):
        return torch.as_tensor(t).cpu().numpy()


def _grace_partitions(build_keys, probe_keys, build_mask, probe_mask,
                      n_partitions: int):
    """Each partition that both sides reach: its probe and build row ids on
    the host (a row a mask drops is in none) and their keys on the
    device."""
    if n_partitions <= 0 or n_partitions & (n_partitions - 1):
        raise ValueError(f"grace hash join: n_partitions = {n_partitions} "
                         "must be a power of two")
    build_keys = tuple(torch.as_tensor(b) for b in build_keys)
    probe_keys = tuple(torch.as_tensor(p) for p in probe_keys)
    dev = probe_keys[0].device
    with sync("join.grace.partitions"):
        bpid = _partition_ids(build_keys, n_partitions).cpu().numpy()
        ppid = _partition_ids(probe_keys, n_partitions).cpu().numpy()
    if build_mask is not None:
        bpid = np.where(rows_to_host(build_mask, "join.grace.mask"),
                        bpid, -1)
    if probe_mask is not None:
        ppid = np.where(rows_to_host(probe_mask, "join.grace.mask"),
                        ppid, -1)
    for p in range(n_partitions):
        psel = np.flatnonzero(ppid == p)
        bsel = np.flatnonzero(bpid == p)
        if len(psel) and len(bsel):
            ps, bs = torch.as_tensor(psel, device=dev), \
                torch.as_tensor(bsel, device=dev)
            yield psel, bsel, tuple(b[bs] for b in build_keys), \
                tuple(q[ps] for q in probe_keys)


def grace_hash_join_any(build_keys, probe_keys, build_mask=None,
                        probe_mask=None, n_partitions: int = 8) -> JoinResult:
    """Partitioned ANY join for build sides larger than device memory
    (reference: GraceHashJoin.cpp — bucketed spill-to-disk; here partitions
    stay in host RAM and go to the device one at a time)."""
    pk = torch.as_tensor(probe_keys[0])
    found = np.zeros(pk.shape[0], dtype=bool)
    build_row = np.full(pk.shape[0], INT32_MAX, dtype=np.int64)
    for psel, bsel, bkeys, pkeys in _grace_partitions(
            build_keys, probe_keys, build_mask, probe_mask, n_partitions):
        res = hash_join_any(bkeys, pkeys)
        f = rows_to_host(res.found, "join.grace.found")
        br = rows_to_host(res.build_row, "join.grace.rows")
        found[psel] = f
        build_row[psel[f]] = bsel[br[f]]
    return JoinResult(torch.as_tensor(build_row.astype(np.int32),
                                      device=pk.device),
                      torch.as_tensor(found, device=pk.device))


def grace_hash_join_all(build_keys, probe_keys, build_mask=None,
                        probe_mask=None,
                        n_partitions: int = 8) -> JoinExpansion:
    """Partitioned ALL join; output pairs are re-sorted by probe row so the
    result is identical to hash_join_all (within a probe row, matches
    ascend by build row in both)."""
    pk = torch.as_tensor(probe_keys[0])
    dev = pk.device
    found = np.zeros(pk.shape[0], dtype=bool)
    pi_parts, bi_parts = [], []
    for psel, bsel, bkeys, pkeys in _grace_partitions(
            build_keys, probe_keys, build_mask, probe_mask, n_partitions):
        exp = hash_join_all(bkeys, pkeys)
        found[psel] = rows_to_host(exp.found, "join.grace.found")
        pi_parts.append(psel[rows_to_host(exp.probe_idx,
                                           "join.grace.pairs")])
        bi_parts.append(bsel[rows_to_host(exp.build_idx,
                                           "join.grace.pairs")])
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
    Within a probe row, matches ascend by build row."""
    b = build_join(build_keys, build_mask, len(probe_keys[0]))
    return probe_all(b, probe_keys, probe_mask)


def probe_table_all(table: HashTable, probe_keys,
                    probe_mask=None) -> JoinExpansion:
    """Every match through the hash table: build rows are bucketed per
    slot (a stable sort by slot gives contiguous runs); the probe fans out
    with one host sync for the output cardinality."""
    cap = table.capacity
    # bucket build rows by slot: counts, starts, and slot-sorted row ids
    safe_slot = torch.where(table.gid_of_row != INT32_MAX, table.gid_of_row,
                            cap).long()
    counts = torch.bincount(safe_slot, minlength=cap + 1)[:cap]
    rows_by_slot = torch.sort(safe_slot, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts

    pslot, found = ht_lookup(table, probe_keys, mask=probe_mask)
    safe_pslot = torch.where(found, pslot, 0).long()
    match_count = torch.where(found, counts[safe_pslot], 0)
    total = int(match_count.sum())                    # host sync (one)
    return _fan_out(rows_by_slot, starts[safe_pslot], match_count, total,
                    found)


def _fan_out(rows, first, cnt, total: int, found) -> JoinExpansion:
    """The (probe, build) pairs where probe row i matches the ``cnt[i]``
    build rows ``rows[first[i]:first[i] + cnt[i]]``; ``total`` is
    ``cnt.sum()``."""
    dev = cnt.device
    if total == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return JoinExpansion(empty, empty, found)
    probe_idx = torch.repeat_interleave(
        torch.arange(cnt.shape[0], device=dev), cnt, output_size=total)
    offsets = torch.cumsum(cnt, 0) - cnt
    j = torch.arange(total, device=dev) - offsets[probe_idx]
    return JoinExpansion(probe_idx, rows[first[probe_idx] + j], found)


class SortedBuild(NamedTuple):
    """Build side of one integer key, its rows sorted stably by key: equal
    keys are one run, lowest build row first.  ``direct``: a dense lookup
    of each key's lowest build row over the key range, where the range is
    at most 8 times the build rows, 2^16, or a quarter of the probe rows
    (a lookup that size costs less than a binary search a probe row)."""
    keys: torch.Tensor               # (n,) ascending
    rows: torch.Tensor               # (n,) int64 build row of each key
    unique: bool
    direct: Optional[DirectTable]


def sortable_key(keys) -> bool:
    """One integer key column (float keys reach here as their bits)."""
    if len(keys) != 1:
        return False
    k = torch.as_tensor(keys[0])
    return not (k.is_floating_point() or k.is_complex()
                or k.dtype == torch.bool)


def build_sorted(build_key: torch.Tensor, build_mask=None,
                 probe_rows: int = 0) -> SortedBuild:
    """Sort the build side once (rows a mask drops left out); one host
    read of its least and greatest key and whether any key repeats."""
    rows = None
    if build_mask is not None:
        m = torch.as_tensor(build_mask, dtype=torch.bool,
                            device=build_key.device)
        with sync("join.build_sorted.mask"):
            rows = torch.nonzero(m).flatten()
        build_key = build_key.index_select(0, rows)
    n = build_key.shape[0]
    _charge_sort(n, 1, "join_build_sort")
    if build_key.dtype not in (torch.int32, torch.int64):
        build_key = build_key.to(torch.int32)     # narrow ints, losslessly
    keys, order = torch.sort(build_key, stable=True)
    rows = order if rows is None else rows[order]
    if n == 0:
        return SortedBuild(keys, rows, True, None)
    repeats = (keys[1:] == keys[:-1]).any().to(keys.dtype)
    with sync("join.build_sorted"):
        lo, hi, dup = torch.stack([keys[0], keys[-1], repeats]).tolist()
    direct = None
    rng = hi - lo + 1
    if 0 < rng <= max(8 * n, 1 << 16, probe_rows // 4):
        charge(4 * rng, "join_direct_lookup")
        lookup = torch.full((rng,), INT32_MAX, dtype=torch.int32,
                            device=keys.device)
        lookup.scatter_reduce_(0, keys.to(torch.int64) - lo,
                               rows.to(torch.int32), "amin")
        direct = DirectTable(lookup, lo)
    return SortedBuild(keys, rows, not dup, direct)


def _masked(found: torch.Tensor, probe_mask) -> torch.Tensor:
    if probe_mask is None:
        return found
    return found & torch.as_tensor(probe_mask, dtype=torch.bool,
                                   device=found.device)


def _search_keys(b: SortedBuild, probe_key: torch.Tensor):
    """The build keys and the probe keys in one dtype, the wider one."""
    dt = torch.promote_types(b.keys.dtype, probe_key.dtype)
    return b.keys.to(dt), probe_key.to(dt)


def probe_sorted(b: SortedBuild, probe_key: torch.Tensor,
                 probe_mask=None) -> JoinResult:
    """Each probe row's lowest matching build row (ANY), found by the
    direct lookup (K7, ``ops/kernels/join_probe.py``) or by binary search;
    the probe side is never sorted.  Counts each probe by its route in
    ``system.events``: ``DirectProbeJoins`` (and its rows,
    ``DirectProbeRows``) or ``SearchProbeJoins``."""
    npr = probe_key.shape[0]
    dev = probe_key.device
    charge(16 * npr, "join_probe")
    if b.direct is not None:
        M.increment("DirectProbeJoins")
        M.increment("DirectProbeRows", npr)
        if probe_key.dtype not in KEY_DTYPES:
            probe_key = probe_key.to(torch.int64)
        if probe_mask is not None:
            probe_mask = torch.as_tensor(probe_mask, dtype=torch.bool,
                                         device=dev).contiguous()
        return JoinResult(*probe_direct(probe_key.contiguous(),
                                        b.direct.lookup, b.direct.lo,
                                        probe_mask))
    M.increment("SearchProbeJoins")
    n = b.keys.shape[0]
    if n == 0:
        return JoinResult(torch.full((npr,), INT32_MAX, dtype=torch.int32,
                                     device=dev),
                          torch.zeros(npr, dtype=torch.bool, device=dev))
    keys, pk = _search_keys(b, probe_key)
    pos = torch.searchsorted(keys, pk, out_int32=n < INT32_MAX)
    pos = pos.clamp_(max=n - 1)
    found = _masked(keys[pos] == pk, probe_mask)
    row = torch.where(found, b.rows[pos].to(torch.int32), INT32_MAX)
    return JoinResult(row, found)


def probe_sorted_all(b: SortedBuild, probe_key: torch.Tensor,
                     probe_mask=None) -> JoinExpansion:
    """Every (probe, build) match, by probe row, then by build row, from
    two binary searches a probe row and one host read of the output
    size."""
    charge(24 * probe_key.shape[0], "join_probe")
    keys, pk = _search_keys(b, probe_key)
    lo = torch.searchsorted(keys, pk)
    cnt = torch.searchsorted(keys, pk, right=True) - lo
    if probe_mask is not None:
        cnt = torch.where(_masked(cnt > 0, probe_mask), cnt, 0)
    with sync("join.probe_sorted_all.total"):
        total = int(cnt.sum())
    charge(24 * total, "join_pairs")
    return _fan_out(b.rows, lo, cnt, total, cnt > 0)
