"""Grouping on sorted runs: the grouping half of
myscaledb_tpu/ops/hashtable.py (``HashTable``, ``next_pow2``,
``_as_sortable``, ``_group_ids_impl``, ``build_group_ids``,
``group_ids_static``, ``ht_insert``).

The reference keeps 40+ specialized CPU hash tables for aggregation
(src/Common/HashTable/, src/Interpreters/Aggregator.h:563).  The JAX package
rebuilt grouping on sort, and the port keeps that design so that group ids
and representatives come out identical:

  build   sort rows by (valid, key columns) stably; equal keys become one
          contiguous run; the run's first element (lowest original row id,
          by stability) is the group representative.  Group id = dense run
          index in sorted order.

``lax.sort(..., num_keys, is_stable=True)`` becomes successive stable
``torch.sort``s, least significant key first, starting from the identity
permutation (so ties keep ascending row id).  The probe half (lookups and
the count probe over K4) comes with the joins slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from myscaledb_tpu_torch.errors import NotPortedError

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
    The JAX package's ``sorted_keys2d``/``sorted_has_max`` fields (the
    count-probe layout of K4) come with the joins slice.
    """
    key_cols: tuple              # original build key columns, each (n,)
    valid: torch.Tensor          # (n,) bool
    gid_of_row: torch.Tensor     # (n,) int32 dense group id, INT32_MAX invalid
    slot_row: torch.Tensor       # (capacity,) int32 lowest row per group
    capacity: int


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
    # representative (lowest) row per group: the run start's row id
    tgt = torch.where(is_start, run_idx, cap)
    slot_row = torch.full((cap + 1,), INT32_MAX, dtype=torch.int32,
                          device=gid.device)
    slot_row.scatter_reduce_(0, tgt, s_row.to(torch.int32), "amin")
    return gid, slot_row[:cap], num_groups


def build_group_ids(key_cols, mask=None, num_groups_hint: Optional[int] = None,
                    max_probes: int = 256, prepare_count_probe: bool = False):
    """Group rows by key tuple.  Returns (table, gid (n,) int32, capacity).

    gid is a DENSE group id in [0, capacity); masked-out rows get INT32_MAX.
    Equal keys share a gid; the group representative table.slot_row[g] is
    the lowest original row id of group g.  num_groups_hint/max_probes are
    accepted for API compatibility and ignored (sort needs neither).
    ``prepare_count_probe`` (the K4 count-probe layout) comes with the
    joins slice.
    """
    if prepare_count_probe:
        raise NotPortedError("the count-probe build (prepare_count_probe)",
                             "joins (config 4)")
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
    cap = max(int(num_groups), 1)           # one host sync, like the
    slot_row = slot_row[:cap]               # reference's table growth
    table = HashTable(key_cols, mask, gid, slot_row, cap)
    return table, gid, cap


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
