"""Grouped aggregation with mergeable states: the port of
myscaledb_tpu/ops/aggregate.py (``partial_aggregate_matmul``,
``partial_aggregate``, ``merge_states``, ``finalize``,
``streaming_group_aggregate``).

Reference analog: Aggregator::executeImplBatch
(src/Interpreters/Aggregator.cpp:1096) with per-group states merged across
streams (QueryProcessingStage::WithMergeableState).  Dense group ids come
from ops/hashtable.py or the executor's direct mappings; each partial is
computed onto a dense state vector indexed by group id:

  * sum/count/avg: K3 (ops/kernels/group_agg.py) for G <= 256 without
    per-argument validity, else the one-hot matmul histogram
    (ops/aggregate_matmul.py);
  * min/max/any, and sums of 64-bit or unsigned arguments: scatter
    reductions (``partial_aggregate``).

States merge with plain tensor ops: sum/count add, min/max take the
minimum/maximum; avg = (sum, count) is finalized on the host in float64.

Types.  Unsigned columns are stored widened to signed tensors (UInt16 ->
int32, UInt32/64 -> int64; core/types.py), so the routing and the result
type of a sum cannot be read off the tensor.  ``logical_dtypes`` gives, per
argument, the numpy dtype of its logical type; the routing then follows
the JAX package's (``_matmul_kind``).  Sums of unsigned arguments come out
as int64 tensors holding the UInt64 values; the caller types the column.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import to_tensor
from myscaledb_tpu_torch.core.types import TORCH_TO_NUMPY

AGG_FNS = ("sum", "count", "min", "max", "avg", "any")


def _np_dtype(a, logical) -> np.dtype:
    if logical is not None:
        return np.dtype(logical)
    return TORCH_TO_NUMPY[a.dtype]


def _acc_dtype(d: np.dtype) -> torch.dtype:
    """Accumulator dtype for sums: ints widen to 64-bit (ClickHouse
    sum(Int32) -> Int64; unsigned sums, UInt64 there, accumulate in int64
    here), floats stay f32 on the device."""
    if d.kind in "iub":
        return torch.int64
    return torch.float32


def _minmax_identity(t: torch.Tensor, is_min: bool):
    if t.is_floating_point():
        return np.inf if is_min else -np.inf
    info = torch.iinfo(t.dtype)
    return info.max if is_min else info.min


def _matmul_kind(fn: str, arg, logical=None) -> Optional[str]:
    """Matmul/K3 eligibility of one aggregate (None = scatter), from the
    argument's logical dtype."""
    if fn == "count":
        return "count"
    if fn not in ("sum", "avg"):
        return None
    d = _np_dtype(arg, logical)
    if d.kind == "f":
        return "float"
    if d.kind == "b":
        return "int"
    if d.kind == "i" and d.itemsize <= 4:
        return "int"          # int64/uint need the wide path: scatter
    return None


def partial_aggregate_matmul(gid, mask, args, fns: tuple, num_groups: int,
                             arg_valids=None, arg_ranges=None,
                             logical_dtypes=None):
    """partial_aggregate with sum/count/avg routed through K3 for
    G <= 256 (``ops/kernels/group_agg.py``), falling back to the one-hot
    matmul histogram when ineligible (per-arg validity masks, G > 256);
    min/max/any keep the scatter path.  Integer results are exact on
    every route; float sums differ only in accumulation order.
    arg_ranges: per-arg zone-map bounds, passed to K3 (which ignores them).
    logical_dtypes: per-arg numpy dtype of the logical type, or None to
    read it off the tensor."""
    from myscaledb_tpu_torch.ops.aggregate_matmul import \
        matmul_group_aggregate
    from myscaledb_tpu_torch.ops.kernels.group_agg import (group_aggregate,
                                                           MAX_G)
    kinds, mm_args, mm_valids, mm_slots, mm_ranges = [], [], [], [], []
    for i, (fn, a) in enumerate(zip(fns, args)):
        lg = logical_dtypes[i] if logical_dtypes is not None else None
        k = _matmul_kind(fn, a, lg)
        if k is not None:
            kinds.append(k)
            mm_args.append(a if k != "count" else None)
            mm_valids.append(None if arg_valids is None else arg_valids[i])
            mm_ranges.append(arg_ranges[i] if arg_ranges is not None
                             and i < len(arg_ranges) else None)
            mm_slots.append(i)
    scatter_idx = [i for i in range(len(fns)) if i not in mm_slots]

    states: list = [None] * len(fns)
    gc = None
    if mm_slots:
        if num_groups <= MAX_G and all(v is None for v in mm_valids):
            mm_states, gc, mm_counts = group_aggregate(
                gid, mask, tuple(mm_args), tuple(kinds), num_groups,
                arg_ranges=tuple(mm_ranges))
        else:
            mm_states, gc, mm_counts = matmul_group_aggregate(
                gid, mask, tuple(mm_args), tuple(kinds), num_groups,
                tuple(mm_valids))
        for slot, st, cnt in zip(mm_slots, mm_states, mm_counts):
            states[slot] = (st, cnt) if fns[slot] == "avg" else st
    if scatter_idx or gc is None:
        sub_fns = tuple(fns[i] for i in scatter_idx)
        sub_args = tuple(args[i] for i in scatter_idx)
        sub_valids = None if arg_valids is None else tuple(
            arg_valids[i] for i in scatter_idx)
        sc_states, gc2 = partial_aggregate(gid, mask, sub_args, sub_fns,
                                           num_groups, sub_valids)
        if gc is None:
            gc = gc2
        for slot, st in zip(scatter_idx, sc_states):
            states[slot] = st
    return tuple(states), gc


def partial_aggregate(gid, mask, args, fns: tuple, num_groups: int,
                      arg_valids=None):
    """One partial aggregation by scatter reductions.

    gid:  (n,) int group ids in [0, num_groups); rows outside that range
          count nowhere.
    mask: (n,) bool selection (WHERE).
    args: tuple of value tensors, one per agg (None for count(*)).
    fns:  tuple of fn names aligned with args.
    arg_valids: optional tuple of per-agg validity masks (bool (n,)) —
          NULL arguments are skipped per aggregate (count(x) vs count(*)).

    Returns (states, group_count): states is a tuple of per-agg state
    tensors ((G,) or a (sum, count) pair for avg); group_count (G,) int64
    counts selected rows per group so empty groups can be dropped at
    finalize.
    """
    G = num_groups
    n = gid.shape[0]
    dev = gid.device
    gid = gid.long()
    in_range = (gid >= 0) & (gid < G)
    tgt = torch.where(mask.bool() & in_range, gid, G)
    group_count = torch.bincount(tgt, minlength=G + 1)[:G]

    states = []
    for i, (fn, a) in enumerate(zip(fns, args)):
        at = tgt
        acount = group_count
        if arg_valids is not None and arg_valids[i] is not None:
            at = torch.where(mask.bool() & arg_valids[i].bool() & in_range,
                             gid, G)
            acount = torch.bincount(at, minlength=G + 1)[:G]
        if fn == "count":
            states.append(acount)
        elif fn in ("sum", "avg"):
            acc = _acc_dtype(TORCH_TO_NUMPY[a.dtype])
            s = torch.zeros(G + 1, dtype=acc, device=dev).index_add_(
                0, at, a.to(acc))[:G]
            states.append((s, acount) if fn == "avg" else s)
        elif fn in ("min", "max"):
            ident = _minmax_identity(a, fn == "min")
            states.append(torch.full((G + 1,), ident, dtype=a.dtype,
                                     device=dev).scatter_reduce_(
                0, at, a, "amin" if fn == "min" else "amax")[:G])
        elif fn == "any":
            # deterministic 'any' = value of the lowest row id in the group
            ridx = torch.arange(n, dtype=torch.int64, device=dev)
            winner = torch.full((G + 1,), 2 ** 31 - 1, dtype=torch.int64,
                                device=dev).scatter_reduce_(
                0, at, ridx, "amin")[:G]
            zero = torch.zeros((), dtype=a.dtype, device=dev)
            if n == 0:
                states.append(zero.expand(G).clone())
                continue
            safe = torch.clamp(winner, 0, n - 1)
            states.append(torch.where(acount > 0, a[safe], zero))
        else:
            raise ValueError(f"unknown aggregate {fn}")
    return tuple(states), group_count


def merge_states(states_a, states_b, group_count_a, group_count_b, fns):
    """Merge two partial-state sets (same group-id space)."""
    out = []
    for fn, a, b in zip(fns, states_a, states_b):
        if fn in ("sum", "count"):
            out.append(a + b)
        elif fn == "avg":
            out.append((a[0] + b[0], a[1] + b[1]))
        elif fn == "min":
            out.append(torch.minimum(a, b))
        elif fn == "max":
            out.append(torch.maximum(a, b))
        elif fn == "any":
            # keep a's value where a's group non-empty, else b's
            out.append(torch.where(group_count_a > 0, a, b))
        else:
            raise ValueError(fn)
    return tuple(out), group_count_a + group_count_b


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def finalize(states, group_count, fns) -> list[np.ndarray]:
    """Host-side finalization to result columns over ALL group slots; the
    caller filters empty groups with group_count > 0."""
    out = []
    for fn, s in zip(fns, states):
        if fn == "avg":
            ssum = _host(s[0]).astype(np.float64)
            cnt = _host(s[1]).astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                out.append(np.where(cnt > 0, ssum / cnt, np.nan))
        else:
            out.append(_host(s))
    return out


def streaming_group_aggregate(key_cols, mask, args, fns: tuple,
                              arg_valids=None, chunk_rows: int = 8 << 20,
                              device=None):
    """Out-of-device grouped aggregation: stream host-resident columns
    through the card in chunks, aggregate each chunk there, merge the
    (small) per-chunk group states on the host.

    Reference analog: Aggregator external aggregation — partial states
    spilled and merged (Aggregator.cpp:1632 writeToTemporaryFile +
    MergingAggregatedTransform); here "spill" is the columns already living
    in host RAM, so the card never holds more than one chunk.

    key_cols: tuple of 1-D host numpy arrays or tensors (physical key values,
    dictionary ids for strings).  mask: optional (n,) bool.  args /
    arg_valids / fns as partial_aggregate_matmul (fns limited to the
    mergeable set: sum/count/avg/min/max/any; None for count).  device:
    where the chunks go (default: the first tensor's device, else the CPU).

    Returns (rep_keys, states, group_count): rep_keys = tuple of numpy
    arrays (G,) with each group's key values; states finalize()-compatible
    (avg = (sum, count) pair); group_count numpy (G,) int64.
    """
    from myscaledb_tpu_torch.ops.hashtable import build_group_ids, INT32_MAX
    for fn in fns:
        if fn not in AGG_FNS:
            raise ValueError(f"streaming aggregation cannot merge {fn!r}")
    sized = [a for a in (*key_cols, *args, mask) if a is not None]
    if not sized:
        raise ValueError("streaming aggregation needs at least one column")
    if device is None:
        device = next((a.device for a in sized
                       if isinstance(a, torch.Tensor)), torch.device("cpu"))
    n = sized[0].shape[0]
    nk = len(key_cols)
    # the logical dtype of a host argument is its numpy dtype
    logical = tuple(a.dtype if isinstance(a, np.ndarray) else None
                    for a in args)
    chunk_keys: list[tuple] = []
    chunk_states: list[list] = []
    chunk_gc: list[np.ndarray] = []

    def _dev(x, s, e):
        if isinstance(x, torch.Tensor):
            return x[s:e].to(device)
        return to_tensor(x[s:e], device)

    def _upload(s: int, e: int):
        """The host -> device copies of one chunk."""
        kc = tuple(_dev(k, s, e) for k in key_cols)
        mk = _dev(mask, s, e).bool() if mask is not None \
            else torch.ones(e - s, dtype=torch.bool, device=device)
        ag = tuple(_dev(a, s, e) if a is not None else None for a in args)
        av = None
        if arg_valids is not None and any(v is not None for v in arg_valids):
            av = tuple(_dev(v, s, e).bool() if v is not None
                       else torch.ones(e - s, dtype=torch.bool, device=device)
                       for v in arg_valids)
        return kc, mk, ag, av

    bounds = [(s, min(s + chunk_rows, n))
              for s in range(0, max(n, 1), chunk_rows)]
    for s, e in bounds:
        kc, mk, ag, av = _upload(s, e)
        if nk:
            table, gid, cap = build_group_ids(kc, mask=mk)
            rep = _host(table.slot_row)
        else:
            gid, cap = torch.zeros(e - s, dtype=torch.int32,
                                   device=device), 1
            rep = np.zeros(1, dtype=np.int64)
        states, gc = partial_aggregate_matmul(gid, mk, ag, tuple(fns), cap,
                                              av, logical_dtypes=logical)
        gc_np = _host(gc)
        used = gc_np > 0
        if not used.any():
            continue
        rep_used = np.where(rep[: len(used)][used] == INT32_MAX, 0,
                            rep[: len(used)][used])
        chunk_keys.append(tuple(_host(k[s:e])[rep_used] for k in key_cols))
        row = []
        for fn, st in zip(fns, states):
            if fn == "avg":
                row.append((_host(st[0])[used], _host(st[1])[used]))
            else:
                row.append(_host(st)[used])
        chunk_states.append(row)
        chunk_gc.append(gc_np[used].astype(np.int64))
    if not chunk_gc:
        empty_keys = tuple(_host(k[:0]) for k in key_cols)
        empty_states = [(np.zeros(0), np.zeros(0)) if fn == "avg"
                        else np.zeros(0) for fn in fns]
        return empty_keys, empty_states, np.zeros(0, dtype=np.int64)

    keys_all = tuple(np.concatenate([ck[i] for ck in chunk_keys])
                     for i in range(nk))
    gc_all = np.concatenate(chunk_gc)
    m_rows = len(gc_all)
    # final grouping over the (small) union of per-chunk groups
    if nk:
        order = np.lexsort(tuple(keys_all[i] for i in range(nk - 1, -1, -1)))
        run_start = np.zeros(m_rows, dtype=bool)
        run_start[0] = True
        for k in keys_all:
            ks = k[order]
            run_start[1:] |= ks[1:] != ks[:-1]
        gid_sorted = np.cumsum(run_start) - 1
        inv = np.empty(m_rows, dtype=np.int64)
        inv[order] = gid_sorted
        G = int(gid_sorted[-1]) + 1
        # deterministic 'any'/first semantics: lowest input row per group
        first_of = np.full(G, m_rows, dtype=np.int64)
        np.minimum.at(first_of, inv, np.arange(m_rows, dtype=np.int64))
        rep_keys = tuple(k[first_of] for k in keys_all)
    else:
        inv = np.zeros(m_rows, dtype=np.int64)
        G = 1
        first_of = np.zeros(1, dtype=np.int64)
        rep_keys = ()

    gc_out = np.zeros(G, dtype=np.int64)
    np.add.at(gc_out, inv, gc_all)
    out_states = []
    for i, fn in enumerate(fns):
        vals = [cs[i] for cs in chunk_states]
        if fn == "avg":
            s0 = np.concatenate([v[0] for v in vals])
            s1 = np.concatenate([v[1] for v in vals])
            o0 = np.zeros(G, dtype=np.float64)
            o1 = np.zeros(G, dtype=np.float64)
            np.add.at(o0, inv, s0)
            np.add.at(o1, inv, s1)
            out_states.append((o0, o1))
            continue
        v = np.concatenate(vals)
        if fn in ("sum", "count"):
            o = np.zeros(G, dtype=v.dtype)
            np.add.at(o, inv, v)
        elif fn in ("min", "max"):
            o = v[first_of].copy()
            (np.minimum if fn == "min" else np.maximum).at(o, inv, v)
        else:                                   # any: first chunk's value
            o = v[first_of].copy()
        out_states.append(o)
    return rep_keys, out_states, gc_out
