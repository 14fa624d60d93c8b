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
  * min/max of integer arguments: K3's min/max lanes for G <= 256 without
    validity of their own (counted as ``K3MinMaxAggregates``);
  * any, min/max of floats, over more than 256 groups or of a Nullable
    argument (``ScatterMinMaxAggregates``), and sums of 64-bit or unsigned
    arguments: scatter reductions (``partial_aggregate``).

The two counters count the min/max aggregates that
``partial_aggregate_matmul`` routes, once each; callers of
``partial_aggregate`` itself (the shuffled GROUP BY of
parallel/shuffle.py) are not counted.

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
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.tracing import sync

AGG_FNS = ("sum", "count", "min", "max", "avg", "any")


def _np_dtype(a, logical) -> np.dtype:
    if logical is not None:
        return np.dtype(logical)
    return TORCH_TO_NUMPY[a.dtype]


def _acc_dtype(d: np.dtype) -> torch.dtype:
    """Accumulator dtype for sums: ints widen to 64-bit (ClickHouse
    sum(Int32) -> Int64; unsigned sums, UInt64 there, accumulate in int64
    here: int64 adds wrap modulo 2^64 as UInt64 adds do, so the int64 bits
    of an unsigned sum are its UInt64 value, which finalize and the result
    column read back as uint64), floats stay f32 on the device."""
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


# The one-hot matmul path takes one (F, B) @ (B, 128) product per row
# block of up to 2^18 rows and group bucket of 128.  Past this many products
# (a 100M-row table grouped into more than ~10,000 keys) its launches cost
# seconds, and sums and counts take the scatter path (index_add_: exact
# int64 sums) instead.
MATMUL_MAX_PRODUCTS = 4096


def _matmul_products(n: int, num_groups: int) -> int:
    from myscaledb_tpu_torch.ops.aggregate_matmul import BLOCK, LO
    return -(-max(n, 1) // BLOCK) * -(-num_groups // LO)


def partial_aggregate_matmul(gid, mask, args, fns: tuple, num_groups: int,
                             arg_valids=None, arg_ranges=None,
                             logical_dtypes=None, route_rows=None):
    """partial_aggregate with sum/count/avg routed through K3 for
    G <= 256 (``ops/kernels/group_agg.py``), falling back to the one-hot
    matmul histogram when ineligible (per-arg validity masks, G > 256)
    unless that takes more than MATMUL_MAX_PRODUCTS products; min/max of
    an integer argument without validity of its own take K3's min/max
    lanes for G <= 256 (in the sums' launch, or alone where the sums take
    the matmul); the rest keeps the scatter path.  Integer results are
    exact on every route; float sums differ only in accumulation order.
    arg_ranges: per-arg zone-map bounds, passed to K3 (which ignores them).
    logical_dtypes: per-arg numpy dtype of the logical type, or None to
    read it off the tensor.
    route_rows: the row count the route is chosen for (the statement's,
    where the caller gathered the kept rows first), so that gathering
    never changes a result's route; None: gid's."""
    from myscaledb_tpu_torch.ops.aggregate_matmul import \
        matmul_group_aggregate
    from myscaledb_tpu_torch.ops.kernels.group_agg import (
        group_aggregate, MAX_G, MINMAX_DTYPES)
    G = num_groups

    def valid(i):
        return None if arg_valids is None else arg_valids[i]

    sums, lanes, scatter_idx = [], [], []   # (slot, K3 kind) / slots
    for i, (fn, a) in enumerate(zip(fns, args)):
        lg = logical_dtypes[i] if logical_dtypes is not None else None
        k = _matmul_kind(fn, a, lg)
        if k is not None:
            sums.append((i, k))
        elif fn in ("min", "max") and G <= MAX_G and valid(i) is None \
                and a.dtype in MINMAX_DTYPES:
            lanes.append((i, fn))
        else:
            scatter_idx.append(i)
    n_minmax = sum(fn in ("min", "max") for fn in fns)
    if lanes:
        M.increment("K3MinMaxAggregates", len(lanes))
    if n_minmax > len(lanes):
        M.increment("ScatterMinMaxAggregates", n_minmax - len(lanes))
    if sums and G <= MAX_G and all(valid(i) is None for i, _k in sums):
        lanes, sums = sorted(sums + lanes), []
    elif sums and G > MAX_G and \
            _matmul_products(gid.shape[0] if route_rows is None
                             else route_rows, G) > MATMUL_MAX_PRODUCTS:
        scatter_idx = sorted(scatter_idx + [i for i, _k in sums])
        sums = []                       # too many one-hot products: scatter

    states: list = [None] * len(fns)
    gc = None
    for route, group in (("k3", lanes), ("matmul", sums)):
        if not group:
            continue
        kinds = tuple(k for _i, k in group)
        g_args = tuple(None if k == "count" else args[i] for i, k in group)
        if route == "k3":
            r_states, r_gc, r_counts = group_aggregate(
                gid, mask, g_args, kinds, G, arg_ranges=tuple(
                    arg_ranges[i] if arg_ranges is not None
                    and i < len(arg_ranges) else None for i, _k in group))
        else:
            r_states, r_gc, r_counts = matmul_group_aggregate(
                gid, mask, g_args, kinds, G,
                tuple(valid(i) for i, _k in group))
        gc = r_gc if gc is None else gc
        for (slot, _k), st, cnt in zip(group, r_states, r_counts):
            states[slot] = (st, cnt) if fns[slot] == "avg" else st
    if scatter_idx or gc is None:
        sc_states, gc2 = partial_aggregate(
            gid, mask, tuple(args[i] for i in scatter_idx),
            tuple(fns[i] for i in scatter_idx), G,
            None if arg_valids is None else tuple(
                arg_valids[i] for i in scatter_idx))
        if gc is None:
            gc = gc2
        for slot, st in zip(scatter_idx, sc_states):
            states[slot] = st
    return tuple(states), gc


def kept_rows_only(mask, gid, m, G: int, args: list, valids: list,
                   min_rows: int):
    """(gid, mask, args, validities) for a grouped aggregation's
    partials: over the rows a WHERE keeps, gathered first when it keeps
    under half of at least ``min_rows`` rows (a count and the gather: two
    host syncs), so no dropped row passes through K3, the matmul histogram
    or a scatter's spare slot, whichever route the aggregation takes; else
    as they are.  Rows keep their order."""
    n = gid.shape[0]
    if mask is None or G <= 1 or n < min_rows:
        return gid, m, args, valids
    with sync("aggregate.kept_rows_only.count"):
        most = int(m.sum()) >= n // 2
    if most:
        return gid, m, args, valids
    with sync("aggregate.kept_rows_only.rows"):
        rows = torch.nonzero(m).flatten()
    return (gid[rows], torch.ones_like(rows, dtype=torch.bool),
            [None if a is None else a[rows] for a in args],
            [None if v is None else v[rows] for v in valids])


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
    group_count = _counts(tgt, G)

    states = []
    for i, (fn, a) in enumerate(zip(fns, args)):
        at = tgt
        acount = group_count
        if arg_valids is not None and arg_valids[i] is not None:
            at = torch.where(mask.bool() & arg_valids[i].bool() & in_range,
                             gid, G)
            acount = _counts(at, G)
        if fn == "count":
            states.append(acount)
        elif fn in ("sum", "avg"):
            acc = _acc_dtype(TORCH_TO_NUMPY[a.dtype])
            if G == 1 and not acc.is_floating_point:
                # one group: a reduction, not n adds into one address
                # (integer sums are exact in any order)
                s = torch.where(at == 0, a.to(acc), 0).sum(dtype=acc) \
                    .reshape(1)
            else:
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


def _counts(tgt: torch.Tensor, G: int) -> torch.Tensor:
    """(G,) int64 rows per group of target slots in [0, G] (G: dropped).
    One group is counted by a reduction: a bincount would queue every row
    on one counter."""
    if G == 1:
        return (tgt == 0).sum(dtype=torch.int64).reshape(1)
    with sync("aggregate._counts"):
        return torch.bincount(tgt, minlength=G + 1)[:G]


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
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    with sync("aggregate._host"):
        return x.cpu().numpy()


def finalize(states, group_count, fns, logical_dtypes=None
             ) -> list[np.ndarray]:
    """Host-side finalization to result columns over ALL group slots; the
    caller filters empty groups with group_count > 0.  ``logical_dtypes``
    (per argument, as ``partial_aggregate_matmul`` takes them) types the
    unsigned ones: an avg reads its int64 sum as uint64, and min/max over
    an empty group give the logical type's identity (the JAX package's:
    UInt64 min 18446744073709551615, max 0), not the storage type's."""
    out = []
    gc = _host(group_count)
    if logical_dtypes is None:
        logical_dtypes = (None,) * len(fns)
    for fn, s, lg in zip(fns, states, logical_dtypes):
        unsigned = lg is not None and np.dtype(lg).kind == "u"
        if fn == "avg":
            ssum = _host(s[0])
            if unsigned:
                ssum = ssum.view(np.uint64)
            ssum = ssum.astype(np.float64)
            cnt = _host(s[1]).astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                out.append(np.where(cnt > 0, ssum / cnt, np.nan))
        elif fn in ("min", "max") and unsigned:
            v = _host(s).astype(lg)
            v[gc[:len(v)] == 0] = np.iinfo(lg).max if fn == "min" else 0
            out.append(v)
        else:
            out.append(_host(s))
    return out


def streaming_group_aggregate(key_cols, mask, args, fns: tuple,
                              arg_valids=None, chunk_rows: int = 8 << 20, *,
                              device):
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
    where the chunks go, required as in ``Env``: host arrays alone do not
    say which device the caller's session runs on.

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
