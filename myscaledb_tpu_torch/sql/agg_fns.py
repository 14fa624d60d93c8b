"""Aggregation helpers: the port of myscaledb_tpu/sql/agg_fns.py
(``_column_range``, ``_special_aggregate`` and the -State/-Merge
combinators of ``_state_combinator``: ``state_column`` and
``merge_column``).

The special aggregates run on the device where the JAX package's do:

* uniqExact / countDistinct / sumDistinct / avgDistinct take one row per
  distinct (group, value...) tuple.  The JAX package picks each tuple's
  lowest row id with a scatter-min over build_group_ids' groups; the
  port's build_group_ids sorts stably, so that row starts its run and no
  scatter is needed.
* quantile / median / quantileExact* / quantiles: one stable sort by
  (group, value) and one gather per group of element ceil(level n_g) - 1,
  the element ``np.quantile(..., method="inverted_cdf")`` picks on the
  host in the JAX package, so results are equal, not close.
* uniqHLL12 and uniqCombined above ``Settings.uniq_combined_exact_rows``:
  the HLL sketch of ops/hll.py.
* the var/stddev/covar/corr moments: f64 segment sums (another summation
  order than XLA's scatter-add: equal within f64 rounding).
* argMin/argMax/anyLast: scatter-min/max of order codes and row ids.

groupArray/groupUniqArray/topK, the groupBit* reductions and
quantileTDigest assemble on the host per group, as in the JAX package.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from myscaledb_tpu_torch.core.dictionary import StringDictionary
from myscaledb_tpu_torch.core.table import Column, to_tensor
from myscaledb_tpu_torch.core.types import Field, DataType
from myscaledb_tpu_torch.sql.ast import Ident
from myscaledb_tpu_torch.runtime.tracing import sync
from myscaledb_tpu_torch.ops.hash import float_bits_key
from myscaledb_tpu_torch.exec.expr import _full
from myscaledb_tpu_torch.ops.hashtable import (INT32_MAX, _charge_sort,
                                              _sorted_runs)
from myscaledb_tpu_torch.sql.agg_kinds import (UNIQ_KINDS, VAR_KINDS,
                                               COVAR_KINDS, BIT_KINDS)


def _exec():
    """Late import of the (larger) executor module for its shared leaf
    helpers — executor imports THIS module, so a top-level import here
    would re-enter a partially-initialized module."""
    from myscaledb_tpu_torch.sql import executor
    return executor


def _column_range(expr, table):
    """(min, max) bounds for a bare integer column reference, from its zone
    map (built at INSERT) — the JAX package's group-aggregate kernel picks
    its single-limb path with them; K3 accepts and ignores them."""
    if not isinstance(expr, Ident):
        return None
    if expr.name not in table:
        return None
    zm = table[expr.name].zonemap
    if zm is None or not len(zm.mins):
        return None
    if not np.issubdtype(np.asarray(zm.mins).dtype, np.integer):
        return None
    return (int(zm.mins.min()), int(zm.maxs.max()))


_LOGICAL = {torch.int64: DataType.INT64, torch.float64: DataType.FLOAT64,
            torch.float32: DataType.FLOAT32}


def _result(data: torch.Tensor, valid=None) -> Column:
    return Column(Field("x", _LOGICAL[data.dtype], valid is not None),
                  data, valid)


def _valid_mask(m: torch.Tensor, vals) -> torch.Tensor:
    """The rows an aggregate reads: selected, every argument non-NULL."""
    for v in vals:
        if v.valid is not None:
            m = m & v.valid
    return m


def _distinct_key(v, n: int) -> torch.Tensor:
    """Equality key of one argument: dictionary ids, f32 bit patterns for
    floats (the JAX package's float_bits_key), integers as they are."""
    if v.is_array:
        from myscaledb_tpu_torch.exec.arrays import array_row_keys
        return array_row_keys(v, v.data.device)
    data = _full(v, n)
    if v.dictionary is not None:
        return data.to(torch.int32)
    if data.is_floating_point():
        return float_bits_key(data)
    if data.dtype == torch.bool:
        return data.to(torch.int32)
    return data


def _distinct_first_hit(key_vals, gid, vm, n: int):
    """(rows, group of each row): one row per distinct (group, value...)
    tuple among the vm rows.  build_group_ids' stable sort puts each
    tuple's lowest row first in its run, so the run starts are the rows
    the JAX package's scatter-min of row ids picks."""
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=gid.device)
        return empty, empty
    keys = (gid,) + tuple(_distinct_key(v, n) for v in key_vals)
    # budgeted as the JAX package's build_group_ids over the same keys
    _charge_sort(n, len(keys) + 2, "distinct_sort")
    _gid, _ng, perm, s_keys, is_start, _run = _sorted_runs(keys, vm)
    with sync("agg_fns._distinct_first_hit.rows"):
        rows = perm[is_start]
    with sync("agg_fns._distinct_first_hit.groups"):
        groups = s_keys[0][is_start]
    return rows, groups.to(torch.int64)


def _seg_sum(x: torch.Tensor, sel, gid, G: int, dtype) -> torch.Tensor:
    tgt = torch.where(sel, gid.to(torch.int64), G)
    out = torch.zeros(G + 1, dtype=dtype, device=x.device)
    return out.index_add_(0, tgt, x.to(dtype).expand(tgt.shape[0]))[:G]


def _group_sorted(v, gid, vm, G: int, n: int):
    """Values of the vm rows sorted by (group, value), stably, with each
    group's start offset and count: (sorted values, start (G,), count
    (G,))."""
    data = _full(v, n)
    dev = data.device
    rows = torch.nonzero(vm).flatten()
    vals = data[rows]
    g = gid.to(torch.int64)[rows]
    order = torch.sort(vals, stable=True).indices        # NaN sorts last
    order = order[torch.sort(g[order], stable=True).indices]
    count = torch.bincount(g, minlength=G)[:G]
    start = torch.cumsum(count, 0) - count
    return vals[order], start, count


def _inverted_cdf(sorted_vals, start, count, level: float) -> torch.Tensor:
    """np.quantile(..., method="inverted_cdf") per group, as f64: index
    t = n q - 1, rounded up where its fraction is positive, clipped to the
    group; a group holding a NaN gives NaN, an empty group NaN."""
    c = count.to(torch.float64)
    t = c * level - 1.0
    j = torch.floor(t)
    j = j + (t - j > 0).to(torch.float64)
    j = torch.minimum(torch.clamp_min(j, 0.0), torch.clamp_min(c - 1.0, 0.0))
    if sorted_vals.shape[0] == 0:
        return torch.full(count.shape, float("nan"), dtype=torch.float64,
                          device=count.device)
    idx = torch.clamp(start + j.to(torch.int64), 0, sorted_vals.shape[0] - 1)
    out = sorted_vals[idx].to(torch.float64)
    if sorted_vals.is_floating_point():
        last = sorted_vals[torch.clamp(start + count - 1, 0,
                                       sorted_vals.shape[0] - 1)]
        out = torch.where(torch.isnan(last), float("nan"), out)
    return torch.where(count > 0, out, float("nan"))


def _host_groups(v, gid, m, G: int, n: int):
    """(host rows, host group ids with unread rows at G): the layout of the
    JAX package's per-group host loops."""
    vm = _valid_mask(m, [v])
    data = _full(v, n)
    gid_np = torch.where(vm, gid.to(torch.int64), G).cpu().numpy()
    return data.cpu().numpy(), gid_np


def _array_aggregate(kind, v, gid, m, G, present, n, params) -> Column:
    """groupArray / groupUniqArray / topK / quantiles: one array per group
    (reference: AggregateFunctionGroupArray.h / ...GroupUniqArray.h /
    ...TopK.h) — host assembly over the (small) group list, as in the JAX
    package; quantiles gathers on the device."""
    dev = gid.device
    if kind == "quantiles":
        levels = params or [0.5]
        sv, start, count = _group_sorted(v, gid, _valid_mask(m, [v]), G, n)
        pres = torch.as_tensor(present, dtype=torch.int64, device=dev)
        per_level = [_inverted_cdf(sv, start, count, lv)[pres]
                     for lv in levels]
        cnt = count[pres].cpu().numpy()
        table = torch.stack(per_level, 1).cpu().numpy() if per_level else \
            np.zeros((len(present), 0))
        rows = [table[i] if cnt[i] else np.zeros(0)
                for i in range(len(present))]
        elem, dictionary = DataType.FLOAT64, None
        dtype = np.float64
    else:
        data_np, gid_np = _host_groups(v, gid, m, G, n)
        rows = []
        for g in present:
            sel = data_np[gid_np == g]
            if kind == "grouparray":
                out = sel[:params] if params is not None else sel
            elif kind == "groupuniqarray":
                _, first = np.unique(sel, return_index=True)
                out = sel[np.sort(first)]
                if params is not None:
                    out = out[:params]
            else:   # topk
                uniq, counts = np.unique(sel, return_counts=True)
                # count desc, then first-seen order (approximated by value)
                order = np.lexsort((uniq, -counts))
                out = uniq[order][:params or 10]
            rows.append(np.asarray(out))
        dtype = data_np.dtype
        if v.dictionary is not None:
            elem, dictionary = DataType.STRING, v.dictionary
        else:
            elem = _exec()._logical_dtype_of(v.data, v)
            dictionary = None
    lens = np.array([len(r) for r in rows], dtype=np.int64)
    off = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(lens)])
    flat = np.concatenate(rows).astype(dtype) if rows and off[-1] else \
        np.zeros(0, dtype=dtype)
    return Column(Field("x", DataType.ARRAY, elem=elem),
                  to_tensor(flat, dev), None, dictionary, None, off)


def _pick_rows(res_v, winner: torch.Tensor, has: torch.Tensor, n: int
               ) -> Column:
    """The argument's value at one chosen row per group (NULL where the
    group has none)."""
    idx = torch.where(has, winner, 0).to(torch.int64)
    data = _full(res_v, n)
    out_valid = None
    if n == 0:                     # no rows: every group's value is NULL
        out_data = torch.zeros(idx.shape, dtype=data.dtype,
                               device=data.device)
    else:
        out_data = data.index_select(0, idx)
        if res_v.valid is not None:
            out_valid = res_v.valid.index_select(0, idx)
    if not bool(has.all()):
        out_valid = has if out_valid is None else out_valid & has
    dt = _exec()._logical_dtype_of(out_data, res_v)
    return Column(Field("x", dt, out_valid is not None), out_data,
                  out_valid, res_v.dictionary)


def _special_aggregate(kind: str, vals, gid, m, G: int, present, n: int,
                       params=None, settings=None) -> Column:
    """The aggregates outside the mergeable sum/count/min/max/avg states
    (reference: dedicated state classes in
    src/AggregateFunctions/AggregateFunctionUniq.h / ...ArgMinMax.h /
    ...Quantile.h).  gid (n,) int32 group ids, m (n,) bool selected rows,
    present the host ids of the groups to return."""
    from myscaledb_tpu_torch.ops.sort import _ascending_code
    dev = gid.device
    with sync("agg_fns._special_aggregate.present"):
        pres = torch.as_tensor(present, dtype=torch.int64, device=dev)
    if kind in ("grouparray", "groupuniqarray", "topk", "quantiles"):
        return _array_aggregate(kind, vals[0], gid, m, G, present, n, params)
    if kind == "quantiletdigest":
        # t-digest sketch quantile (QuantileTDigest.h): fixed-size centroid
        # state; approximate by design, unlike the exact-sort quantile
        from myscaledb_tpu_torch.ops.tdigest import (build_digest,
                                                     digest_quantile)
        level = params if params is not None else 0.5
        data_np, gid_np = _host_groups(vals[0], gid, m, G, n)
        out = np.full(len(present), np.nan)
        for i, g in enumerate(present):
            sel = data_np[gid_np == g]
            if len(sel):
                out[i] = digest_quantile(*build_digest(sel), level)
        return _result(to_tensor(out.astype(np.float32), dev))
    if kind in ("quantile", "median"):
        # exact quantile (the reference default is sampling-based; exact
        # matches quantileExact)
        level = params if params is not None else 0.5
        sv, start, count = _group_sorted(vals[0], gid,
                                         _valid_mask(m, vals[:1]), G, n)
        return _result(_inverted_cdf(sv, start, count, level)[pres])

    if kind in UNIQ_KINDS:
        exact_cap = getattr(settings, "uniq_combined_exact_rows", 1 << 17) \
            if settings is not None else 1 << 17
        use_sketch = kind == "uniqhll12" or (
            kind == "uniqcombined" and n > exact_cap)
        vm = _valid_mask(m, vals)
        if use_sketch:
            # HLL(2^12) sketch — the reference's uniqHLL12/uniqCombined are
            # approximate (AggregateFunctionUniq.h); uniq/uniqExact here
            # stay exact
            from myscaledb_tpu_torch.ops.hll import (hash_key_columns,
                                                     hll_registers,
                                                     hll_estimate)
            h64 = hash_key_columns([_distinct_key(v, n) for v in vals])
            regs = hll_registers(h64, gid, vm, G)
            return _result(hll_estimate(regs)[pres])
        _rows, groups = _distinct_first_hit(vals, gid, vm, n)
        with sync("agg_fns._special_aggregate.uniq"):
            counts = torch.bincount(groups, minlength=G)[:G]
        return _result(counts[pres])
    if kind in ("sumdistinct", "avgdistinct"):
        vm = _valid_mask(m, vals)
        rows, groups = _distinct_first_hit(vals, gid, vm, n)
        data = _full(vals[0], n)[rows]
        is_float = data.is_floating_point()
        acc = torch.float64 if is_float or kind == "avgdistinct" \
            else torch.int64
        s = torch.zeros(G, dtype=acc, device=dev).index_add_(
            0, groups, data.to(acc))
        if kind == "avgdistinct":
            cnt = torch.bincount(groups, minlength=G)[:G]
            s = s / torch.clamp_min(cnt, 1).to(torch.float64)
            s = torch.where(cnt == 0, float("nan"), s)
        return _result(s[pres])
    if kind in VAR_KINDS:
        # naive Σx/Σx² moments in f64, matching the reference's Float64
        # accumulators (AggregateFunctionStatisticsSimple.h)
        v = vals[0]
        x = _full(v, n).to(torch.float64)
        vm = _valid_mask(m, vals)
        one = torch.ones((), dtype=torch.int64, device=dev)
        cnt = _seg_sum(one, vm, gid, G, torch.int64)
        cntf = cnt.to(torch.float64)
        den = torch.clamp_min(cntf, 1.0)
        mean = _seg_sum(x, vm, gid, G, torch.float64) / den
        var = _seg_sum(x * x, vm, gid, G, torch.float64) / den - mean * mean
        var = torch.clamp_min(var, 0.0)
        if kind in ("varsamp", "stddevsamp"):
            var = torch.where(cnt > 1, var * cntf / (cntf - 1.0),
                              float("nan"))
        var = torch.where(cnt == 0, float("nan"), var)
        if kind.startswith("stddev"):
            var = torch.sqrt(var)
        return _result(var[pres])
    if kind in COVAR_KINDS:
        xv, yv = vals
        xf = _full(xv, n).to(torch.float64)
        yf = _full(yv, n).to(torch.float64)
        vm = _valid_mask(m, vals)
        one = torch.ones((), dtype=torch.int64, device=dev)
        cnt = _seg_sum(one, vm, gid, G, torch.int64)
        cntf = torch.clamp_min(cnt.to(torch.float64), 1.0)
        mx = _seg_sum(xf, vm, gid, G, torch.float64) / cntf
        my = _seg_sum(yf, vm, gid, G, torch.float64) / cntf
        cov = _seg_sum(xf * yf, vm, gid, G, torch.float64) / cntf - mx * my
        if kind == "covarsamp":
            cf = cnt.to(torch.float64)
            cov = torch.where(cnt > 1, cov * cf / (cf - 1.0), float("nan"))
        elif kind == "corr":
            vx = torch.clamp_min(_seg_sum(xf * xf, vm, gid, G, torch.float64)
                                 / cntf - mx * mx, 0.0)
            vy = torch.clamp_min(_seg_sum(yf * yf, vm, gid, G, torch.float64)
                                 / cntf - my * my, 0.0)
            cov = cov / torch.sqrt(vx * vy)
        cov = torch.where(cnt == 0, float("nan"), cov)
        return _result(cov[pres])
    if kind in BIT_KINDS:
        data_np, gid_np = _host_groups(vals[0], gid, m, G, n)
        data_np = data_np.astype(np.int64)
        op = {"groupbitand": np.bitwise_and, "groupbitor": np.bitwise_or,
              "groupbitxor": np.bitwise_xor}[kind]
        ident = np.int64(-1) if kind == "groupbitand" else np.int64(0)
        out = np.full(len(present), ident)
        for i, g in enumerate(present):
            sel = data_np[gid_np == g]
            if len(sel):
                out[i] = op.reduce(sel)
        return _result(to_tensor(out, dev))
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    if kind == "anylast":
        v = vals[0]
        vm = _valid_mask(m, vals)
        winner = torch.full((G + 1,), -1, dtype=torch.int32, device=dev)
        winner.scatter_reduce_(0, torch.where(vm, gid.to(torch.int64), G),
                               rows, "amax")
        w = winner[:G][pres]
        return _pick_rows(v, w, w >= 0, n)
    # argMin / argMax
    res_v, ord_v = vals
    code = _ascending_code(_full(ord_v, n))
    if kind == "argmax":
        code = ~code
    om = _valid_mask(m, [ord_v])
    otgt = torch.where(om, gid.to(torch.int64), G)
    ident = torch.iinfo(code.dtype).max
    best = torch.full((G + 1,), ident, dtype=code.dtype, device=dev)
    best.scatter_reduce_(0, otgt, code, "amin")
    is_best = om & (code == best[torch.clamp(gid.to(torch.int64), 0, G - 1)])
    winner = torch.full((G + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, torch.where(is_best, gid.to(torch.int64), G),
                           rows, "amin")
    w = winner[:G][pres]
    return _pick_rows(res_v, w, w != INT32_MAX, n)


# ---------------------------------------------------------------------------
# -State / -Merge combinators and their state strings

STATE_BASES = {"sum", "count", "min", "max", "avg", "uniq",
               "quantiletdigest"}


def _json_number(x) -> str:
    """x as ``json.dumps`` writes it: an int in decimal, a finite float by
    its repr, NaN/Infinity spelled out, None as null."""
    if x is None or isinstance(x, bool):
        return json.dumps(x)
    if isinstance(x, int) or math.isfinite(x):
        return repr(x)
    return json.dumps(x)


def _encode_states(keys: list, payload: list, fmt) -> tuple:
    """(ids (P,) int32, StringDictionary) of P groups' state strings, in the
    order the JAX package's ``StringDictionary.encode`` gives them: first
    appearance.  Groups whose int64 key rows are equal (keys after the
    first are non-negative) share one string, so each distinct state is
    formatted once on the host: ``fmt(*values)`` over the payload tensors
    at the first group holding it."""
    P = keys[0].shape[0]
    dev = keys[0].device
    if P == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), \
            StringDictionary()
    # one dense id per distinct key row: the first key's, then each next
    # (non-negative, small: a count or a flag) folded in
    _u, inv = torch.unique(keys[0], return_inverse=True)
    for k in keys[1:]:
        _u, inv = torch.unique(inv * (int(k.max()) + 1) + k,
                               return_inverse=True)
    U = _u.shape[0]
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    first = torch.full((U,), P, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, inv, pos, "amin")
    order = torch.argsort(first)
    new_id = torch.empty_like(order)
    new_id[order] = torch.arange(U, dtype=torch.int64, device=dev)
    rep = first[order]
    cols = [p[rep].tolist() for p in payload]
    strings = [fmt(*vals) for vals in zip(*cols)]
    return new_id[inv].to(torch.int32), StringDictionary(strings)


def _f64_bits(x: torch.Tensor) -> torch.Tensor:
    """x's f64 bit patterns, every NaN as one (all print as NaN)."""
    x = x.to(torch.float64)
    return torch.where(torch.isnan(x), float("nan"), x).view(torch.int64)


def _group_order(data: torch.Tensor, gid, vm, G: int):
    """The vm rows' values on the device in (group, row) order, and each
    group's row count: the layout a per-group reduction in row order
    reads."""
    rows = torch.nonzero(vm).flatten()
    g = gid.to(torch.int64)[rows]
    order = torch.sort(g, stable=True).indices
    return data[rows[order]], torch.bincount(g, minlength=G)[:G]


def _host_group_slices(data: torch.Tensor, gid, vm, G: int):
    """_group_order's values on the host, and each group's [start, end)
    in them: a per-group numpy reduction over its slice reads the rows
    the JAX package's ``data_np[gid_np == g]`` does, with no pass over
    all rows per group."""
    vals, count = _group_order(data, gid, vm, G)
    end = torch.cumsum(count, 0)
    return vals.cpu().numpy(), (end - count).cpu().numpy(), end.cpu().numpy()


_NP_BUFSIZE = 8192     # numpy's ufunc buffer: add.reduce sums these in turn
_NP_BLOCK = 128        # pairwise_sum's block: eight lanes below it


def _np_leaf_sums(vals: torch.Tensor, off, m) -> torch.Tensor:
    """pairwise_sum over slices of at most 128 values, as numpy's C loop
    takes them: under 8 values added in turn to 0.0; else eight lanes
    over the whole blocks of 8, the lanes added as a tree, the rest in
    turn."""
    if off.shape[0] == 0:
        return torch.zeros(0, dtype=vals.dtype, device=vals.device)
    cols = torch.arange(_NP_BLOCK, device=vals.device)
    x = vals[torch.clamp(off[:, None] + cols, max=vals.shape[0] - 1)]
    nb = m // 8
    r = x[:, :8]
    for b in range(1, _NP_BLOCK // 8):
        r = torch.where((b < nb)[:, None], r + x[:, 8 * b:8 * b + 8], r)
    tree = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + \
        ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    lanes = m >= 8
    out = torch.where(lanes, tree, 0.0)
    tail = torch.where(lanes, nb * 8, 0)
    for t in range(7):
        p = tail + t
        out = torch.where(p < m, out + x.gather(
            1, torch.clamp(p, max=_NP_BLOCK - 1)[:, None])[:, 0], out)
    return out


def numpy_order_sums(vals: torch.Tensor, count: torch.Tensor
                     ) -> torch.Tensor:
    """(G,) f64: group g's values ``vals[start_g:start_g + count_g]``
    (groups laid out in turn) summed in the order numpy's ``add.reduce``
    takes them, so the result is numpy's ``slice.sum()`` bit for bit:
    8192-value buffers added in turn to 0.0, each buffer by pairwise_sum
    (halves, the first rounded down to a multiple of 8, down to 128
    values; eight lanes within).  The halving tree depends on the counts
    only: it is laid out on the host from one copy of them, and every
    sum runs on the device, all leaves at once, then level by level."""
    dev = vals.device
    vals = vals.to(torch.float64)
    cnt = count.cpu().numpy().astype(np.int64)
    G = cnt.shape[0]
    nch = (cnt + _NP_BUFSIZE - 1) // _NP_BUFSIZE
    first = np.cumsum(nch) - nch
    cg = np.repeat(np.arange(G), nch)
    k = np.arange(cg.shape[0]) - first[cg]
    off = (np.cumsum(cnt) - cnt)[cg] + k * _NP_BUFSIZE
    m = np.minimum(cnt[cg] - k * _NP_BUFSIZE, _NP_BUFSIZE)
    levels = []            # (nodes, which nodes are leaves), root level first
    leaf_off, leaf_m = [], []
    while off.shape[0]:
        split = m > _NP_BLOCK
        levels.append((off.shape[0], ~split))
        leaf_off.append(off[~split])
        leaf_m.append(m[~split])
        so, sm = off[split], m[split]
        n2 = sm // 2
        n2 -= n2 % 8
        off = np.stack([so, so + n2], 1).ravel()
        m = np.stack([n2, sm - n2], 1).ravel()
    # every index the device reads, in one upload (a copy from pageable
    # memory waits for the stream)
    parts = [np.concatenate(leaf_off or [k]), np.concatenate(leaf_m or [k])]
    for _size, is_leaf in reversed(levels):
        parts += [np.flatnonzero(is_leaf), np.flatnonzero(~is_leaf)]
    for j in range(int(nch.max()) if G else 0):
        g = np.flatnonzero(nch > j)
        parts += [g, first[g] + j]
    bounds = np.cumsum([0] + [x.shape[0] for x in parts])
    flat = to_tensor(np.concatenate(parts).astype(np.int64), dev)
    idx = [flat[bounds[i]:bounds[i + 1]] for i in range(len(parts))]
    leaves = _np_leaf_sums(vals, idx[0], idx[1])
    end = leaves.shape[0]
    below, i = None, 2
    for size, is_leaf in reversed(levels):
        nl = int(is_leaf.sum())
        val = torch.empty(size, dtype=torch.float64, device=dev)
        val[idx[i]] = leaves[end - nl:end]
        end -= nl
        if below is not None:
            val[idx[i + 1]] = below[0::2] + below[1::2]
        below, i = val, i + 2
    out = torch.zeros(G, dtype=torch.float64, device=dev)
    for gi, ci in zip(idx[i::2], idx[i + 1::2]):
        out[gi] = out[gi] + below[ci]
    return out


def _uniq_keys(v, data: torch.Tensor) -> torch.Tensor:
    """The 64-bit values uniqState hashes: a String's 8-byte blake2b of
    its value (states of other dictionaries must merge), else the data."""
    if v.dictionary is None:
        return data
    import hashlib
    dv = np.asarray(
        [int.from_bytes(hashlib.blake2b(
            ("" if s is None else s).encode("latin-1", "replace"),
            digest_size=8).digest(), "little")
         for s in v.dictionary.values] or [0], dtype=np.uint64)
    lut = to_tensor(dv.view(np.int64), data.device)
    return lut[torch.clamp(data.long(), 0, len(dv) - 1)]


def _strings_column(strings: list, dev) -> Column:
    """A String column of one state string per group."""
    sd = StringDictionary()
    return Column(Field("x", DataType.STRING),
                  to_tensor(sd.encode(strings), dev), None, sd)


def state_column(base: str, v, gid, m, G: int, present, n: int) -> Column:
    """``<base>State(v)`` per present group: a String column of the
    engine's JSON state strings, byte-identical to the JAX package's
    (``{"f": "sum", "v": ...}``; for uniq the base64 of the 4096 HLL
    registers).  The partials come from one pass over the rows on the
    device — K3 for sum/count and integer min/max up to 256 groups, the
    grouping's segment reductions beyond — and only the distinct states are formatted on the
    host.  Float sums run on the device in numpy's summation order
    (``numpy_order_sums``); only quantileTDigest's digests are built from
    each group's host slice."""
    from myscaledb_tpu_torch.ops.aggregate import partial_aggregate_matmul
    data = _full(v, n)
    vm = _valid_mask(m, [v])
    dev = gid.device
    pres = torch.as_tensor(present, dtype=torch.int64, device=dev)
    is_float = data.is_floating_point()
    if base == "uniq":
        import base64
        from myscaledb_tpu_torch.ops.hll import (hash_key_columns,
                                                 hll_registers)
        # registers of the present groups only: (P, 4096), not (G, 4096)
        rank = torch.full((G + 1,), -1, dtype=torch.int64, device=dev)
        rank[pres] = torch.arange(len(present), device=dev)
        slot = rank[torch.clamp(gid.to(torch.int64), 0, G)]
        regs = hll_registers(hash_key_columns((_uniq_keys(v, data),)),
                             torch.clamp_min(slot, 0), vm & (slot >= 0),
                             len(present))
        return _strings_column(
            [json.dumps({"f": "uniq", "r": base64.b64encode(r.tobytes())
                         .decode()})
             for r in regs.to(torch.uint8).cpu().numpy()], dev)
    if v.dictionary is not None:
        raise _exec().ExecError(f"{base}State over string columns is not "
                                f"supported")
    if base == "quantiletdigest":
        # t-digests are built on the host from each group's slice
        from myscaledb_tpu_torch.ops.tdigest import (build_digest,
                                                     serialize_digest)
        vals, start, end = _host_group_slices(data.to(torch.float64), gid,
                                              vm, G)
        return _strings_column(
            [json.dumps({"f": "qtd", "d": serialize_digest(
                *build_digest(vals[start[g]:end[g]]))}) for g in present],
            dev)
    if is_float and base in ("sum", "avg"):
        # summed on the device in numpy's order: the JAX package's
        # float(slice.sum()) bit for bit
        vals, cnt = _group_order(data.to(torch.float64), gid, vm, G)
        s = numpy_order_sums(vals, cnt)[pres]
        cnt = cnt[pres]
        if base == "sum":
            ids, sd = _encode_states([_f64_bits(s)], [s], lambda x:
                                     '{"f": "sum", "v": %s}' %
                                     _json_number(x))
        else:
            ids, sd = _encode_states(
                [_f64_bits(s), cnt], [s, cnt], lambda x, c:
                '{"f": "avg", "s": %s, "c": %d}' % (_json_number(x), c))
        return Column(Field("x", DataType.STRING), ids, None, sd)
    fn = {"avg": "sum"}.get(base, base)
    states, cnt = partial_aggregate_matmul(
        gid, vm, (None if fn == "count" else data,), (fn,), G, None, None,
        (None,))
    cnt = cnt[pres]
    # the strings json.dumps writes for these dicts, formatted directly
    if fn == "count":
        ids, sd = _encode_states([cnt], [cnt], lambda c:
                                 '{"f": "count", "v": %d}' % c)
    elif base == "sum":
        s = states[0][pres]
        ids, sd = _encode_states([s], [s], lambda x:
                                 '{"f": "sum", "v": %d}' % x)
    elif base == "avg":
        s = states[0][pres]
        ids, sd = _encode_states([s, cnt], [s.to(torch.float64), cnt],
                                 lambda x, c: '{"f": "avg", "s": %s, '
                                 '"c": %d}' % (_json_number(x), c))
    else:   # min / max; None over a group with no value
        x = states[0][pres]
        x64 = x.to(torch.float64) if is_float else x.to(torch.int64)
        key = _f64_bits(x64) if is_float else x64
        empty = cnt == 0
        ids, sd = _encode_states(
            [torch.where(empty, 0, key), empty.to(torch.int64)],
            [x64, empty], lambda val, e: '{"f": "%s", "v": %s}' % (
                base, _json_number(None if e else val)))
    return Column(Field("x", DataType.STRING), ids, None, sd)


def _parse_states(d, device) -> dict:
    """Each distinct state string of a dictionary parsed once: per
    dictionary id its number (as int64 and f64), whether it was a JSON
    float or null, avg's sum and count, uniq's registers (on the device)
    and the t-digests (host)."""
    import base64
    D = max(len(d), 1)       # one spare slot: an empty dictionary indexes 0
    vint = np.zeros(D, dtype=np.int64)
    vf = np.zeros(D, dtype=np.float64)
    isf = np.zeros(D, dtype=bool)
    isnull = np.zeros(D, dtype=bool)
    cnt = np.zeros(D, dtype=np.int64)
    kind = np.zeros(D, dtype=np.int8)         # _PLAIN, _AVG, _UNIQ, _QTD
    regs = None
    digests = [None] * D
    for i, s in enumerate(d.values):
        st = json.loads(s)
        f = st.get("f")
        if f == "uniq":
            if regs is None:
                regs = np.zeros((D, 4096), dtype=np.uint8)
            regs[i] = np.frombuffer(base64.b64decode(st["r"]),
                                    dtype=np.uint8)
            kind[i] = _UNIQ
            continue
        if f == "qtd":
            digests[i] = st["d"]
            kind[i] = _QTD
            continue
        if f == "avg":
            kind[i] = _AVG
        x = st["s"] if f == "avg" else st.get("v")
        if f == "avg":
            cnt[i] = st["c"]
        if x is None:
            isnull[i] = True
        elif isinstance(x, float):
            isf[i] = True
            vf[i] = x
        else:
            vint[i] = x
            vf[i] = float(x)
    return {"vint": to_tensor(vint, device), "vf": to_tensor(vf, device),
            "isf": to_tensor(isf, device), "isnull": to_tensor(isnull,
                                                             device),
            "cnt": to_tensor(cnt, device), "kind": kind,
            "regs": None if regs is None else to_tensor(regs, device),
            "digests": digests}


_PLAIN, _AVG, _UNIQ, _QTD = range(4)


def finalized_states(ps: dict) -> torch.Tensor:
    """(D,) f64: each parsed state finalized (reference:
    finalizeAggregation.cpp) as the JAX package's ``fin`` does it: a
    plain state its value (NaN for null), avg its sum over its count,
    uniq its HLL estimate, a t-digest its median as Float32."""
    from myscaledb_tpu_torch.ops.hll import hll_estimate
    kind = to_tensor(ps["kind"], ps["vf"].device)
    out = torch.where(ps["isnull"], float("nan"), ps["vf"])
    out = torch.where(kind == _AVG, torch.where(
        ps["cnt"] > 0, ps["vf"] / ps["cnt"].to(torch.float64),
        float("nan")), out)
    if ps["regs"] is not None:
        est = hll_estimate(ps["regs"].to(torch.int32)).to(torch.float64)
        out = torch.where(kind == _UNIQ, est, out)
    if (ps["kind"] == _QTD).any():
        from myscaledb_tpu_torch.ops.tdigest import (deserialize_digest,
                                                     digest_quantile)
        q = np.array([float(np.float32(digest_quantile(
            *deserialize_digest(s), 0.5))) if s is not None else np.nan
            for s in ps["digests"]])
        out = torch.where(kind == _QTD, to_tensor(q, out.device), out)
    return out


def parsed_states(session, d, device) -> dict:
    """_parse_states of dictionary ``d``, kept in the session's
    derived-state cache for the current mutation epoch: a -Merge parses
    each distinct state once, not once a row or a query."""
    from myscaledb_tpu_torch.sql.executor import derived_state
    return derived_state(session, ("aggstate", None, (id(d), len(d))), d,
                         lambda: _parse_states(d, device))


def merge_column(base: str, v, gid, m, G: int, present, n: int, level,
                 session) -> Column:
    """``<base>Merge(states)`` per present group, as the JAX package
    merges the parsed states of each group: sums and counts added (Float64
    where any state was a float), min/max over the non-null states (Float64
    with NaN where a group has none), avg's sums over its counts, uniq's
    registers by maximum, t-digests merged.  Every row only gathers its
    state's parsed numbers on the device, and the groups reduce them in one
    segment pass."""
    if v.dictionary is None:
        raise _exec().ExecError(f"{base}Merge expects a state column")
    dev = gid.device
    pres = torch.as_tensor(present, dtype=torch.int64, device=dev)
    ps = parsed_states(session, v.dictionary, dev)
    D = len(v.dictionary)
    ids = _full(v, n).to(torch.int64)
    sel = _valid_mask(m, [v]) & (ids >= 0) & (ids < D)
    # the rows that read a state, compacted once: the reductions below
    # spill no dropped row into a shared slot
    rows = torch.nonzero(sel).flatten()
    idx = ids[rows]
    g = gid.to(torch.int64)[rows]

    def seg(x, reduce="sum", tgt=g):
        if reduce == "sum":
            out = torch.zeros(G + 1, dtype=x.dtype, device=dev)
            return out.index_add_(0, tgt, x)[:G][pres]
        ident = (torch.finfo if x.is_floating_point() else torch.iinfo)(
            x.dtype)
        init = ident.max if reduce == "amin" else ident.min
        out = torch.full((G + 1,), init, dtype=x.dtype, device=dev)
        return out.scatter_reduce_(0, tgt, x, reduce)[:G][pres]

    if base == "uniq":
        from myscaledb_tpu_torch.ops.hll import hll_estimate
        P = len(present)
        regs = torch.zeros((P, 4096), dtype=torch.int32, device=dev)
        if ps["regs"] is not None:
            rank = torch.full((G,), -1, dtype=torch.int64, device=dev)
            rank[pres] = torch.arange(P, device=dev)
            # each (group, state) pair once: its registers join the max
            pair = torch.unique(rank[g] * max(D, 1) + idx)
            cell = (pair // max(D, 1))[:, None] * 4096 + torch.arange(
                4096, device=dev)
            regs.view(-1).scatter_reduce_(
                0, cell.flatten(),
                ps["regs"][pair % max(D, 1)].to(torch.int32).flatten(),
                "amax")
        return _result(hll_estimate(regs))
    if base == "quantiletdigest":
        from myscaledb_tpu_torch.ops.tdigest import (deserialize_digest,
                                                     merge_digests,
                                                     digest_quantile)
        held, start, end = _host_group_slices(
            torch.clamp(ids, 0, max(D - 1, 0)), gid, sel, G)
        out = np.empty(len(present), dtype=np.float32)
        for i, gr in enumerate(present):
            dig = merge_digests([deserialize_digest(ps["digests"][j])
                                 for j in held[start[gr]:end[gr]]])
            out[i] = np.float32(digest_quantile(
                *dig, level if level is not None else 0.5))
        return _result(to_tensor(out, dev))
    any_float = bool(ps["isf"][idx].any())
    if base == "avg":
        tot = seg(ps["vf"][idx])
        c = seg(ps["cnt"][idx])
        return _result(torch.where(c > 0, tot / c.to(torch.float64),
                                   float("nan")))
    x = ps["vf"][idx] if any_float else ps["vint"][idx]
    if base in ("sum", "count"):
        return _result(seg(x))
    # min / max over the non-null states
    has = ~ps["isnull"][idx]
    tgt = torch.where(has, g, G)
    out = seg(x, "amin" if base == "min" else "amax", tgt)
    nvals = seg(has.to(torch.int64), "sum", tgt)
    if bool((nvals == 0).any()):
        return _result(torch.where(nvals > 0, out.to(torch.float64),
                                   float("nan")))
    return _result(out)
