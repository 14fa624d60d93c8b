"""Aggregation helpers: the port of myscaledb_tpu/sql/agg_fns.py
(``_column_range`` and ``_special_aggregate``).  The -State/-Merge
combinators (``_state_combinator``) come with the next breadth slice.

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

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import Column, to_tensor
from myscaledb_tpu_torch.core.types import Field, DataType
from myscaledb_tpu_torch.sql.ast import Ident
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
    return perm[is_start], s_keys[0][is_start].to(torch.int64)


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
