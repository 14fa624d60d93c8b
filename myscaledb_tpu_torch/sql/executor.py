"""Query execution for SELECT: the port of the vector and aggregation
slices of myscaledb_tpu/sql/executor.py (``VSInfo``, ``_metric_for``,
``_find_distance_call``, ``analyze_vector_search``, ``_apply_vs_fusion``,
``_vector_sidecar``, ``_split_conjuncts``, ``_conjoin``,
``_expand_item_aliases``, ``_value_to_column``, ``_sort_key_from_value``,
``_zonemap_block_mask``, ``_limit_prunable``, ``_group_ids``,
``_mask_or_true``, ``_maybe_streaming_aggregate``, ``run_aggregate``,
``_default_like``, ``_expand_group_levels``, ``_expand_grouping_sets``,
``_totals_table``, ``_materialize_topk``, ``_project``, ``_distinct_rows``,
``execute_select``).

Stage order (SQL semantics): PREWHERE/WHERE -> [vector top-k] ->
[GROUP BY / aggregates -> HAVING] -> SELECT -> DISTINCT -> ORDER BY ->
OFFSET/LIMIT.  ``distance()`` and its metric-named forms fuse with ORDER BY
<distance> LIMIT k into the exact two-stage scan (ops/vector.py).
Aggregates with and without GROUP BY, the -If combinators, HAVING,
DISTINCT, ROLLUP/CUBE/GROUPING SETS and WITH TOTALS run; sum/count/avg go
through K3 (ops/kernels/group_agg.py) for up to 256 groups.  Everything
else the JAX executor does — joins, the special aggregates and the
-State/-Merge combinators, windows, WITH FILL, LIMIT BY, text and hybrid
search, binary vectors, batch_distance, subqueries, UNION and table
functions — raises ``NotPortedError`` naming the slice that brings it.
Error texts the goldens pin stay byte-equal to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from myscaledb_tpu_torch.core.types import (DataType, Field, physical_dtype,
                                            torch_dtype)
from myscaledb_tpu_torch.core.table import (BLOCK_ROWS, Table, Column,
                                            to_tensor, concat_tables)
from myscaledb_tpu_torch.core.dictionary import StringDictionary
from myscaledb_tpu_torch.config import TableSettings
from myscaledb_tpu_torch.errors import ExecError, NotPortedError
from myscaledb_tpu_torch.sql.ast import (Expr, Literal, VectorLiteral, Ident,
                                         Star, BinOp, UnOp, FuncCall, InList,
                                         Between, InSubquery, ScalarSubquery,
                                         ExistsSubquery, Lambda, WindowCall,
                                         SelectQuery, UnionQuery, OrderItem,
                                         SelectItem, walk)
from myscaledb_tpu_torch.sql.render import render, substitute
from myscaledb_tpu_torch.sql.agg_kinds import (AGG_NAMES, SPECIAL_AGGS,
                                               IF_COMBINATORS)
from myscaledb_tpu_torch.sql.agg_fns import _column_range
from myscaledb_tpu_torch.exec.expr import (DIST_FNS, Env, Value, eval_expr,
                                           as_bool_mask, EvalError, _dict_map)
from myscaledb_tpu_torch.ops.hash import float_bits_key
from myscaledb_tpu_torch.ops.hashtable import build_group_ids, INT32_MAX
from myscaledb_tpu_torch.ops.aggregate import (partial_aggregate_matmul,
                                               finalize,
                                               streaming_group_aggregate)
from myscaledb_tpu_torch.ops.vector import (distance_scan, rowwise_distance,
                                            distance_scan_streaming,
                                            build_sq8, precompute_sqnorm,
                                            INVALID_ID)
from myscaledb_tpu_torch.ops.kernels.distance_q import sq8_supported
from myscaledb_tpu_torch.ops.sort import SortKey, sort_permutation, \
    topn_permutation
from myscaledb_tpu_torch.ops.filter import compact_table_host
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.tracing import span

__all__ = ["ExecError", "NotPortedError", "VSInfo", "execute_any",
           "execute_select", "analyze_vector_search"]

TEXT_FNS = {"textsearch", "hybridsearch"}


# ---------------------------------------------------------------------------
# vector-search analysis

@dataclass
class VSInfo:
    call: FuncCall
    name: str                    # render(call)
    alias: Optional[str]
    metric: str
    col: str
    qvec: np.ndarray             # (nq, d) float32
    fused: bool = False
    k: int = 0


def _metric_for(call: FuncCall, tsettings: TableSettings) -> str:
    n = call.name.lower()
    if n == "l2distance":
        return "L2"
    if n == "cosinedistance":
        return "Cosine"
    if n == "dotproduct":
        return "IP"
    return tsettings.float_vector_search_metric_type


def _find_distance_call(q: SelectQuery, alias_exprs: dict):
    exprs = [it.expr for it in q.items]
    exprs += [o.expr for o in q.order_by]
    for e in (q.where, q.prewhere, q.having):
        if e is not None:
            exprs.append(e)
    found: dict = {}                 # render -> node (dedupe repeats of the
    for e in exprs:                  # same call across SELECT/ORDER BY)
        for node in walk(e):
            if isinstance(node, FuncCall) and node.name.lower() in DIST_FNS:
                found.setdefault(render(node), node)
    if len(found) > 1:
        # reference: one search function per query (exact wording asserted
        # by golden 00018_mqvs_multi_distance_funcs)
        raise ExecError(
            "DB::Exception: Not support more than one function of: "
            "distance, batch_distance, TextSearch, HybridSearch")
    return next(iter(found.values()), None)


def analyze_vector_search(q: SelectQuery, session, table: Table,
                          alias_exprs: dict) -> Optional[VSInfo]:
    call = _find_distance_call(q, alias_exprs)
    if call is None:
        return None
    args = list(call.args)
    if len(args) == 3 and isinstance(args[0], Literal) and \
            isinstance(args[0].value, str):
        # parameterized call distance('nprobe = 32')(col, q): the params
        # tune approximate index probes — the exact scan ignores them
        args = args[1:]
    if len(args) != 2:
        raise ExecError(f"{call.name} expects (column, query_vector)")
    col_arg, vec_arg = args
    if not isinstance(col_arg, Ident):
        raise ExecError(f"{call.name}: first argument must be a vector column")
    col = col_arg.name
    if col not in table:
        raise ExecError(f"DB::Exception: There is no column {col!r}.")
    if call.name.lower() == "batch_distance":
        raise NotPortedError("batch_distance()", "sort, windows, LIMIT BY")
    if table[col].field.fixed_len > 0:
        raise NotPortedError("binary vector search", "binary vectors")
    if isinstance(vec_arg, Ident) and vec_arg.name in alias_exprs:
        vec_arg = alias_exprs[vec_arg.name]
    if not isinstance(vec_arg, (VectorLiteral, Ident, Literal)):
        # the JAX package evaluates constant expressions (arrayMap, casts)
        # into the query vector
        raise NotPortedError("computed query vectors",
                             "expression and function breadth")
    if not isinstance(vec_arg, VectorLiteral):
        raise ExecError(f"{call.name}: second argument must be a vector literal")
    if not table[col].dtype.is_vector:
        raise ExecError(f"{call.name}: {col!r} is not a vector column of the table")
    qv = np.asarray(vec_arg.values, dtype=np.float32)
    if qv.size == 0:
        raise ExecError("empty query vector")
    if qv.ndim != 1:
        raise ExecError("distance expects a flat [..] query vector")
    qv = qv[None, :]
    dim = table[col].field.vector_dim
    if qv.shape[1] != dim:
        raise ExecError(f"query vector dim {qv.shape[1]} != column dim {dim}")
    tsettings = session.table_settings.get(table.name, TableSettings())
    alias = None
    for it in q.items:
        if it.alias and render(it.expr) == render(call):
            alias = it.alias
    info = VSInfo(call, render(call), alias, _metric_for(call, tsettings),
                  col, qv)
    return _apply_vs_fusion(info, q)


def _apply_vs_fusion(info: VSInfo, q: SelectQuery) -> VSInfo:
    """Fusion check: ORDER BY <distance expr|alias> [dir matching the
    metric] LIMIT k -> fold the top-k into the scan."""
    alias = info.alias

    def refs_distance(e: Expr) -> bool:
        r = render(e)
        return r == info.name or bool(alias and isinstance(e, Ident)
                                      and e.table is None
                                      and e.name == alias)

    want_asc = info.metric != "IP"
    if (q.order_by and refs_distance(q.order_by[0].expr)
            and q.order_by[0].ascending != want_asc):
        # wrong direction is an ERROR, not a valid bottom-k query
        # (golden 00027_mqvs_check_order_by_for_metric_type)
        raise ExecError(
            "DB::Exception: The ORDER BY direction does not match the "
            f"vector search metric type {info.metric} (expected "
            f"{'ASC' if want_asc else 'DESC'})")
    if (q.order_by and q.limit is not None and not q.group_by
            and refs_distance(q.order_by[0].expr)
            and q.order_by[0].ascending == want_asc):
        info.fused = True
        info.k = q.limit + q.offset
    return info


# ---------------------------------------------------------------------------
# expression helpers

def _expand_item_aliases(e: Expr, alias_exprs: dict, table: Table) -> Expr:
    """Replace Ident(alias) with its SELECT expression (unless the name is a
    real column — real columns win, like the reference's scope rules)."""
    if isinstance(e, Ident) and e.table is None and e.name in alias_exprs \
            and e.name not in table:
        return alias_exprs[e.name]
    if isinstance(e, BinOp):
        return BinOp(e.op, _expand_item_aliases(e.left, alias_exprs, table),
                     _expand_item_aliases(e.right, alias_exprs, table))
    if isinstance(e, UnOp):
        return UnOp(e.op, _expand_item_aliases(e.operand, alias_exprs, table))
    if isinstance(e, FuncCall):
        return FuncCall(e.name, [_expand_item_aliases(a, alias_exprs, table)
                                 for a in e.args], e.distinct)
    if isinstance(e, InList):
        return InList(_expand_item_aliases(e.expr, alias_exprs, table),
                      [_expand_item_aliases(i, alias_exprs, table)
                       for i in e.items], e.negated)
    if isinstance(e, Between):
        return Between(_expand_item_aliases(e.expr, alias_exprs, table),
                       _expand_item_aliases(e.low, alias_exprs, table),
                       _expand_item_aliases(e.high, alias_exprs, table),
                       e.negated)
    return e


def _split_conjuncts(e: Optional[Expr]) -> list:
    if e is None:
        return []
    if isinstance(e, BinOp) and e.op == "AND":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _conjoin(terms: list) -> Optional[Expr]:
    if not terms:
        return None
    out = terms[0]
    for t in terms[1:]:
        out = BinOp("AND", out, t)
    return out


_LOGICAL_OF = {
    torch.bool: DataType.BOOL, torch.int8: DataType.INT8,
    torch.int16: DataType.INT16, torch.int32: DataType.INT32,
    torch.int64: DataType.INT64, torch.uint8: DataType.UINT8,
    torch.float32: DataType.FLOAT32, torch.float64: DataType.FLOAT64,
}


def _logical_dtype_of(data, v: Value) -> DataType:
    if v.dt in (DataType.DATE, DataType.DATETIME):
        return v.dt
    if v.dictionary is not None:
        return DataType.STRING
    dt = _LOGICAL_OF.get(data.dtype)
    if dt is None:
        raise ExecError(f"unsupported result dtype {data.dtype}")
    return dt


def _value_to_column(name: str, v: Value, n: int, device) -> Column:
    data = v.data
    if v.is_array:
        raise NotPortedError("array-valued expressions", "expression and "
                             "function breadth")
    if v.is_scalar:
        if isinstance(v.py, str):
            d = StringDictionary()
            ids = np.full(n, d.encode_one(v.py, grow=True), dtype=np.int32)
            return Column(Field(name, DataType.STRING),
                          to_tensor(ids, device), None, d)
        if isinstance(v.py, list):
            raise NotPortedError("array literals", "expression and "
                                 "function breadth")
    if data.dim() == 0:
        data = data.expand(n).clone()   # constant or scalar-folded (1+1)
    dt = _logical_dtype_of(data, v)
    fld = Field(name, dt, nullable=v.valid is not None)
    return Column(fld, data, v.valid, v.dictionary)


def _sort_key_from_value(v: Value, ascending: bool, nulls_last: bool, n: int,
                         device) -> SortKey:
    data = v.data
    if isinstance(data, np.ndarray):     # host-resident column
        data = to_tensor(data, device)
    if v.is_scalar:
        data = data.expand(n)
    if v.dictionary is not None:
        ranks = v.dictionary.ranks()
        if len(ranks) == 0:
            ranks = np.zeros(1, dtype=np.int32)
        data = _dict_map(Value(data), ranks)
    valid = v.valid
    if isinstance(valid, np.ndarray):
        valid = to_tensor(valid, device)
    return SortKey(data, ascending=ascending, valid=valid,
                   nulls_last=nulls_last)


def _vector_sidecar(session, table_name, table, col):
    """Lazy per-(table, column, mutation epoch) scan artifacts: squared
    norms + the SQ8 certified-quantization sidecar.  Built in one device
    pass on first use; prior-epoch entries are dropped.  A failure to build
    the sidecar raises (the JAX package silently skipped it)."""
    epoch = session._mutation_epoch
    key = (table_name, col, epoch)
    hit = session._vector_sidecars.get(key)
    if hit is not None:
        return hit
    x = table[col].data
    sqn = precompute_sqnorm(x)
    sq8 = None
    if x.dim() == 2 and sq8_supported(x.shape[1]) \
            and x.shape[0] >= (1 << 16):
        sq8 = build_sq8(x)
    out = (sqn, sq8)
    stale = [k for k in session._vector_sidecars if k[2] != epoch]
    for k in stale:
        del session._vector_sidecars[k]
    session._vector_sidecars[key] = out
    return out


def _limit_prunable(q) -> bool:
    """True when evaluating only the first limit+offset base rows is
    row-for-row identical to the full evaluation."""
    if q.order_by or q.group_by or q.distinct or q.joins or \
            q.array_joins or q.limit_by is not None or \
            q.where is not None or q.prewhere is not None or \
            q.having is not None or q.sample is not None:
        return False
    exprs = [it.expr for it in q.items if it.expr is not None]
    exprs += [e for _n, e in getattr(q, "with_aliases", ())]
    for e in exprs:
        for sub in walk(e):
            if isinstance(sub, WindowCall):
                return False
            if isinstance(sub, FuncCall) and sub.name.lower() in AGG_NAMES:
                return False
    return True


def _zonemap_block_mask(table: Table, conjuncts) -> Optional[np.ndarray]:
    """Per-block min/max pruning over the host zone maps.  Returns a boolean
    possible-mask over 64k-row blocks, or None when no term is prunable.
    (The JAX package also consults declared skip indexes, which come with
    the DDL slice.)"""
    def _col_of(e):
        if not isinstance(e, Ident):
            return None
        name = e.qualified if e.table else e.name
        if name not in table:
            return None
        return table[name]

    def _lit_key(col, v):
        """Translate a literal into the column's zone-map key space.
        Returns (ok, key); key None means provably absent."""
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and col.dictionary is None:
            return True, v
        if isinstance(v, str) and col.dictionary is not None:
            did = col.dictionary.encode_one(v)
            return True, (None if did < 0 else did)
        return False, None

    possible = None
    for term in conjuncts:
        ok = None
        if isinstance(term, InList) and not term.negated:
            col = _col_of(term.expr)
            if col is None or col.zonemap is None:
                continue
            zm = col.zonemap
            keys = []
            translatable = True
            for it in term.items:
                if not isinstance(it, Literal):
                    translatable = False
                    break
                t_ok, key = _lit_key(col, it.value)
                if not t_ok:
                    translatable = False
                    break
                if key is not None:
                    keys.append(key)
            if not translatable:
                continue
            ok = np.zeros(len(zm.mins), dtype=bool)
            for key in keys:
                ok |= (zm.mins <= key) & (zm.maxs >= key)
        elif isinstance(term, BinOp) and term.op in ("=", "<", "<=", ">",
                                                     ">="):
            lhs, rhs, op = term.left, term.right, term.op
            if isinstance(rhs, Ident) and isinstance(lhs, Literal):
                lhs, rhs = rhs, lhs
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
            if not (isinstance(lhs, Ident) and isinstance(rhs, Literal)):
                continue
            col = _col_of(lhs)
            if col is None or col.zonemap is None:
                continue
            zm = col.zonemap
            t_ok, lit = _lit_key(col, rhs.value)
            if not t_ok:
                continue
            if col.dictionary is not None:
                # dictionary ids are insertion-ordered: only equality may
                # consult the id zone map
                if op != "=":
                    continue
                if lit is None:
                    ok = np.zeros(len(zm.mins), dtype=bool)
                else:
                    ok = (zm.mins <= lit) & (zm.maxs >= lit)
            elif op == "=":
                ok = (zm.mins <= lit) & (zm.maxs >= lit)
            elif op == "<":
                ok = zm.mins < lit
            elif op == "<=":
                ok = zm.mins <= lit
            elif op == ">":
                ok = zm.maxs > lit
            else:
                ok = zm.maxs >= lit
        if ok is not None:
            possible = ok if possible is None else (possible & ok)
    return possible


def _expand_order_tuples(order_by):
    """ORDER BY (a, b) — tuple syntax — expands to ORDER BY a, b."""
    out = []
    for o in order_by:
        if isinstance(o.expr, FuncCall) and o.expr.name == "tuple":
            for sub in o.expr.args:
                out.append(OrderItem(sub, o.ascending, o.nulls_last))
        else:
            out.append(o)
    return out


# ---------------------------------------------------------------------------
# aggregation

_WIDENED_UNSIGNED = (DataType.UINT16, DataType.UINT32, DataType.UINT64)


def _expr_logical_dtype(e: Expr, v: Value, table: Table) -> DataType:
    """Logical type of an evaluated expression.  A bare column reference
    keeps its column's type — UInt16/32/64 columns are stored widened to
    signed tensors, so the tensor alone cannot tell; anything else is typed
    from its tensor, as ``_logical_dtype_of`` does."""
    if isinstance(e, Ident):
        name = e.qualified if e.table else e.name
        if name in table and v.dictionary is None and v.dt is None:
            return table[name].dtype
    return _logical_dtype_of(v.data, v)


def _group_ids(key_vals: list, n: int, mask, hint: int):
    """Dense group ids for arbitrary key expressions.  Strategy dispatch in
    the spirit of AggregatedDataVariants (Aggregator.h:563): dictionary ids
    and small integer ranges map directly; everything else goes through
    the sorted-run grouping (ops/hashtable.py)."""
    if n == 0:
        dev = key_vals[0].data.device
        return torch.zeros(0, dtype=torch.int32, device=dev), 1, ("empty",)
    if len(key_vals) == 1:
        v = key_vals[0]
        if v.dictionary is not None:
            G = len(v.dictionary) + 1
            gid = (v.data + 1).to(torch.int32)    # NULL_ID(-1) -> group 0
            return gid, G, ("dict", v.dictionary)
        if not v.data.is_floating_point():
            data = v.data.to(torch.int64)
            sel = _mask_or_true(mask, n, data.device)
            lo = int(torch.min(torch.where(sel, data, data[0])))
            hi = int(torch.max(torch.where(sel, data, data[0])))
            rng = hi - lo + 1
            if rng <= max(4 * hint, 1 << 20):
                gid = (data - lo).to(torch.int32)
                return gid, int(rng), ("range", lo, v.data.dtype)
    # hash path
    arrays = []
    for v in key_vals:
        d = v.data
        if v.dictionary is not None:
            arrays.append(d.to(torch.int32))
        elif d.is_floating_point():
            arrays.append(float_bits_key(d))
        else:
            arrays.append(d)
    _table, gid, cap = build_group_ids(tuple(arrays), mask=mask,
                                       num_groups_hint=hint)
    gid = torch.where(gid == INT32_MAX, 0, gid)
    return gid, cap, ("hash",)


def _mask_or_true(mask, n, device):
    return mask if mask is not None else torch.ones(n, dtype=torch.bool,
                                                    device=device)


def _agg_out_type(fn: str, lt: DataType, v: Value) -> Optional[DataType]:
    """The result column's type where the state tensor cannot tell it: a
    sum of an unsigned argument is UInt64 (stored int64), and min/max/any
    keep a Date/DateTime or a widened unsigned argument's type."""
    if fn == "sum" and lt in (DataType.UINT8,) + _WIDENED_UNSIGNED:
        return DataType.UINT64
    if fn in ("min", "max", "any"):
        if v.dt is not None:
            return v.dt
        if lt in _WIDENED_UNSIGNED:
            return lt
    return None


def _maybe_streaming_aggregate(env: Env, q: SelectQuery, mask, session,
                               alias_exprs: dict):
    """Out-of-device GROUP BY: when the aggregation touches host-resident
    columns and every piece is mergeable + a plain column reference, stream
    chunks through the card and merge per-chunk states (reference: external
    aggregation, Aggregator.cpp:1632 writeToTemporaryFile; here host RAM is
    the spill tier).  Returns (agg_table, mapping) or None to fall through
    to the resident path."""
    table = env.table
    dev = env.device
    if table.n_rows == 0:
        return None
    MERGEABLE = {"sum", "count", "avg", "min", "max", "any"}

    def _ident_col(e):
        if not isinstance(e, Ident):
            return None
        name = e.qualified if e.table else e.name
        return table[name] if name in table else None

    # group keys: plain non-null column references
    key_cols = []
    key_names = []
    for k in q.group_by:
        ke = _expand_item_aliases(k, alias_exprs, table)
        col = _ident_col(ke)
        if col is None or col.valid is not None or col.offsets is not None:
            return None
        key_cols.append(col)
        key_names.append(render(ke))
    # aggregate calls: mergeable over plain column references
    agg_calls: dict[str, FuncCall] = {}
    scan_exprs = [it.expr for it in q.items] + [o.expr for o in q.order_by]
    if q.having is not None:
        scan_exprs.append(q.having)
    for e in scan_exprs:
        e = _expand_item_aliases(e, alias_exprs, table)
        for node in walk(e):
            if isinstance(node, FuncCall) and node.name.lower() in AGG_NAMES:
                agg_calls[render(node)] = node
    if not agg_calls:
        return None
    fns, args, arg_valids, names, out_types = [], [], [], [], {}
    for r, call in agg_calls.items():
        name = call.name.lower()
        if name not in MERGEABLE or call.distinct:
            return None
        if name == "count" and (not call.args or
                                isinstance(call.args[0], Star)):
            fns.append("count")
            args.append(None)
            arg_valids.append(None)
            names.append(r)
            continue
        if len(call.args) != 1:
            return None
        col = _ident_col(_expand_item_aliases(call.args[0], alias_exprs,
                                              table))
        if col is None or col.offsets is not None or \
                getattr(col.data, "ndim", 1) != 1:
            return None
        fns.append(name)
        args.append(col)
        arg_valids.append(col.valid)
        names.append(r)
        tag = col.dtype if col.dtype in (DataType.DATE, DataType.DATETIME) \
            else None
        out_types[r] = _agg_out_type(name, col.dtype, Value(None, dt=tag))
    # only stream when a host column is actually involved
    involved = key_cols + [a for a in args if a is not None]
    if not any(c.is_host for c in involved):
        return None

    M.increment("StreamingAggregations")
    rep_keys, states, gc = streaming_group_aggregate(
        tuple(c.data for c in key_cols), mask,
        tuple(a.data if a is not None else None for a in args), tuple(fns),
        tuple(arg_valids) if any(v is not None for v in arg_valids)
        else None,
        chunk_rows=session.settings.stream_chunk_rows, device=dev)
    outs = finalize(states, gc, tuple(fns))
    if not key_cols and len(gc) == 0:
        # global aggregation over an empty selection still yields one row:
        # finalize the SAME identity states the resident path uses
        # (present=[0] over untouched slots)
        def _empty_arg(a):
            if a is None:
                return None
            dt = a.data.dtype if isinstance(a.data, torch.Tensor) \
                else torch_dtype(a.data.dtype)
            return torch.zeros(1, dtype=dt, device=dev)
        id_states, id_gc = partial_aggregate_matmul(
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev),
            tuple(_empty_arg(a) for a in args), tuple(fns), 1,
            logical_dtypes=tuple(
                physical_dtype(a.dtype) if a is not None else None
                for a in args))
        outs = [o[:1] for o in finalize(id_states, id_gc, tuple(fns))]
    cols, mapping = [], {}
    for kname, kcol, rep in zip(key_names, key_cols, rep_keys):
        cols.append(Column(Field(kname, kcol.dtype, False,
                                 kcol.field.vector_dim, kcol.field.elem),
                           to_tensor(rep, dev), None, kcol.dictionary))
        mapping[kname] = kname
    for r, out in zip(names, outs):
        cols.append(Column.from_numpy(r, out, dtype=out_types.get(r),
                                      build_zonemap=False, device=dev))
        mapping[r] = r
    return Table(cols, name=table.name), mapping


def run_aggregate(env: Env, q: SelectQuery, mask, session,
                  alias_exprs: dict) -> tuple[Table, dict]:
    table = env.table
    n = table.n_rows
    dev = env.device
    streamed = _maybe_streaming_aggregate(env, q, mask, session, alias_exprs)
    if streamed is not None:
        return streamed
    # collect aggregate calls across all clauses
    agg_calls: dict[str, FuncCall] = {}
    scan_exprs = [it.expr for it in q.items] + [o.expr for o in q.order_by]
    if q.having is not None:
        scan_exprs.append(q.having)
    for e in scan_exprs:
        e = _expand_item_aliases(e, alias_exprs, table)
        for node in walk(e):
            if isinstance(node, FuncCall) and node.name.lower() in AGG_NAMES:
                for inner in node.args:
                    for sub in walk(inner):
                        if isinstance(sub, FuncCall) and \
                                sub.name.lower() in AGG_NAMES:
                            raise ExecError("nested aggregate functions")
                agg_calls[render(node)] = node

    # per aggregate: fn, argument tensor (None for counts: nothing reads
    # it), its own validity, zone-map range and logical numpy dtype
    fns, args, arg_valids, arg_ranges, logical = [], [], [], [], []
    normal_order: list[str] = []
    out_types = {}
    for r, call in agg_calls.items():
        name = call.name.lower()
        normal_order.append(r)
        if name in IF_COMBINATORS:
            # xIf(args..., cond): fold the condition into the arg validity
            # (reference: AggregateFunctionIf combinator)
            base = IF_COMBINATORS[name]
            if not call.args:
                raise ExecError(f"{call.name} requires a condition argument")
            cond_v = eval_expr(_expand_item_aliases(call.args[-1], alias_exprs,
                                                    table), env)
            cond = as_bool_mask(cond_v, n)
            if base == "count" and len(call.args) == 1:
                fns.append("count")
                args.append(None)
                arg_valids.append(cond)
                arg_ranges.append(None)
                logical.append(None)
                continue
            arg_e = _expand_item_aliases(call.args[0], alias_exprs, table)
            v = eval_expr(arg_e, env)
            lt = _expr_logical_dtype(arg_e, v, table)
            data = v.data.expand(n) if v.is_scalar else v.data
            valid = cond if v.valid is None else cond & v.valid
            fns.append(base)
            args.append(None if base == "count" else data)
            arg_valids.append(valid)
            arg_ranges.append(_column_range(call.args[0], table))
            logical.append(physical_dtype(lt))
            # the JAX package keeps no Date tag on the -If forms
            out_types[r] = _agg_out_type(base, lt, Value(None))
            continue
        if name == "count" and (not call.args or
                                isinstance(call.args[0], Star)):
            fns.append("count")
            args.append(None)
            arg_valids.append(None)
            arg_ranges.append(None)
            logical.append(None)
            continue
        if not call.args:
            raise ExecError(f"{call.name} requires an argument")
        arg_e = _expand_item_aliases(call.args[0], alias_exprs, table)
        v = eval_expr(arg_e, env)
        lt = _expr_logical_dtype(arg_e, v, table)
        data = v.data.expand(n) if v.is_scalar else v.data
        fns.append(name)
        args.append(None if name == "count" else data)
        arg_valids.append(v.valid)
        arg_ranges.append(_column_range(arg_e, table))
        logical.append(physical_dtype(lt))
        out_types[r] = _agg_out_type(name, lt, v)

    # group keys
    key_exprs = [_expand_item_aliases(k, alias_exprs, table)
                 for k in q.group_by]
    key_vals = [eval_expr(k, env) for k in key_exprs]
    for kv in key_vals:
        if kv.is_scalar:
            raise ExecError("GROUP BY constant not supported")

    m = _mask_or_true(mask, n, dev)
    if key_vals:
        gid, G, _strategy = _group_ids(
            key_vals, n, m, session.settings.group_by_capacity_hint)
    else:
        gid, G = torch.zeros(n, dtype=torch.int32, device=dev), 1

    states, gc = partial_aggregate_matmul(gid, m, tuple(args), tuple(fns), G,
                                          tuple(arg_valids),
                                          tuple(arg_ranges), tuple(logical))
    outs = finalize(states, gc, tuple(fns))
    gc_np = gc.cpu().numpy()
    present = np.flatnonzero(gc_np > 0)
    if not key_vals and len(present) == 0:
        present = np.array([0])   # global agg over empty set still yields a row

    # representative row per group (scatter-min of row ids) -> group key
    # output values
    tgt = torch.where(m & (gid >= 0) & (gid < G), gid.to(torch.int64), G)
    rep = torch.full((G + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    rep.scatter_reduce_(0, tgt, torch.arange(n, dtype=torch.int32,
                                             device=dev), "amin")
    rep_np = rep[:G].cpu().numpy()[present]
    rep_np = np.where(rep_np == INT32_MAX, 0, rep_np)
    rep_dev = torch.as_tensor(rep_np, dtype=torch.int64, device=dev)
    del tgt, rep, gid

    cols = []
    mapping = {}
    for ke, kv in zip(key_exprs, key_vals):
        name = render(ke)
        data = kv.data.index_select(0, rep_dev)
        valid = kv.valid.index_select(0, rep_dev) \
            if kv.valid is not None else None
        cols.append(Column(Field(name, _expr_logical_dtype(ke, kv, table),
                                 valid is not None),
                           data, valid, kv.dictionary))
        mapping[name] = name
    for r, out in zip(normal_order, outs):
        cols.append(Column.from_numpy(r, out[present],
                                      dtype=out_types.get(r),
                                      build_zonemap=False, device=dev))
        mapping[r] = r
    return Table(cols, name=table.name), mapping


def _default_like(ref_col: Column, rows: int) -> Column:
    """Default-valued key column for rolled-up subtotal rows (the reference
    fills subtotal key slots with the type default: 0 / '' — RollupTransform
    src/Processors/Transforms/RollupTransform.cpp)."""
    dev = ref_col.data.device
    if ref_col.dictionary is not None or ref_col.dtype is DataType.STRING:
        return Column.from_numpy(ref_col.name,
                                 np.array([""] * rows, dtype=object),
                                 build_zonemap=False, device=dev)
    if ref_col.offsets is not None:
        return Column(ref_col.field, ref_col.data[:0], None,
                      ref_col.dictionary, None,
                      np.zeros(rows + 1, dtype=np.int64))
    data = torch.zeros(rows, dtype=ref_col.data.dtype, device=dev)
    return Column(Field(ref_col.name, ref_col.dtype), data)


def _expand_group_levels(env, q, mask, session, alias_exprs,
                         agg_table: Table) -> Table:
    """GROUP BY … WITH ROLLUP / CUBE: re-aggregate every key-subset level and
    union the levels, missing key columns default-filled (reference:
    RollupStep/CubeStep re-aggregate keyed states level by level)."""
    from dataclasses import replace as dc_replace
    from itertools import combinations
    keys = list(q.group_by)
    idx = list(range(len(keys)))
    if q.group_modifier == "ROLLUP":
        subsets = [tuple(range(i)) for i in range(len(keys) - 1, -1, -1)]
    else:   # CUBE: every proper subset, larger levels first
        subsets = [s for r in range(len(keys) - 1, -1, -1)
                   for s in combinations(idx, r)]
    parts = [agg_table]
    for sub in subsets:
        q2 = dc_replace(q, group_by=[keys[i] for i in sub],
                        group_modifier=None, with_totals=False)
        sub_table, _ = run_aggregate(env, q2, mask, session, alias_exprs)
        out = [sub_table[nm] if nm in sub_table
               else _default_like(agg_table[nm], sub_table.n_rows)
               for nm in agg_table.column_names]
        parts.append(Table(out, name=agg_table.name))
    return concat_tables(parts, name=agg_table.name)


def _expand_grouping_sets(env, q, mask, session, alias_exprs,
                          agg_table: Table) -> Table:
    """GROUP BY GROUPING SETS ((…), …): aggregate once per set and union,
    key columns missing from a set default-filled (reference:
    GroupingSetsStep, src/Processors/QueryPlan/AggregatingStep.cpp
    grouping-sets mode)."""
    from dataclasses import replace as dc_replace
    parts = []
    for st in q.grouping_sets:
        q2 = dc_replace(q, group_by=list(st), grouping_sets=None,
                        group_modifier=None, with_totals=False)
        sub_table, _ = run_aggregate(env, q2, mask, session, alias_exprs)
        out = [sub_table[nm] if nm in sub_table
               else _default_like(agg_table[nm], sub_table.n_rows)
               for nm in agg_table.column_names]
        parts.append(Table(out, name=agg_table.name))
    return concat_tables(parts, name=agg_table.name)


def _totals_table(env, q, mask, session, alias_exprs,
                  agg_table: Table) -> Table:
    """WITH TOTALS: one global-aggregation row, key columns defaulted.
    Computed over all mask-selected rows (totals_mode=before_having; the
    reference default after_having_exclusive differs only under HAVING)."""
    from dataclasses import replace as dc_replace
    q2 = dc_replace(q, group_by=[], group_modifier=None, with_totals=False)
    t, _ = run_aggregate(env, q2, mask, session, alias_exprs)
    out = [t[nm] if nm in t else _default_like(agg_table[nm], t.n_rows)
           for nm in agg_table.column_names]
    return Table(out, name="totals")


# ---------------------------------------------------------------------------
# the slice boundary

# the special aggregates (uniqExact, quantiles, argMin, ...; sql/agg_fns.py
# ``_special_aggregate`` in the JAX package) and the -State/-Merge
# combinator spellings
_UNPORTED_AGGS = SPECIAL_AGGS | {n for n in AGG_NAMES
                                 if n.endswith(("state", "merge"))}


def _reject_unported(q: SelectQuery) -> None:
    """Raise NotPortedError for every clause the JAX executor runs and this
    one does not yet."""
    if q.ctes or q.subquery is not None:
        raise NotPortedError("subqueries and WITH ... AS (SELECT)",
                             "expression and function breadth")
    if getattr(q, "table_function", None) is not None:
        raise NotPortedError(f"table function {q.table_function[0]}()",
                             "storage, formats and runtime state")
    if q.joins:
        raise NotPortedError("JOIN", "joins (config 4)")
    if q.array_joins:
        raise NotPortedError("ARRAY JOIN", "expression and function breadth")
    if q.limit_by is not None:
        raise NotPortedError("LIMIT BY", "sort, windows, LIMIT BY")
    if any(o.fill is not None for o in q.order_by):
        raise NotPortedError("ORDER BY ... WITH FILL",
                             "sort, windows, LIMIT BY")
    if q.sample is not None:
        raise NotPortedError("SAMPLE", "storage, formats and runtime state")
    slots = [it.expr for it in q.items] + [o.expr for o in q.order_by] + \
        [e for e in (q.where, q.prewhere, q.having) if e is not None] + \
        list(q.group_by) + [e for _n, e in q.with_aliases]
    for e in slots:
        for node in walk(e):
            if isinstance(node, WindowCall):
                raise NotPortedError("window functions",
                                     "sort, windows, LIMIT BY")
            if isinstance(node, (InSubquery, ScalarSubquery,
                                 ExistsSubquery)):
                raise NotPortedError("subqueries",
                                     "expression and function breadth")
            if isinstance(node, Lambda):
                raise NotPortedError("lambda functions",
                                     "expression and function breadth")
            if isinstance(node, FuncCall):
                fn = node.name.lower()
                if fn in _UNPORTED_AGGS or (node.distinct and fn in (
                        "count", "sum", "avg")):
                    raise NotPortedError(
                        f"aggregate function {node.name}"
                        f"({'DISTINCT ...' if node.distinct else ''})",
                        "expression and function breadth")
                if fn in TEXT_FNS:
                    raise NotPortedError(f"{node.name}()",
                                         "text and hybrid search")


def execute_any(session, q) -> Table:
    if isinstance(q, UnionQuery):
        raise NotPortedError("UNION / INTERSECT / EXCEPT",
                             "expression and function breadth")
    return execute_select(session, q)


def execute_select(session, q: SelectQuery) -> Table:
    settings = session.settings
    if getattr(q, "settings", None):
        # per-query SETTINGS overrides
        settings = settings.copy()
        for k_, v_ in q.settings.items():
            if hasattr(settings, k_):
                cur = getattr(settings, k_)
                if isinstance(cur, bool):
                    v_ = bool(int(v_)) if not isinstance(v_, str) else \
                        v_.lower() in ("1", "true")
                elif isinstance(cur, int) and not isinstance(v_, str):
                    v_ = int(v_)
                setattr(settings, k_, v_)
    if q.order_by:
        q = SelectQuery(**{**vars(q),
                           "order_by": _expand_order_tuples(q.order_by)})
    _reject_unported(q)
    dev = session.device

    # 1. source
    if q.table is not None:
        try:
            base = session.read_table_checked(q.table)
        except KeyError:
            raise ExecError(f"unknown table {q.table!r}")
    else:
        base = Table([Column.from_numpy("dummy", np.zeros(1, dtype=np.int64),
                                        build_zonemap=False, device=dev)])
    if q.limit is not None and base.n_rows and _limit_prunable(q):
        # LIMIT pushdown into the scan: only limit+offset base rows are
        # evaluated when no clause looks past them
        keep = min(base.n_rows, q.limit + (q.offset or 0))
        if keep < base.n_rows:
            base = base.take(torch.arange(keep, device=dev))
    table = base
    alias_prefixes = {}
    if q.table_alias:
        alias_prefixes[q.table_alias] = ""

    env = Env(table, alias_prefixes, device=dev)
    alias_exprs = {it.alias: it.expr for it in q.items if it.alias}
    for _wname, _wexpr in q.with_aliases:
        alias_exprs.setdefault(_wname, _wexpr)

    # 2. vector-search analysis
    vs = analyze_vector_search(q, session, table, alias_exprs) \
        if q.table is not None else None

    # 3. WHERE/PREWHERE split into pre-search and post-search terms
    def refs_dist(e: Expr) -> bool:
        if vs is None:
            return False
        for node in walk(e):
            if render(node) == vs.name:
                return True
            if isinstance(node, Ident) and node.table is None \
                    and vs.alias and node.name == vs.alias:
                return True
        return False

    conjuncts = _split_conjuncts(q.prewhere) + _split_conjuncts(q.where)
    pre_terms = [c for c in conjuncts if not refs_dist(c)]
    post_terms = [c for c in conjuncts if refs_dist(c)]
    pre_expr = _conjoin([_expand_item_aliases(c, alias_exprs, table)
                         for c in pre_terms])
    # zone-map pruning: if min/max stats prove the filter empty, short-cut
    # the whole scan
    if pre_terms:
        bmask = _zonemap_block_mask(
            table, [_expand_item_aliases(c, alias_exprs, table)
                    for c in pre_terms])
        if bmask is not None and not bmask.all():
            nblocks = int(bmask.sum())
            M.increment("ZonemapPrunedBlocks", len(bmask) - nblocks)
            if nblocks == 0:
                M.increment("ZonemapPrunedScans")
                table = table.head(0)
                env = Env(table, alias_prefixes, device=dev)
                pre_terms, post_terms = [], []
                pre_expr = None
            else:
                # gather only candidate blocks into the scan
                nrows = table.n_rows
                keep = [np.arange(b * BLOCK_ROWS,
                                  min((b + 1) * BLOCK_ROWS, nrows))
                        for b in np.flatnonzero(bmask)]
                idx = np.concatenate(keep)
                M.increment("ZonemapSkippedRows", nrows - len(idx))
                table = table.take(torch.as_tensor(idx, device=dev))
                env = Env(table, alias_prefixes, device=dev)
    mask = None
    if pre_expr is not None:
        mask = as_bool_mask(eval_expr(pre_expr, env), table.n_rows)

    # 4a. fused vector top-k
    if vs is not None and vs.fused:
        M.increment(M.VECTOR_SCAN_QUERIES)
        M.increment(M.VECTOR_SCAN_ROWS, table.n_rows * vs.qvec.shape[0])
        with span("vector_topk", metric=vs.metric, k=vs.k,
                  rows=table.n_rows):
            x = table[vs.col].data
            # rows whose stored vector is invalid never rank
            _vcv = table[vs.col].valid
            if _vcv is not None:
                mask = _vcv if mask is None else mask & _vcv
            qv = torch.as_tensor(vs.qvec, device=dev)
            if table.n_rows == 0:
                d = torch.zeros((vs.qvec.shape[0], 0), device=dev)
                ids = torch.zeros((vs.qvec.shape[0], 0), dtype=torch.int64,
                                  device=dev)
            elif table[vs.col].is_host:
                # out-of-device column: host -> device block stream
                M.increment("StreamedVectorScans")
                d, ids = distance_scan_streaming(
                    x, qv, metric=vs.metric, k=vs.k,
                    mask=None if mask is None else mask.cpu().numpy(),
                    margin=settings.vector_rescore_margin)
            else:
                # the sidecar belongs to the BASE table — pruning replaces
                # the scanned column, so require object identity
                sqn = sq8 = None
                base_tab = session.tables.get(q.table) if q.table else None
                if base_tab is not None and vs.col in base_tab \
                        and base_tab[vs.col].data is x:
                    sqn, sq8 = _vector_sidecar(session, q.table, table,
                                               vs.col)
                d, ids = distance_scan(
                    x, qv, metric=vs.metric, k=vs.k, mask=mask,
                    block_rows=settings.vector_scan_block_rows,
                    x_sqnorm=sqn, sq8=sq8,
                    margin=settings.vector_rescore_margin,
                    oneshot_bytes=settings.max_memory_bytes_per_query)
            table, env = _materialize_topk(table, vs, d, ids, dev)
        mask = None
        # post-search filters on the distance value (WHERE d < x applies
        # AFTER the top-k search)
        if post_terms:
            pe = _conjoin([substitute(c, {vs.name: vs.name})
                           for c in post_terms])
            pm = as_bool_mask(eval_expr(pe, env), table.n_rows)
            table, _ = compact_table_host(table, pm)
            env = Env(table, device=dev)
            if vs.alias and vs.name in table:
                c = table[vs.name]
                env.extra[vs.alias] = Value(c.data, c.valid)
            post_terms = []
    elif vs is not None:
        # non-fused: materialize the full distance column
        dist = rowwise_distance(table[vs.col].data, vs.qvec, vs.metric)
        env.extra[vs.name] = Value(dist)
        if vs.alias:
            env.extra[vs.alias] = Value(dist)
        # post terms can now be evaluated as normal filters (a distance
        # term fails there, as in the JAX package: ROADMAP queue 3)
        if post_terms:
            pe = _conjoin([_expand_item_aliases(c, alias_exprs, table)
                           for c in post_terms])
            pm = as_bool_mask(eval_expr(pe, env), table.n_rows)
            mask = pm if mask is None else mask & pm
            post_terms = []

    # 4b. aggregation
    has_aggs = bool(q.group_by)
    if not has_aggs:
        for it in q.items + [SelectItem(o.expr) for o in q.order_by]:
            e = _expand_item_aliases(it.expr, alias_exprs, table)
            for node in walk(e):
                if isinstance(node, FuncCall) and \
                        node.name.lower() in AGG_NAMES:
                    has_aggs = True
    totals_src = None
    if has_aggs:
        M.increment(M.AGG_ROWS, table.n_rows)
        with span("aggregate", rows=table.n_rows):
            agg_table, mapping = run_aggregate(env, q, mask, session,
                                               alias_exprs)
        if q.grouping_sets is not None:
            agg_table = _expand_grouping_sets(env, q, mask, session,
                                              alias_exprs, agg_table)
        elif q.group_modifier and q.group_by:
            agg_table = _expand_group_levels(env, q, mask, session,
                                             alias_exprs, agg_table)
        if q.with_totals:
            totals_src = _totals_table(env, q, mask, session, alias_exprs,
                                       agg_table)
        # rewrite remaining clauses against the aggregated table
        table = agg_table
        env = Env(table, device=dev)
        mask = None

        def rewrite(e):
            return substitute(_expand_item_aliases(e, alias_exprs, base),
                              mapping)

        items = [SelectItem(rewrite(it.expr), it.alias) for it in q.items]
        having = rewrite(q.having) if q.having is not None else None
        order_by = [OrderItem(rewrite(o.expr), o.ascending, o.nulls_last)
                    for o in q.order_by]
        if having is not None:
            hm = as_bool_mask(eval_expr(having, env), table.n_rows)
            table, _ = compact_table_host(table, hm)
            env = Env(table, device=dev)
        # default deterministic order: by group key columns ascending
        if not order_by and q.group_by:
            order_by = [OrderItem(Ident(render(k)), True, True)
                        for k in q.group_by]
    else:
        items = q.items
        order_by = q.order_by
        if mask is not None:
            table, _ = compact_table_host(table, mask)
            new_env = Env(table, alias_prefixes, device=dev)
            # recompute the non-fused distance on the compacted table
            if vs is not None and not vs.fused and vs.name in env.extra:
                dist = rowwise_distance(table[vs.col].data, vs.qvec,
                                        vs.metric)
                new_env.extra[vs.name] = Value(dist)
                if vs.alias:
                    new_env.extra[vs.alias] = Value(dist)
            env = new_env
            mask = None

    # 5. projection (before sort: aliases must exist as columns for ORDER BY)
    out_cols, out_order = _project(items, env, table, alias_exprs, dev)
    proj_table = Table(out_cols, name=table.name)

    # 5b. DISTINCT (before ORDER BY, SQL semantics): keep the first row of
    # each distinct projected tuple
    if q.distinct and proj_table.n_rows:
        proj_table = _distinct_rows(proj_table)

    # 6. ORDER BY
    if order_by:
        n2 = proj_table.n_rows
        sks = []
        penv = Env(proj_table, device=dev)
        for o in order_by:
            oe = _expand_item_aliases(o.expr, alias_exprs, table)
            # resolve against projected/materialized columns first (a fused
            # distance column exists by its rendered name), then evaluate
            v = None
            for cn in (render(o.expr), render(oe)):
                for t in (proj_table, table):
                    if cn in t:
                        c = t[cn]
                        v = Value(c.data, c.valid, c.dictionary)
                        break
                if v is None and cn in env.extra:
                    v = env.extra[cn]
                if v is not None:
                    break
            if v is None:
                try:
                    v = eval_expr(oe, penv)
                except EvalError:
                    v = eval_expr(oe, env)
            nl = o.nulls_last if o.nulls_last is not None else o.ascending
            sks.append(_sort_key_from_value(v, o.ascending, nl, n2, dev))
        M.increment(M.SORTED_ROWS, n2)
        with span("sort", rows=n2, keys=len(sks)):
            if q.limit is not None:
                perm = topn_permutation(sks, q.limit + q.offset, n2)
            else:
                perm = sort_permutation(sks)
        proj_table = proj_table.take(perm)

    # 8. OFFSET / LIMIT
    if q.limit is not None or q.offset:
        lo = q.offset
        hi = (lo + q.limit) if q.limit is not None else proj_table.n_rows
        idx = torch.arange(lo, min(hi, proj_table.n_rows), device=dev)
        if len(idx) < proj_table.n_rows:
            proj_table = proj_table.take(idx)

    # order output columns as written
    final = proj_table.select(out_order)
    if totals_src is not None:
        tcols, torder = _project(items, Env(totals_src, device=dev),
                                 totals_src, alias_exprs, dev)
        final.totals = Table(tcols, name="totals").select(torder)
    return final


def _materialize_topk(table: Table, vs: VSInfo, d, ids, device):
    """Gather the top-k rows and attach the distance column."""
    d_np = d.cpu().numpy()
    ids_np = ids.cpu().numpy()
    nq = ids_np.shape[0]
    rows, dists = [], []
    for qi in range(nq):
        valid = ids_np[qi] != INVALID_ID
        rows.append(ids_np[qi][valid])
        dists.append(d_np[qi][valid])
    rows = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64)
    gathered = table.take(torch.as_tensor(rows, device=device))
    dist_col = np.concatenate(dists).astype(np.float32) if dists else \
        np.zeros(0, dtype=np.float32)
    col = Column(Field(vs.name, DataType.FLOAT32), to_tensor(dist_col,
                                                             device))
    gathered = gathered.with_column(col)
    env = Env(gathered, device=device)
    if vs.alias:
        env.extra[vs.alias] = Value(col.data, col.valid)
    return gathered, env


def _project(items, env: Env, table: Table, alias_exprs, device):
    out_cols: list[Column] = []
    out_order: list[str] = []
    seen = set()
    n = table.n_rows
    for it in items:
        if isinstance(it.expr, Star):
            for c in table.columns.values():
                if c.name.startswith("__"):
                    continue   # hidden columns
                if c.name not in seen:
                    out_cols.append(c)
                    out_order.append(c.name)
                    seen.add(c.name)
            continue
        e = _expand_item_aliases(it.expr, alias_exprs, table)
        name = it.alias or render(it.expr)
        if name in seen:
            # repeated select item: the reference emits both columns under
            # one display name; Table keys are unique, so suffix \x00k
            k = 2
            while f"{name}\x00{k}" in seen:
                k += 1
            name = f"{name}\x00{k}"
        # direct column reference (or an already-materialized expression
        # column, e.g. the fused distance) keeps its column as-is
        cand_names = []
        if isinstance(e, Ident):
            cand_names = [e.qualified] if e.table else [e.name]
        cand_names.append(render(e))
        col = None
        for cn in cand_names:
            if cn in table:
                col = table[cn]
                break
            if cn in env.extra:
                out_cols.append(_value_to_column(name, env.extra[cn], n,
                                                 device))
                out_order.append(name)
                seen.add(name)
                break
        if name in seen:
            continue
        if col is not None:
            out_cols.append(Column(Field(name, col.dtype,
                                         col.field.nullable,
                                         col.field.vector_dim,
                                         col.field.elem),
                                   col.data, col.valid, col.dictionary,
                                   None, col.offsets))
            out_order.append(name)
            seen.add(name)
            continue
        v = eval_expr(e, env)
        out_cols.append(_value_to_column(name, v, n, device))
        out_order.append(name)
        seen.add(name)
    return out_cols, out_order


def _distinct_rows(table: Table) -> Table:
    """Device-side DISTINCT: group rows by all columns, keep each group's
    first row (reference: DistinctTransform)."""
    n = table.n_rows
    dev = table.device
    keys = []
    for c in table.columns.values():
        d = to_tensor(c.data, dev) if c.is_host else c.data
        if d.dim() > 1:
            raise ExecError("DISTINCT over vector columns not supported")
        if c.dictionary is not None:
            keys.append(d.to(torch.int32))
        elif d.is_floating_point():
            keys.append(float_bits_key(d))
        else:
            keys.append(d)
        if c.valid is not None:
            valid = to_tensor(c.valid, dev) if c.is_host else c.valid
            keys.append(valid.to(torch.int32))
    _, gid, cap = build_group_ids(tuple(keys))
    row = torch.arange(n, dtype=torch.int32, device=dev)
    rep = torch.full((cap,), INT32_MAX, dtype=torch.int32, device=dev)
    rep.scatter_reduce_(0, gid.to(torch.int64), row, "amin")
    keep = rep[torch.clamp(gid, 0, cap - 1).to(torch.int64)] == row
    out, _ = compact_table_host(table, keep)
    return out
