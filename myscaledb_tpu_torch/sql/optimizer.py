"""Copy of myscaledb_tpu/sql/optimizer.py (JAX-free; imports renamed to this package).

AST-level optimizer passes that change EXECUTION (not just EXPLAIN).

Two passes from the reference's QueryPlan/Optimizations battery
(src/Processors/QueryPlan/Optimizations/Optimizations.h:88-109):

1. ``remove_redundant_sorting`` — the analog of removeRedundantSorting.cpp:
   drops ORDER BY inside FROM-subqueries whose ordering the outer query
   destroys with its own sort, and inside IN-subqueries (set semantics —
   order is never observable).  An inner LIMIT/OFFSET/LIMIT BY pins the
   sort (it selects WHICH rows survive), and order-sensitive outer shapes
   (aggregates like groupArray/any, window functions, no outer re-sort)
   keep it.

2. aggregate projections — the analog of optimizeUseAggregateProjection.cpp
   + the per-part projection storage (src/Storages/MergeTree/
   MergeTreeDataPartWriter projections).  ``ALTER TABLE t ADD PROJECTION p
   (SELECT k, sum(v) GROUP BY k)`` declares a grouped pre-aggregate;
   ``match_projection`` recognizes a query whose GROUP BY keys are a subset
   of a projection's keys and whose aggregates are derivable from the
   projection's mergeable states (sum/count/min/max; avg = sum/count), and
   ``apply_projection`` rewrites the query to re-aggregate the tiny cached
   sidecar instead of scanning the table.  TPU-first redesign: the
   reference materializes projections per part at INSERT/merge; here the
   sidecar is ONE grouped aggregation over the HBM-resident table, built
   lazily on first use and cached per mutation epoch (exactly the SQ8
   sidecar pattern, sql/executor.py _vector_sidecar) — parts are an
   IO-layer concept, the epoch is the part-set version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from myscaledb_tpu_torch.sql.ast import (BinOp, Expr, FuncCall, Ident, InSubquery,
                                   Literal, OrderItem, SelectItem,
                                   SelectQuery, UnionQuery, walk)
from myscaledb_tpu_torch.sql.render import render


# --------------------------------------------------------------------------
# pass 1: removeRedundantSorting
# --------------------------------------------------------------------------

_ORDER_SENSITIVE_AGGS = {"grouparray", "groupuniqarray", "any", "anylast",
                         "anyheavy", "first_value", "last_value",
                         "argmin", "argmax", "groupconcat"}


def _has_order_sensitive_calls(q: SelectQuery) -> bool:
    from myscaledb_tpu_torch.sql.agg_kinds import AGG_NAMES
    from myscaledb_tpu_torch.sql.ast import WindowCall
    exprs = [it.expr for it in q.items if it.expr is not None]
    exprs += [e for e in (q.having,) if e is not None]
    for e in exprs:
        for sub in walk(e):
            if isinstance(sub, WindowCall):
                return True
            if isinstance(sub, FuncCall) and \
                    sub.name.lower() in _ORDER_SENSITIVE_AGGS and \
                    sub.name.lower() in AGG_NAMES:
                return True
    return False


def _outer_destroys_order(q: SelectQuery) -> bool:
    """The outer query re-sorts, so the inner subquery's ORDER BY can never
    be observed.  Conservative: aggregation without an outer ORDER BY, or
    order-sensitive aggregates/window calls, keep the inner sort."""
    if not q.order_by:
        return False
    if any(o.fill for o in q.order_by):
        return False
    return not _has_order_sensitive_calls(q)


def _inner_sort_removable(sq) -> bool:
    if not isinstance(sq, SelectQuery):
        return False
    return bool(sq.order_by) and sq.limit is None and not sq.offset \
        and sq.limit_by is None and not any(o.fill for o in sq.order_by)


def remove_redundant_sorting(q: SelectQuery) -> list:
    """Strip redundant inner ORDER BYs in place; returns descriptions of
    the removals (shown by EXPLAIN)."""
    removed = []
    # FROM (SELECT ... ORDER BY ...) under an order-destroying outer query
    if isinstance(q, SelectQuery) and q.subquery is not None and \
            _inner_sort_removable(q.subquery) and _outer_destroys_order(q):
        keys = ", ".join(render(o.expr) for o in q.subquery.order_by)
        q.subquery.order_by = []
        removed.append(f"subquery ORDER BY [{keys}]")
    # x IN (SELECT ... ORDER BY ...): set semantics, sort never observable
    if isinstance(q, SelectQuery):
        slots = [it.expr for it in q.items if it.expr is not None]
        slots += [e for e in (q.where, q.prewhere, q.having) if e is not None]
        for e in slots:
            for sub in walk(e):
                if isinstance(sub, InSubquery):
                    targets = sub.query.selects \
                        if isinstance(sub.query, UnionQuery) else [sub.query]
                    for t in targets:
                        if _inner_sort_removable(t):
                            keys = ", ".join(render(o.expr)
                                             for o in t.order_by)
                            t.order_by = []
                            removed.append(f"IN-subquery ORDER BY [{keys}]")
    return removed


# --------------------------------------------------------------------------
# pass 2: aggregate projections
# --------------------------------------------------------------------------

@dataclass
class ProjectionDef:
    """Declared grouped pre-aggregate (ASTProjectionDeclaration analog).

    aggs entries: (build_call, query_render, merge_fn) —
      sum(v)   -> (sum(v),       "sum(v)",  "sum")     numeric partial
      count()  -> (count(),      "count()", "sum")
      min(v)   -> (min(v),       "min(v)",  "min")
      max(v)   -> (max(v),       "max(v)",  "max")
      avg(v)   -> (avgState(v),  "avg(v)",  "avgMerge") JSON state column
      uniq(v)  -> (uniqState(v), "uniq(v)", "uniqMerge") HLL registers
    The State/Merge pairs reuse the round-4 combinator machinery — exactly
    how the reference stores aggregate-function states inside projection
    parts (optimizeUseAggregateProjection.cpp)."""
    name: str
    keys: list               # list[Expr]
    aggs: list               # list[(FuncCall, str, str)]
    select_sql: str

    def key_col(self, i: int) -> str:
        k = self.keys[i]
        return k.name if isinstance(k, Ident) and k.table is None \
            else f"__pk{i}"

    def agg_col(self, j: int) -> str:
        return f"__pa{j}"


_MERGEABLE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}
_STATEFUL = {"avg": ("avgState", "avgMerge"),
             "uniq": ("uniqState", "uniqMerge")}


def parse_projection(name: str, select_sql: str) -> ProjectionDef:
    """Parse + validate `SELECT keys..., aggs... GROUP BY keys...`."""
    from myscaledb_tpu_torch.sql.parser import parse_sql
    sq = parse_sql(select_sql)
    if isinstance(sq, UnionQuery) or not isinstance(sq, SelectQuery):
        raise ValueError("projection must be a single SELECT")
    if not sq.group_by:
        raise ValueError("only aggregate projections (with GROUP BY) are "
                         "supported")
    key_r = {render(k) for k in sq.group_by}
    aggs: list = []
    seen = set()

    def intern(build: FuncCall, query_render: str, merge_fn: str) -> None:
        if query_render not in seen:
            seen.add(query_render)
            aggs.append((build, query_render, merge_fn))

    for it in sq.items:
        e = it.expr
        if e is None:
            raise ValueError("projection cannot select *")
        if render(e) in key_r:
            continue
        if isinstance(e, FuncCall):
            fn = e.name.lower()
            if fn in _MERGEABLE:
                intern(FuncCall(fn, e.args), render(FuncCall(fn, e.args)),
                       _MERGEABLE[fn])
                continue
            if fn in _STATEFUL and len(e.args) == 1:
                state_fn, merge_fn = _STATEFUL[fn]
                intern(FuncCall(state_fn, e.args),
                       render(FuncCall(fn, e.args)), merge_fn)
                continue
        raise ValueError(
            f"projection item {render(e)} is neither a GROUP BY key nor a "
            f"mergeable aggregate (sum/count/min/max/avg/uniq)")
    return ProjectionDef(name, list(sq.group_by), aggs, select_sql)


def _subst(e: Expr, mapping: dict):
    """Rebuild expr replacing any subtree whose rendering is in mapping."""
    r = render(e)
    if r in mapping:
        return mapping[r]
    if isinstance(e, (Ident, Literal)):
        return e
    kw = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            kw[f.name] = _subst(v, mapping)
        elif isinstance(v, list) and v and isinstance(v[0], Expr):
            kw[f.name] = [_subst(x, mapping) for x in v]
        else:
            kw[f.name] = v
    return type(e)(**kw)


def _projections_of(session, table_name):
    return getattr(session, "_projections", {}).get(table_name, {})


def match_projection(session, q: SelectQuery):
    """Pure check: can q be answered from a declared projection?  Returns
    (ProjectionDef, mapping: rendered-expr -> replacement Expr) or None.
    Mirrors optimizeUseAggregateProjection's match: query keys ⊆ projection
    keys, aggregates derivable from the stored states, filters referencing
    keys only (a key filter commutes with re-aggregation)."""
    from myscaledb_tpu_torch.sql.agg_kinds import AGG_NAMES
    from myscaledb_tpu_torch.sql.ast import WindowCall
    if getattr(session, "_building_projection", False):
        return None
    if q.table is None or not q.group_by:
        return None
    projs = _projections_of(session, q.table)
    if not projs:
        return None
    if (q.joins or q.array_joins or q.subquery is not None or q.ctes or
            q.with_aliases or q.grouping_sets or q.group_modifier or
            q.with_totals or q.sample is not None or q.distinct or
            getattr(q, "table_function", None) is not None):
        return None
    exprs = [it.expr for it in q.items if it.expr is not None]
    exprs += [e for e in (q.where, q.prewhere, q.having) if e is not None]
    exprs += list(q.group_by) + [o.expr for o in q.order_by]
    for e in exprs:
        for sub in walk(e):
            if isinstance(sub, WindowCall):
                return None
            if isinstance(sub, (InSubquery,)):
                return None
    for it in q.items:
        if it.expr is None:
            return None                       # SELECT * never matches

    for proj in projs.values():
        proj_keys = {render(k): i for i, k in enumerate(proj.keys)}
        if not all(render(k) in proj_keys for k in q.group_by):
            continue
        proj_aggs = {qr: (j, mf)
                     for j, (_b, qr, mf) in enumerate(proj.aggs)}
        mapping: dict = {}
        for i, k in enumerate(proj.keys):
            mapping[render(k)] = Ident(proj.key_col(i))

        def map_agg(fc: FuncCall):
            fn = fc.name.lower()
            hit = proj_aggs.get(render(FuncCall(fn, fc.args)))
            if hit is None:
                return None
            j, merge_fn = hit
            return FuncCall(merge_fn, [Ident(proj.agg_col(j))])

        ok = True
        for e in exprs:
            for sub in walk(e):
                if not isinstance(sub, FuncCall):
                    continue
                fn = sub.name.lower()
                if fn not in AGG_NAMES or isinstance(sub, WindowCall):
                    continue
                if sub.distinct:
                    ok = False
                    break
                rep = map_agg(sub)
                if rep is None:
                    ok = False
                    break
                mapping[render(sub)] = rep
            if not ok:
                break
        if not ok:
            continue
        # every bare column reference outside mapped subtrees must be a key
        agg_renders = {r for r in mapping}

        def idents_ok(e: Expr) -> bool:
            if render(e) in agg_renders:
                return True
            if isinstance(e, Ident):
                return False
            ok2 = True
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, Expr):
                    ok2 = ok2 and idents_ok(v)
                elif isinstance(v, list) and v and isinstance(v[0], Expr):
                    ok2 = ok2 and all(idents_ok(x) for x in v)
            return ok2

        for e in exprs:
            if not idents_ok(e):
                ok = False
                break
        if ok:
            return proj, mapping
    return None


# system. prefix: the sidecar is an internal artifact — read_table_checked
# skips per-table grants for it; the BASE table's SELECT privilege is
# checked before the rewrite fires (executor 0c)
_SIDECAR_TABLE = "system.__projection_sidecar"


def _build_sidecar(session, table_name: str, proj: ProjectionDef):
    """Grouped partial-aggregate table, cached per mutation epoch."""
    epoch = session._mutation_epoch
    cache = session.__dict__.setdefault("_projection_sidecars", {})
    key = (table_name, proj.name, epoch)
    hit = cache.get(key)
    if hit is not None:
        return hit
    from myscaledb_tpu_torch.sql.executor import execute_select
    items = [SelectItem(k, proj.key_col(i))
             for i, k in enumerate(proj.keys)]
    items += [SelectItem(build, proj.agg_col(j))
              for j, (build, _qr, _mf) in enumerate(proj.aggs)]
    sub = SelectQuery(items=items, table=table_name,
                      group_by=list(proj.keys))
    session._building_projection = True
    try:
        sidecar = execute_select(session, sub)
    finally:
        session._building_projection = False
    stale = [k for k in cache if k[2] != epoch]
    for k in stale:
        del cache[k]
    cache[key] = sidecar
    return sidecar


def apply_projection(session, q: SelectQuery, match):
    """Rewrite q to run against the projection sidecar.  Returns
    (sidecar_table, new_query, hidden_name)."""
    proj, mapping = match
    sidecar = _build_sidecar(session, q.table, proj)
    new_q = dataclasses.replace(
        q,
        table=_SIDECAR_TABLE,
        table_alias=None,
        items=[SelectItem(_subst(it.expr, mapping),
                          it.alias or render(it.expr)) for it in q.items],
        where=None if q.where is None else _subst(q.where, mapping),
        prewhere=None if q.prewhere is None
        else _subst(q.prewhere, mapping),
        having=None if q.having is None else _subst(q.having, mapping),
        group_by=[_subst(k, mapping) for k in q.group_by],
        order_by=[OrderItem(_subst(o.expr, mapping), o.ascending,
                            o.nulls_last, o.fill) for o in q.order_by],
    )
    return sidecar, new_q, _SIDECAR_TABLE
