"""Copy of myscaledb_tpu/sql/plan.py (JAX-free; imports renamed to this
package; ``is_distributed`` from parallel/dist_table.py).

Logical plan DAG + rewrite passes.

Reference analog: QueryPlan of IQueryPlanStep nodes with 25 rewrite passes
(src/Processors/QueryPlan/, Optimizations.h:88).  The TPU engine executes a
statically-compiled operator pipeline, so the plan's job is DECISIONS, not
scheduling: which predicate terms prune zone-map blocks, whether the vector
top-k fuses, which distributed strategy a join/aggregate/top-n uses, and
which columns the scan must materialize.  ``build_plan`` produces the DAG by
running the passes below; ``render_plan`` prints it (EXPLAIN PLAN);
``choose_join_strategy`` / ``choose_agg_strategy`` are the SAME functions
the executor consults at run time, so the plan can never lie about the
strategy.

Passes (reference pass in parentheses):
  1. topk_extraction      LIMIT -> vector top-k (TreeRewriter.cpp:1671)
  2. prewhere_split       cheap-predicate-first scan (MergeTreeWhereOptimizer)
  3. zonemap_pruning      block pruning annotation (optimizePrimaryKeyCondition)
  4. distributed_strategy broadcast vs shuffle join, psum vs shuffle agg,
                          per-shard top-n merge (ClusterProxy stage choice)
  5. projection_pruning   required-column set for the scan (removeUnusedColumns)
  6. limit_pushdown       ORDER BY+LIMIT -> TopN node (limitPushDown)
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional

from myscaledb_tpu_torch.sql.ast import (FuncCall, Ident, Literal, BinOp, InList,
                                   WindowCall, walk)
from myscaledb_tpu_torch.sql.render import render
from myscaledb_tpu_torch.parallel.dist_table import is_distributed


@dataclass
class PlanNode:
    kind: str                       # Scan/Filter/Join/Aggregate/...
    detail: str = ""
    children: list = dc_field(default_factory=list)
    props: dict = dc_field(default_factory=dict)


# --- shared strategy decisions (executor consults the same functions) ----

def choose_join_strategy(left_table, right_table, settings, how: str,
                         strictness: str) -> str:
    """Distributed join strategy for a row-sharded left side.

    Mirrors StorageDistributed's GLOBAL-join decision
    (StorageDistributed.cpp:740): small build sides broadcast (replicate +
    probe per shard on device); large distributed build sides shuffle (both
    sides hash-repartitioned, local join per shard); otherwise the initiator
    gathers and joins locally (host fallback).
    """
    if right_table is None or left_table is None or \
            not is_distributed(left_table):
        return "local_hash"
    if right_table.n_rows <= settings.distributed_broadcast_join_threshold:
        return "broadcast"
    if is_distributed(right_table):
        return "shuffle"
    return "initiator_gather"


def choose_agg_strategy(table, settings, num_groups_hint: int) -> str:
    """Distributed aggregation merge strategy: dense partial states merged
    with psum below the group-count threshold, all-to-all shuffle + local
    aggregation above it (distributed_aggregation_memory_efficient /
    MergingAggregatedMemoryEfficientTransform analog)."""
    if table is None or not is_distributed(table):
        return "local"
    thr = getattr(settings, "distributed_group_by_shuffle_threshold", 1 << 16)
    if num_groups_hint > thr:
        return "shuffle"
    return "psum"


# --- plan construction ----------------------------------------------------

def build_plan(session, q) -> PlanNode:
    from myscaledb_tpu_torch.sql.executor import (analyze_vector_search,
                                                  analyze_text_search,
                                                  _split_conjuncts,
                                                  _zonemap_possible_blocks,
                                                  AGG_NAMES)
    settings = session.settings

    # pass 0: removeRedundantSorting (sql/optimizer.py; the executor runs
    # the same function, so the plan shows exactly what executes)
    from myscaledb_tpu_torch.sql.optimizer import (remove_redundant_sorting,
                                             match_projection)
    removed_sorts = remove_redundant_sorting(q)
    proj_match = None
    try:
        proj_match = match_projection(session, q)
    except Exception:
        proj_match = None

    table = None
    if q.table is not None:
        try:
            table = session.get_table(q.table)
        except KeyError:
            table = None
    alias_exprs = {it.alias: it.expr for it in q.items if it.alias}

    # pass 1: top-k extraction (vector / text search pseudo-functions)
    vs = None
    ts = None
    if table is not None:
        try:
            vs = analyze_vector_search(q, session, table, alias_exprs)
        except Exception:
            vs = None
        try:
            ts = analyze_text_search(q, session, table, alias_exprs)
        except Exception:
            ts = None

    # source node
    if q.subquery is not None:
        source = PlanNode("Subquery", children=[build_plan(session,
                                                           q.subquery)])
    elif getattr(q, "table_function", None) is not None:
        source = PlanNode("TableFunction", detail=str(q.table_function[0]))
    elif table is not None:
        dist = is_distributed(table)
        source = PlanNode("Scan", detail=q.table,
                          props={"rows": table.n_rows,
                                 "distributed": dist})
    else:
        source = PlanNode("Scan", detail=str(q.table or "system.one"))

    node = source

    # pass 2+3: prewhere split + zone-map pruning annotation
    conjuncts = _split_conjuncts(q.prewhere) + _split_conjuncts(q.where)
    if conjuncts and table is not None:
        prunable = []
        for term in conjuncts:
            if isinstance(term, InList) and not term.negated:
                prunable.append(term)
            elif isinstance(term, BinOp) and term.op in ("=", "<", "<=",
                                                         ">", ">="):
                prunable.append(term)
        blocks_possible = None
        try:
            blocks_possible = _zonemap_possible_blocks(table, conjuncts,
                                                       session)
        except Exception:
            pass
        props = {}
        if blocks_possible is not None:
            import numpy as np
            nblocks = None
            for c in table.columns.values():
                if c.zonemap is not None:
                    nblocks = len(c.zonemap.mins)
                    break
            props["blocks_possible"] = blocks_possible
            if nblocks:
                props["blocks_total"] = nblocks
        node = PlanNode("Filter",
                        detail=" AND ".join(render(c) for c in conjuncts),
                        children=[node], props=props)
        if q.prewhere is not None:
            node.props["prewhere"] = render(q.prewhere)

    # search nodes
    if vs is not None:
        fused = getattr(vs, "fused", False)
        detail = (f"metric={vs.metric}, k={vs.k}, "
                  f"queries={vs.qvec.shape[0]}")
        props = {}
        if table is not None and is_distributed(table):
            props["strategy"] = "per-shard top-k + ppermute tree merge"
        node = PlanNode("VectorTopK" if fused else "DistanceMaterialize",
                        detail=detail, children=[node], props=props)
    if ts is not None:
        node = PlanNode("TextSearch", detail=f"bm25 k={ts.k}",
                        children=[node])

    # joins (pass 4: distributed strategy via the shared chooser)
    for jc in getattr(q, "joins", ()):
        rt = None
        if jc.table:
            try:
                rt = session.get_table(jc.table)
            except KeyError:
                rt = None
        strat = choose_join_strategy(table, rt, settings, jc.how,
                                     jc.strictness)
        node = PlanNode("Join",
                        detail=f"{jc.how} {jc.strictness} {jc.table or ''}",
                        children=[node],
                        props={"strategy": strat})

    # aggregation
    has_aggs = bool(q.group_by)
    agg_names = []
    for it in q.items:
        for sub in walk(it.expr):
            if isinstance(sub, FuncCall) and sub.name.lower() in AGG_NAMES \
                    and not isinstance(sub, WindowCall):
                has_aggs = True
                agg_names.append(render(sub))
    if has_aggs:
        hint = getattr(settings, "max_block_size", 65536)
        strat = choose_agg_strategy(table, settings, hint)
        props = {}
        if proj_match is not None:
            # optimizeUseAggregateProjection analog: answered from the
            # grouped sidecar instead of scanning the table
            props["projection"] = proj_match[0].name
        if table is not None and is_distributed(table):
            props["strategy"] = ("psum merge of dense states"
                                 if strat == "psum" else
                                 "all-to-all shuffle + local aggregate")
        node = PlanNode(
            "Aggregate",
            detail="keys=[" + ", ".join(render(k) for k in q.group_by)
                   + "], aggregates=[" + ", ".join(agg_names) + "]",
            children=[node], props=props)
        if q.having is not None:
            node = PlanNode("Having", detail=render(q.having),
                            children=[node])

    # windows
    if any(isinstance(sub, WindowCall) for it in q.items
           for sub in walk(it.expr)):
        node = PlanNode("Window", children=[node])

    # pass 5: projection pruning — required columns
    required = set()
    for it in q.items:
        for sub in walk(it.expr):
            if isinstance(sub, Ident):
                required.add(sub.qualified if sub.table else sub.name)
    for e in conjuncts:
        for sub in walk(e):
            if isinstance(sub, Ident):
                required.add(sub.qualified if sub.table else sub.name)
    for o in getattr(q, "order_by", ()):
        for sub in walk(o.expr):
            if isinstance(sub, Ident):
                required.add(sub.qualified if sub.table else sub.name)
    if table is not None:
        present = [c for c in required if c in table.column_names]
        star = any(it.expr is None or (isinstance(it.expr, Ident) and
                                       it.expr.name == "*")
                   for it in q.items)
        if not star and present and \
                len(present) < len(table.column_names):
            source.props["columns"] = sorted(present)
    node = PlanNode("Projection",
                    detail="[" + ", ".join(
                        (it.alias or render(it.expr)) for it in q.items)
                        + "]",
                    children=[node])

    if q.distinct:
        node = PlanNode("Distinct", children=[node])

    # pass 6: ORDER BY [+ LIMIT] -> Sort or TopN
    if q.order_by:
        keys = ", ".join(render(o.expr) + ("" if o.ascending else " DESC")
                         for o in q.order_by)
        # read-in-order (reference: optimizeReadInOrder.cpp): ORDER BY that
        # prefix-matches the table sort key can stream rows in stored order
        # — the executor verifies monotonicity at run time (one cheap pass)
        # and skips the sort entirely when it holds
        in_order = False
        okeys = getattr(session, "_table_order_keys", {}).get(
            getattr(q, "table", None)) or []
        if okeys and not q.group_by and not q.distinct and \
                all(o.ascending for o in q.order_by):
            names = [render(o.expr) for o in q.order_by]
            in_order = names == okeys[:len(names)]
        if q.limit is not None:
            props = {}
            if in_order:
                props["read_in_order"] = "in_order"
            if table is not None and is_distributed(table) and \
                    not q.group_by and not q.distinct and \
                    q.limit_by is None:
                props["strategy"] = "sharded per-shard top-n + merge"
            node = PlanNode("TopN",
                            detail=f"k={q.limit + (q.offset or 0)}, "
                                   f"keys=[{keys}]",
                            children=[node], props=props)
        else:
            node = PlanNode("Sorting", detail=f"keys=[{keys}]",
                            children=[node],
                            props={"read_in_order": "in_order"}
                            if in_order else {})
    if q.limit_by is not None:
        node = PlanNode("LimitBy", detail=f"n={q.limit_by[0]}",
                        children=[node])
    if q.limit is not None or q.offset:
        node = PlanNode("Limit", detail=f"limit={q.limit}, "
                                        f"offset={q.offset}",
                        children=[node])
    if removed_sorts:
        node.props["removed_redundant_sorting"] = "; ".join(removed_sorts)
    return node


def render_plan(root: PlanNode, depth: int = 0) -> list[str]:
    pad = "  " * depth
    props = ""
    if root.props:
        props = " {" + ", ".join(f"{k}={v}" for k, v in
                                 sorted(root.props.items())) + "}"
    line = pad + root.kind + (f" ({root.detail})" if root.detail else "") \
        + props
    out = [line]
    for c in root.children:
        out.extend(render_plan(c, depth + 1))
    return out
