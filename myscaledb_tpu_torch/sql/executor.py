"""Query execution for SELECT: the port of the vector, aggregation, join,
binary-vector and DDL slices of myscaledb_tpu/sql/executor.py (``VSInfo``,
``_metric_for``, ``_find_distance_call``, ``analyze_vector_search``,
``_apply_vs_fusion``, ``_const_string``, ``_analyze_binary_vector_search``,
``_vector_sidecar``, ``_binary_sidecar``, ``_split_conjuncts``,
``_conjoin``, ``_expand_item_aliases``, ``_value_to_column``,
``_sort_key_from_value``, ``_zonemap_block_mask``, ``_limit_prunable``,
``apply_join``, ``_gather_join_output``, ``_apply_asof_join``,
``_join_key_arrays``, ``_group_ids``, ``_mask_or_true``,
``_maybe_streaming_aggregate``, ``run_aggregate``, ``_default_like``,
``_expand_group_levels``, ``_expand_grouping_sets``, ``_totals_table``,
``_materialize_topk``, ``_project``, ``_distinct_rows``, ``_limit_by``,
``WINDOW_FNS``, ``walk_outside_windows``, ``_compute_windows``,
``_apply_with_fill``, ``map_expr``, ``_resolve_subqueries``,
``_rewrite_arrayjoin_calls``, ``apply_array_join``, ``_align_to``,
``execute_any``, ``execute_select``, ``TSInfo``, ``_parse_search_params``,
``analyze_text_search``, ``_get_text_index``, ``_ftsindex_table``,
``explain_select``, ``_zonemap_possible_blocks``).

Stage order (SQL semantics): CTEs (materialized into session tables for
the statement) -> scalar/EXISTS subqueries folded to constants -> source
(table, ``numbers()``, ``ftsIndex()`` or a FROM subquery) -> JOINs (a table or a
subquery) -> [LEFT] ARRAY JOIN (``arrayJoin()`` calls become ARRAY JOIN
items first) -> PREWHERE/WHERE -> [vector, text or hybrid top-k] -> [GROUP BY /
aggregates -> HAVING] -> window functions -> SELECT -> DISTINCT -> ORDER
BY [WITH FILL] -> LIMIT BY -> OFFSET/LIMIT.  ORDER BY ... LIMIT takes the
top-n selection (ops/sort.py); a host-resident key streams through the
device chunk by chunk, and one ascending key already in order over 2^20
rows or more is read in order (no sort).  ``distance()`` and its metric-named forms fuse with ORDER
BY <distance> LIMIT k into the exact two-stage scan (ops/vector.py);
``batch_distance(col, [[q1], [q2], ...])`` with LIMIT n BY <alias>.1 scans
all its query vectors in one call and yields the tuple column
(query index, distance); over a FixedString column, both are the
binary-vector Hamming/Jaccard scan (ops/binary_vector.py).  JOINs
(INNER/LEFT/RIGHT/FULL/CROSS x ANY/ALL/SEMI/ANTI/ASOF, ON or USING) run
through ops/join.py.  Aggregates with and without GROUP BY, the -If
combinators, HAVING, DISTINCT, ROLLUP/CUBE/GROUPING SETS and WITH TOTALS
run; sum/count/avg go through K3 (ops/kernels/group_agg.py) for up to 256
groups.  The special aggregates (uniqExact, count(DISTINCT), the uniq
sketches, quantiles, argMin, ...) run in sql/agg_fns.py
(``_special_call``, ``_special_aggregate``), the -State/-Merge
combinators there too (``_state_call``, ``state_column``,
``merge_column``).  A GROUP BY a declared aggregate projection reads its
grouped table instead (sql/optimizer.py).  UNION [ALL|DISTINCT],
INTERSECT and EXCEPT [DISTINCT] run in ``execute_any``; the multiset
match of INTERSECT/EXCEPT is a device sort over keys encoded column by
column (``_set_op_keep``).  Distributed joins, SAMPLE and the table
functions other than numbers() and ftsIndex() raise ``NotPortedError``
naming the slice that brings them.
``TextSearch`` (BM25, text/bm25.py) and ``HybridSearch`` (RSF/RRF over a
vector and a text candidate list, text/fusion.py) fuse with ORDER BY
<score> DESC LIMIT k; TextSearch outside that is a score column.  Their
index is cached per (table, column, mutation epoch) (``_get_text_index``),
and ``ftsIndex(table, column, 'query')`` reads its statistics.  Error texts the
goldens pin stay byte-equal to the JAX package's.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from myscaledb_tpu_torch.core.types import (DataType, Field, physical_dtype,
                                            torch_dtype)
from myscaledb_tpu_torch.core.table import (BLOCK_ROWS, Table, Column,
                                            concat_tables, device_offsets,
                                            fits_device, offsets_total,
                                            to_tensor)
from myscaledb_tpu_torch.core.dictionary import NULL_ID, StringDictionary
from myscaledb_tpu_torch.config import TableSettings
from myscaledb_tpu_torch.errors import ExecError, NotPortedError
from myscaledb_tpu_torch.sql.ast import (Expr, Literal, VectorLiteral, Ident,
                                         Star, BinOp, UnOp, FuncCall, InList,
                                         Between, InSubquery, ScalarSubquery,
                                         ExistsSubquery, Lambda, WindowCall,
                                         SelectQuery, UnionQuery, OrderItem,
                                         SelectItem, walk)
from myscaledb_tpu_torch.sql.render import render, substitute
from myscaledb_tpu_torch.sql.optimizer import (remove_redundant_sorting,
                                               match_projection,
                                               apply_projection)
from myscaledb_tpu_torch.sql.agg_kinds import (AGG_NAMES, SPECIAL_AGGS,
                                               IF_COMBINATORS, UNIQ_KINDS)
from myscaledb_tpu_torch.sql.agg_fns import (_column_range,
                                             _special_aggregate, STATE_BASES,
                                             state_column, merge_column)
from myscaledb_tpu_torch.exec.expr import (DIST_FNS, UNSIGNED_OF_MAX, Env,
                                           Value, eval_expr, as_bool_mask,
                                           EvalError, _dict_map)
from myscaledb_tpu_torch.exec.datetime_fns import parse_date_literal
from myscaledb_tpu_torch.exec.arrays import array_row_keys, as_array
from myscaledb_tpu_torch.ops.hash import float_bits_key
from myscaledb_tpu_torch.ops.hashtable import build_group_ids, INT32_MAX
from myscaledb_tpu_torch.ops.join import (hash_join_any, hash_join_all,
                                          grace_hash_join_any,
                                          grace_hash_join_all)
from myscaledb_tpu_torch.ops.binary_vector import (BINARY_METRICS,
                                                   binary_distance_scan,
                                                   pack_binary,
                                                   to_segs_layout,
                                                   words_tensor)
from myscaledb_tpu_torch.ops.aggregate import (partial_aggregate_matmul,
                                               finalize,
                                               streaming_group_aggregate)
from myscaledb_tpu_torch.ops.vector import (distance_scan, rowwise_distance,
                                            distance_scan_streaming,
                                            build_sq8, precompute_sqnorm,
                                            INVALID_ID)
from myscaledb_tpu_torch.ops.kernels.distance_q import sq8_supported
from myscaledb_tpu_torch.ops.sort import (SortKey, encode_sort_key,
                                          sort_permutation,
                                          streaming_topn_permutation,
                                          topn_permutation)
from myscaledb_tpu_torch.ops.window import WindowLayout
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
    qvec: np.ndarray             # (nq, d) float32; binary: (nq, words) uint32
    is_batch: bool = False       # batch_distance: nq query vectors, one
                                 # (query index, distance) tuple column
    fused: bool = False
    k: int = 0
    binary: bool = False         # FixedString column: Hamming/Jaccard scan


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
    is_batch = call.name.lower() == "batch_distance"
    if table[col].field.fixed_len > 0:
        # FixedString column = BINARY VECTOR (VIUtils.cpp:666): the query
        # argument is any constant string expression (char/unhex/unbin/...)
        return _analyze_binary_vector_search(q, session, table, call, col,
                                             vec_arg, is_batch)
    if not isinstance(vec_arg, VectorLiteral):
        vec_arg = _const_query_vector(vec_arg, alias_exprs, session.device)
    if not isinstance(vec_arg, VectorLiteral):
        raise ExecError(f"{call.name}: second argument must be a vector literal")
    if not table[col].dtype.is_vector:
        raise ExecError(f"{call.name}: {col!r} is not a vector column of the table")
    qv = np.asarray(vec_arg.values, dtype=np.float32)
    if qv.size == 0:
        raise ExecError("empty query vector")
    if is_batch:
        if qv.ndim != 2:
            raise ExecError("batch_distance expects [[..],[..]] query vectors")
    else:
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
                  col, qv, is_batch)
    return _apply_vs_fusion(info, q)


def _const_query_vector(vec_arg: Expr, alias_exprs: dict, device):
    """Any constant expression as the query vector — a WITH alias,
    ``arrayMap(x -> ..., range(...))``, a cast (a scalar subquery is a
    VectorLiteral already): evaluated over one row.  An expression that
    does not evaluate (``EvalError``) or gives no vector is returned as it
    is, and the caller's "must be a vector literal" error follows, as in
    the JAX package; every other exception propagates (the JAX package
    swallows them all)."""
    resolved = vec_arg
    if isinstance(resolved, Ident) and resolved.name in alias_exprs:
        resolved = alias_exprs[resolved.name]
    if isinstance(resolved, VectorLiteral):
        return resolved
    one_row = Table([Column.from_numpy("dummy", np.zeros(1, dtype=np.int64),
                                       build_zonemap=False, device=device)])
    try:
        v = eval_expr(resolved, Env(one_row, device=device))
    except EvalError:
        return resolved
    if v.offsets is not None:
        off = np.asarray(v.offsets)
        if len(off) == 2:
            arr = v.data[int(off[0]):int(off[1])].cpu().numpy() \
                .astype(np.float32)
            return VectorLiteral(arr.tolist())
    elif v.is_scalar and isinstance(v.py, (list, tuple)):
        return VectorLiteral(list(v.py))
    return resolved


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
    if not info.is_batch:
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
    else:
        # batch: LIMIT n BY dist.1 with ORDER BY dist.1, dist.2 — n is the
        # per-query k of the scan
        if q.limit_by is not None and not q.group_by:
            info.fused = True
            info.k = q.limit_by[0]
        else:
            raise ExecError("batch_distance requires LIMIT n BY <alias>.1")
    return info


def _const_string(e: Expr, device, what: str) -> bytes:
    """Evaluate a constant string expression (char()/unhex()/unbin()/literal)
    to raw bytes (latin-1 — the engine's byte-transparent string encoding)."""
    if isinstance(e, Literal) and isinstance(e.value, str):
        return e.value.encode("latin-1", "replace")
    v = eval_expr(e, Env(Table([]), device=device))
    if not v.is_scalar or not isinstance(v.py, str):
        raise ExecError(f"{what}: query vector must be a constant string "
                        f"(char()/unhex()/unbin()) for binary vectors")
    return v.py.encode("latin-1", "replace")


def _analyze_binary_vector_search(q, session, table, call, col,
                                  vec_arg, is_batch) -> VSInfo:
    """distance()/batch_distance() over a FixedString column — the binary
    vector path (BruteForceSearch.h:95-110; metric default from
    binary_vector_search_metric_type, MergeTreeSettings.h:184)."""
    nbytes = table[col].field.fixed_len
    if is_batch:
        args = getattr(vec_arg, "values", None)
        if args is None:
            # [expr, expr, ...] parses as an array FuncCall
            if isinstance(vec_arg, FuncCall) and \
                    vec_arg.name.lower() == "array":
                args = vec_arg.args
            else:
                raise ExecError("batch_distance expects [q1, q2, ...]")
        raws = [_const_string(a, session.device, call.name) for a in args]
    else:
        raws = [_const_string(vec_arg, session.device, call.name)]
    for raw in raws:
        if len(raw) != nbytes:
            raise ExecError(
                f"{call.name}: query vector has {len(raw)} bytes, column "
                f"{col!r} is FixedString({nbytes})")
    qw = pack_binary(raws, nbytes)
    tsettings = session.table_settings.get(table.name, TableSettings())
    metric = str(tsettings.binary_vector_search_metric_type).capitalize()
    if metric not in BINARY_METRICS:
        raise ExecError(f"unknown binary vector metric {metric!r}")
    alias = None
    for it in q.items:
        if it.alias and render(it.expr) == render(call):
            alias = it.alias
    info = VSInfo(call, render(call), alias, metric, col, qw, is_batch,
                  binary=True)
    return _apply_vs_fusion(info, q)


# ---------------------------------------------------------------------------
# expression helpers

# ---------------------------------------------------------------------------
# text / hybrid search analysis (reference: TextSearchInfo / HybridSearchInfo,
# src/VectorIndex/Storages/VSDescription.h:72,110)

@dataclass
class TSInfo:
    call: FuncCall
    name: str
    alias: Optional[str]
    kind: str                    # 'text' | 'hybrid'
    text_col: str = ""
    query: str = ""
    operator: str = "OR"
    vec_col: str = ""
    qvec: Optional[np.ndarray] = None
    metric: str = "L2"
    fusion_type: str = "RSF"
    fused: bool = False
    k: int = 0
    is_batch: bool = False       # single-list results (matches VSInfo shape)


def _parse_search_params(s: str) -> dict:
    out = {}
    for kv in s.replace(",", "&").split("&"):
        if "=" in kv:
            k, v = kv.split("=", 1)
            out[k.strip().lower()] = v.strip()
    return out


def analyze_text_search(q: SelectQuery, session, table: Table,
                        alias_exprs: dict) -> Optional[TSInfo]:
    call = None
    for it in q.items:
        for node in walk(it.expr):
            if isinstance(node, FuncCall) and node.name.lower() in TEXT_FNS:
                call = node
                break
    if call is None:
        return None
    kind = "text" if call.name.lower() == "textsearch" else "hybrid"
    args = list(call.args)
    params = {}
    if args and isinstance(args[0], Literal) and isinstance(args[0].value, str) \
            and ("=" in args[0].value):
        params = _parse_search_params(args[0].value)
        args = args[1:]
    alias = None
    for it in q.items:
        if it.alias and render(it.expr) == render(call):
            alias = it.alias
    info = TSInfo(call, render(call), alias, kind,
                  operator=params.get("operator", "OR").upper(),
                  fusion_type=params.get("fusion_type", "rsf").upper())
    if kind == "text":
        if len(args) != 2 or not isinstance(args[0], Ident) \
                or not isinstance(args[1], Literal):
            raise ExecError("TextSearch expects (column, 'query text')")
        info.text_col = args[0].name
        info.query = str(args[1].value)
    else:
        if len(args) != 4 or not isinstance(args[0], Ident) \
                or not isinstance(args[1], Ident) \
                or not isinstance(args[2], VectorLiteral) \
                or not isinstance(args[3], Literal):
            raise ExecError("HybridSearch expects "
                            "(vector_col, text_col, [qvec], 'query text')")
        info.vec_col = args[0].name
        info.text_col = args[1].name
        info.qvec = np.asarray(args[2].values, dtype=np.float32)
        if info.qvec.ndim == 1:
            info.qvec = info.qvec[None, :]
        info.query = str(args[3].value)
        tsettings = session.table_settings.get(table.name, TableSettings())
        info.metric = tsettings.float_vector_search_metric_type
    if info.text_col not in table or not table[info.text_col].dtype.is_string:
        raise ExecError(f"{call.name}: {info.text_col!r} is not a string column")

    # fusion: ORDER BY <score> DESC LIMIT k (scores are descending-better)
    def refs(e):
        r = render(e)
        return r == info.name or (alias and isinstance(e, Ident)
                                  and e.table is None and e.name == alias)
    if q.order_by and q.limit is not None and not q.group_by \
            and refs(q.order_by[0].expr) and not q.order_by[0].ascending:
        info.fused = True
        info.k = q.limit + q.offset
    return info


def _get_text_index(session, table_name: str, table: Table, col: str):
    """The BM25 index of a String column, kept in the session's derived
    state per (table, column, mutation epoch) with the column's identity
    checked: a DELETE and an INSERT that leave the row count unchanged
    move the epoch, so the next query reads the new rows (the JAX package
    keys its cache by the row count and serves the old index)."""
    from myscaledb_tpu_torch.text.bm25 import BM25Index
    return _derived(session, "bm25", table_name, table, col,
                    lambda c: BM25Index.from_column(c, session.device))


def _ftsindex_table(session, table_name: str, col: str, query: str) -> Table:
    """ftsIndex(table, column, 'query') — the FTS-statistics table function
    (reference: TableFunctionFtsIndex.h:23 + StorageFtsIndex.h exposing
    total_docs / field_tokens / terms_freq, the inputs the distributed
    initiator merges into global BM25 stats, BM25InfoInDataParts.h), one
    row per query term: (term, doc_freq, total_term_freq, total_docs,
    total_tokens)."""
    from myscaledb_tpu_torch.text.bm25 import tokenize
    try:
        table = session.read_table_checked(table_name)
    except KeyError:
        raise ExecError(f"unknown table {table_name!r}")
    if col not in table:
        raise ExecError(f"unknown column {col!r} in {table_name!r}")
    idx = _get_text_index(session, table_name, table, col)
    terms = list(dict.fromkeys(tokenize(query)))
    dfs = [idx.term_df(t) for t in terms]
    tfs = [int(idx.term_postings(t)[1].to(torch.int64).sum())
           for t in terms]
    n = len(terms)
    dev = session.device

    def int_col(name, vals):
        return Column.from_numpy(name, np.asarray(vals, dtype=np.int64),
                                 build_zonemap=False, device=dev)
    return Table([
        Column.from_numpy("term", np.array(terms, dtype=object),
                          DataType.STRING, build_zonemap=False, device=dev),
        int_col("doc_freq", dfs), int_col("total_term_freq", tfs),
        int_col("total_docs", np.full(n, idx.stat_docs)),
        int_col("total_tokens", np.full(n, idx.total_tokens)),
    ], name="ftsIndex")


def _text_search_topk(session, q: SelectQuery, table: Table, ts: TSInfo,
                      mask, settings):
    """The fused TextSearch / HybridSearch top-k: (scores (1, k), ids (1,
    k)) tensors, INVALID_ID-padded.  HybridSearch scans its vector half
    with no SQ8 sidecar, as the JAX package does (at 2^16 rows and more
    the segment-min kernel K2), over the column's cached squared norms
    (the JAX package computes them on every query), and fuses the two
    candidate lists on the host (text/fusion.py)."""
    from myscaledb_tpu_torch.text.fusion import (relative_score_fusion,
                                                 reciprocal_rank_fusion)
    dev = session.device
    idx = _get_text_index(session, q.table, table, ts.text_col)
    if ts.kind == "text":
        with span("text_search", k=ts.k, rows=table.n_rows):
            scores, ids = idx.search(ts.query, ts.k, mask=mask,
                                     operator=ts.operator)
        return scores[None, :], ids[None, :]
    ncand = ts.k * settings.hybrid_search_top_k_multiple_base
    with span("hybrid_search", k=ts.k, rows=table.n_rows):
        vcol = table[ts.vec_col]
        qv = torch.as_tensor(ts.qvec, device=dev)
        if vcol.is_host:
            vd, vids = distance_scan_streaming(
                vcol.data, qv, metric=ts.metric, k=ncand,
                mask=None if mask is None else mask.cpu().numpy())
        else:
            # the squared norms the JAX package computes on every query,
            # kept with the column's other derived state
            sqn = _derived(session, "sqnorm", q.table, table, ts.vec_col,
                           lambda c: precompute_sqnorm(c.data))
            vd, vids = distance_scan(
                vcol.data, qv, metric=ts.metric, k=ncand, mask=mask,
                block_rows=settings.vector_scan_block_rows, x_sqnorm=sqn)
        tscores, tids = idx.search(ts.query, ncand, mask=mask,
                                   operator=ts.operator)
        vids_np = vids[0].cpu().numpy()
        vd_np = vd[0].cpu().numpy()
        tids_np = tids.cpu().numpy()
        ts_np = tscores.cpu().numpy()
    vok = vids_np != INVALID_ID
    tok = tids_np != INVALID_ID
    if ts.fusion_type == "RRF":
        fids, fscores = reciprocal_rank_fusion(
            [vids_np[vok], tids_np[tok]], settings.hybrid_search_fusion_k)
    else:
        fids, fscores = relative_score_fusion(
            vids_np[vok], vd_np[vok], tids_np[tok], ts_np[tok],
            weight=settings.hybrid_search_fusion_weight,
            vector_descending=(ts.metric == "IP"))
    fids = fids[:ts.k]
    fscores = fscores[:ts.k]
    pad = ts.k - len(fids)
    d2 = np.concatenate([fscores, np.full(pad, -np.inf, dtype=np.float32)])
    i2 = np.concatenate([fids.astype(np.int64),
                         np.full(pad, INVALID_ID, dtype=np.int64)])
    return torch.as_tensor(d2[None, :]), torch.as_tensor(i2[None, :])


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


def map_expr(e: Expr, f) -> Expr:
    """Bottom-up expression-tree rewrite: apply f to every node after
    rewriting its children."""
    if isinstance(e, BinOp):
        e = BinOp(e.op, map_expr(e.left, f), map_expr(e.right, f))
    elif isinstance(e, UnOp):
        e = UnOp(e.op, map_expr(e.operand, f))
    elif isinstance(e, FuncCall):
        e = FuncCall(e.name, [map_expr(a, f) for a in e.args], e.distinct)
    elif isinstance(e, InList):
        e = InList(map_expr(e.expr, f),
                   [map_expr(i, f) for i in e.items], e.negated)
    elif isinstance(e, Between):
        e = Between(map_expr(e.expr, f), map_expr(e.low, f),
                    map_expr(e.high, f), e.negated)
    elif isinstance(e, Lambda):
        e = Lambda(e.params, map_expr(e.body, f))
    elif isinstance(e, InSubquery):
        e = InSubquery(map_expr(e.expr, f), e.query, e.negated)
    elif isinstance(e, WindowCall):
        e = WindowCall(map_expr(e.func, f), [map_expr(p, f)
                                             for p in e.partition_by],
                       [OrderItem(map_expr(o.expr, f), o.ascending,
                                  o.nulls_last, o.fill)
                        for o in e.order_by], e.window_name, e.frame)
    return f(e)


def _resolve_subqueries(e: Expr, session) -> Expr:
    """Evaluate uncorrelated scalar / EXISTS subqueries into literal
    constants: a 0-row scalar is NULL, a 1-row multi-column result a
    tuple, an array or vector result a VectorLiteral."""
    def repl(node):
        if isinstance(node, ExistsSubquery):
            t = execute_any(session, node.query)
            return Literal(1 if t.n_rows > 0 else 0)
        if isinstance(node, ScalarSubquery):
            t = execute_any(session, node.query)
            if len(t.column_names) == 1 and t.n_rows <= 1:
                if t.n_rows == 0:
                    return Literal(None)
                col = next(iter(t.columns.values()))
                if col.data.dim() > 1 or col.offsets is not None:
                    return VectorLiteral(list(col.to_python()[0]))
                return Literal(col.to_python()[0])
            if t.n_rows == 1:     # 1-row multi-column -> tuple literal
                vals = [c.to_python()[0] for c in t.columns.values()]
                return FuncCall("tuple", [Literal(v) for v in vals])
            raise ExecError("scalar subquery must return at most one row")
        return node

    return map_expr(e, repl)


def _has_subqueries(e: Expr) -> bool:
    return any(isinstance(n, (ScalarSubquery, ExistsSubquery))
               for n in walk(e))


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
    if v.u64:
        return DataType.UINT64
    if v.umax in UNSIGNED_OF_MAX and not data.is_floating_point():
        return UNSIGNED_OF_MAX[v.umax]
    dt = _LOGICAL_OF.get(data.dtype)
    if dt is None:
        raise ExecError(f"unsupported result dtype {data.dtype}")
    return dt


def _value_to_column(name: str, v: Value, n: int, device) -> Column:
    data = v.data
    if v.is_array:
        elem = DataType.STRING if v.dictionary is not None else \
            _logical_dtype_of(data, Value(data))
        fld = Field(name, DataType.ARRAY, nullable=v.valid is not None,
                    elem=elem)
        return Column(fld, data, v.valid, v.dictionary, None,
                      np.asarray(v.offsets, dtype=np.int64))
    if v.is_scalar:
        if isinstance(v.py, str):
            d = StringDictionary()
            ids = np.full(n, d.encode_one(v.py, grow=True), dtype=np.int32)
            return Column(Field(name, DataType.STRING),
                          to_tensor(ids, device), None, d)
        if isinstance(v.py, list):
            # constant array literal broadcast to every row
            k = len(v.py)
            flat = to_tensor(np.tile(np.asarray(data).reshape(-1), n),
                             device) if k else \
                torch.zeros(0, dtype=torch.int64, device=device)
            off = np.arange(n + 1, dtype=np.int64) * k
            elem = _logical_dtype_of(flat, Value(flat)) if k \
                else DataType.INT64
            return Column(Field(name, DataType.ARRAY, elem=elem),
                          flat, None, None, None, off)
    if data.dim() == 0:
        data = data.expand(n).clone()   # constant or scalar-folded (1+1)
    dt = _logical_dtype_of(data, v)
    fld = Field(name, dt, nullable=v.valid is not None)
    return Column(fld, data, v.valid, v.dictionary)


def _sort_key_from_value(v: Value, ascending: bool, nulls_last: bool, n: int,
                         device) -> SortKey:
    """A SortKey on ``device``, except that a host-resident column stays
    a host array (streaming_topn_permutation moves it in chunks;
    ``_key_on_device`` moves it whole for the other sorts)."""
    if v.is_array:
        return SortKey(array_row_keys(v, device), ascending=ascending,
                       valid=v.valid, nulls_last=nulls_last)
    data = v.data
    if isinstance(data, np.ndarray) and not fits_device(data):
        # UInt64 past 2^63-1: the same order as int64 sort keys
        data = (data ^ np.uint64(1 << 63)).view(np.int64)
    if v.is_scalar:
        data = data.expand(n)
    if v.u64 and isinstance(data, torch.Tensor):
        # UInt64 bits: flipping the sign bit orders them unsigned
        data = data.to(torch.int64) ^ (-(1 << 63))
    if v.dictionary is not None:
        ranks = v.dictionary.ranks()
        if len(ranks) == 0:
            ranks = np.zeros(1, dtype=np.int32)
        data = _dict_map(Value(data), ranks)
    return SortKey(data, ascending=ascending, valid=v.valid,
                   nulls_last=nulls_last)


def _key_on_device(sk: SortKey, device) -> SortKey:
    """``sk`` with a host-resident column copied whole to ``device``."""
    values, valid = sk.values, sk.valid
    if isinstance(values, np.ndarray):
        values = to_tensor(values, device)
    if isinstance(valid, np.ndarray):
        valid = to_tensor(valid, device)
    return SortKey(values, sk.ascending, valid, sk.nulls_last)


def _derived(session, kind, table_name, table, col, build, epoch=None):
    """State derived from one column and kept in the session: squared
    norms (``sqnorm``), the SQ8 sidecar (``sq8``), packed binary words
    (``binary``), the BM25 index (``bm25``), skip-index sidecars and
    joinGet's sorted keys: ``derived_state`` keyed (kind, table, column)
    and alive while the column's data is."""
    return derived_state(session, (kind, table_name, col), table[col].data,
                         lambda: build(table[col]), epoch)


def derived_state(session, key: tuple, live, build, epoch=None):
    """One cache for everything derived from session data, keyed by
    ``key`` and the mutation epoch, with one rule: storing an entry drops
    every entry of an earlier epoch, and an entry whose ``live`` object is
    no longer the one it was built from (another table under the same
    name in the same epoch, a CTE of an earlier statement, another
    dictionary at a reused address) is built anew.  ``build()`` runs
    under the session's sidecar lock, so of two threads that want the
    same entry one builds and the other waits.

    An index build may run this on the background executor's thread: on
    the card a CUDA event recorded after the build orders the reader's
    stream after the building thread's."""
    with session.sidecar_lock:
        if epoch is None:
            epoch = session._mutation_epoch
        key = (*key, epoch)
        hit = session._derived.get(key)
        if hit is not None and hit[2]() is not live:
            hit = None
        if hit is None:
            out = build()
            done = None
            if session.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(session.device))
            hit = (out, done, weakref.ref(live))
            for k in [k for k in session._derived if k[-1] != epoch]:
                del session._derived[k]
            session._derived[key] = hit
    out, done, _ = hit
    if done is not None:
        done.wait(torch.cuda.current_stream(session.device))
    return out


def _vector_sidecar(session, table_name, table, col, epoch=None):
    """The scan artifacts of a vector column: its squared norms and, from
    2^16 rows at a supported width, the SQ8 certified-quantization sidecar,
    each built on first use.  A failure to build the sidecar raises (the
    JAX package silently skipped it)."""
    def sq8(c):
        x = c.data
        if x.dim() == 2 and sq8_supported(x.shape[1]) \
                and x.shape[0] >= (1 << 16):
            return build_sq8(x)
        return None
    sqn = _derived(session, "sqnorm", table_name, table, col,
                   lambda c: precompute_sqnorm(c.data), epoch)
    return sqn, _derived(session, "sq8", table_name, table, col, sq8, epoch)


def _pack_column(c: Column) -> np.ndarray:
    """(n, words) uint32 packed rows of a FixedString column: its
    dictionary values packed once (NULL as the empty string), gathered by
    row id."""
    vals = pack_binary(c.dictionary.values, c.field.fixed_len)
    table = np.concatenate([vals, np.zeros((1, vals.shape[1]), np.uint32)])
    ids = c.data if c.is_host else c.data.cpu().numpy()
    return table[np.where(ids < 0, len(vals), ids)]


def _binary_sidecar(session, table_name, table, col):
    """Packed words of a FixedString binary-vector column, kept like the
    SQ8 sidecar, in the segment-major (nseg, words, SEG) layout of K5 with
    the real row count alongside.  The JAX package packs row by row
    through ``to_python()``; here each dictionary value is packed once and
    the rows gather them, which gives the same words."""
    def build(c):
        xw = _pack_column(c)
        return words_tensor(to_segs_layout(xw), session.device), len(xw)
    return _derived(session, "binary", table_name, table, col, build)


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
            if isinstance(sub, FuncCall) and sub.name.lower() in TEXT_FNS:
                return False    # BM25 statistics cover the whole table
    return True


def _zonemap_block_mask(table: Table, conjuncts,
                        session=None) -> Optional[np.ndarray]:
    """Per-block min/max pruning over the host zone maps, and over the
    table's declared skip indexes (``_skipindex_block_mask``).  Returns a
    boolean possible-mask over 64k-row blocks, or None when no term is
    prunable.  Beyond the JAX package's terms, ``x BETWEEN a AND b`` prunes
    as ``x >= a AND x <= b``, and a string literal against a Date or
    DateTime column as its day or second number, as ClickHouse's
    KeyCondition does (the rows are the same; fewer blocks are read)."""
    flat = []
    for term in conjuncts:
        if isinstance(term, Between) and not term.negated:
            flat += [BinOp(">=", term.expr, term.low),
                     BinOp("<=", term.expr, term.high)]
        else:
            flat.append(term)
    conjuncts = flat

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
        if isinstance(v, str) and col.dtype in (DataType.DATE,
                                                DataType.DATETIME):
            try:
                return True, parse_date_literal(v, col.dtype)
            except EvalError:
                return False, None
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
    sk = _skipindex_block_mask(table, conjuncts, session)
    if sk is not None:
        possible = sk if possible is None else (possible & sk)
    return possible


def _skipindex_block_mask(table: Table, conjuncts, session) -> \
        Optional[np.ndarray]:
    """Per-block set/bloom skip-index pruning (reference:
    MergeTreeIndexSet.cpp / MergeTreeIndexBloomFilter.cpp /
    MergeTreeIndexFullText.cpp consulted during range selection): the
    port of the JAX package's function of the same name.  Sidecars come
    from storage/skip_index.py, cached per mutation epoch; each index
    consulted counts one ``SkipIndexChecks``."""
    if session is None or not table.name:
        return None
    defs = session._table_skip_indexes.get(table.name)
    if not defs:
        return None
    from myscaledb_tpu_torch.storage.skip_index import (
        BloomSidecar, NgramBloomSidecar, _hash_grams, _to_u64_keys,
        pattern_required_grams, set_blocks_possible, set_blocks_possible_in,
        sidecar_for)
    by_col = {}
    for idx in defs:
        by_col.setdefault(idx.column, []).append(idx)

    def _name(e):
        return e.qualified if e.table else e.name

    def _term_parts(term):
        """-> (col_name, op, [literal values]) or None."""
        if isinstance(term, InList) and not term.negated:
            if not isinstance(term.expr, Ident):
                return None
            if not all(isinstance(it, Literal) for it in term.items):
                return None
            return _name(term.expr), "in", [it.value for it in term.items]
        if isinstance(term, BinOp) and term.op in ("=", "<", "<=", ">", ">="):
            lhs, rhs, op = term.left, term.right, term.op
            if isinstance(rhs, Ident) and isinstance(lhs, Literal):
                lhs, rhs = rhs, lhs
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
            if not (isinstance(lhs, Ident) and isinstance(rhs, Literal)):
                return None
            return _name(lhs), op, [rhs.value]
        return None

    possible = None
    for term in conjuncts:
        # LIKE pruning through ngram/token blooms: blocks lacking any
        # required gram of the pattern cannot match
        if (isinstance(term, FuncCall) and term.name.lower() == "like"
                and len(term.args) == 2 and isinstance(term.args[0], Ident)
                and isinstance(term.args[1], Literal)
                and isinstance(term.args[1].value, str)):
            lname = _name(term.args[0])
            if lname in by_col and lname in table:
                for idx in by_col[lname]:
                    if idx.kind not in ("ngrambf", "tokenbf"):
                        continue
                    sc = sidecar_for(session, table, lname, idx)
                    if not isinstance(sc, NgramBloomSidecar):
                        continue
                    grams = pattern_required_grams(
                        term.args[1].value, idx.kind, int(idx.param) or 3)
                    if not grams:
                        continue
                    ok = sc.may_contain_all(_hash_grams(grams))
                    M.increment("SkipIndexChecks")
                    possible = ok if possible is None else (possible & ok)
            continue
        parts = _term_parts(term)
        if parts is None:
            continue
        name, op, lits = parts
        if name not in by_col or name not in table:
            continue
        col = table[name]
        # literals in the column's stored key space
        keys = []
        provably_absent = False
        for v in lits:
            if isinstance(v, str) and col.dictionary is not None:
                did = col.dictionary.encode_one(v)
                if did < 0:
                    provably_absent = True
                else:
                    keys.append(did)
            elif isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and col.dictionary is None:
                keys.append(v)
            else:
                keys = None
                break
        if keys is None:
            continue
        # dictionary ids are insertion-ordered: range ops are untranslatable
        if col.dictionary is not None and op not in ("=", "in"):
            continue
        for idx in by_col[name]:
            sc = sidecar_for(session, table, name, idx)
            if sc is None or isinstance(sc, NgramBloomSidecar):
                continue
            if isinstance(sc, BloomSidecar):
                if op not in ("=", "in"):
                    continue
                if not keys:
                    ok = np.zeros(sc.bits.shape[0], dtype=bool)
                else:
                    dt = np.int32 if col.dictionary is not None else \
                        physical_dtype(col.dtype)
                    ok = sc.may_contain(_to_u64_keys(
                        np.asarray(keys).astype(dt)))
            else:                                   # set sidecar
                if op == "in" or (op == "=" and provably_absent and not keys):
                    ok = set_blocks_possible_in(sc, keys)
                elif not keys:
                    ok = np.zeros(len(sc), dtype=bool)
                else:
                    ok = set_blocks_possible(sc, op, keys[0])
            M.increment("SkipIndexChecks")
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
# join

def apply_join(session, left: Table, jc, alias_prefixes: dict,
               settings=None) -> Table:
    if jc.subquery is not None:
        right = execute_any(session, jc.subquery)
    else:
        try:
            right = session.read_table_checked(jc.table)
        except KeyError:
            raise ExecError(f"unknown join table {jc.table!r}")
    ralias = jc.alias or jc.table or "_subquery"
    dev = session.device

    # extract equality key pairs (+ for ASOF exactly one inequality)
    pairs = []
    asof_term = None          # (left_expr, op, right_expr)
    if jc.using:
        for c in jc.using:
            pairs.append((Ident(c), Ident(c)))
    elif jc.condition is not None:
        for term in _split_conjuncts(jc.condition):
            is_eq = isinstance(term, BinOp) and term.op == "="
            is_ineq = isinstance(term, BinOp) and \
                term.op in (">=", ">", "<=", "<")
            if not is_eq and not (is_ineq and jc.strictness == "ASOF"):
                raise ExecError("JOIN ON supports conjunctions of equalities")
            l, r = term.left, term.right

            def side(e):
                if isinstance(e, Ident):
                    if e.table == ralias or (e.table is None and
                                             e.name in right and
                                             e.name not in left):
                        return "right"
                    return "left"
                raise ExecError("JOIN ON terms must be column = column")
            op = term.op
            if side(l) == "right" and side(r) == "left":
                l, r = r, l
                op = {">=": "<=", ">": "<", "<=": ">=", "<": ">"}.get(op, op)
            elif not (side(l) == "left" and side(r) == "right"):
                raise ExecError("JOIN ON must relate left and right columns")
            if is_eq:
                pairs.append((l, r))
            else:
                if asof_term is not None:
                    raise ExecError("ASOF JOIN needs exactly one inequality")
                asof_term = (l, op, r)
    elif jc.how == "CROSS":
        # cartesian product (reference: JoinAlgorithm CROSS)
        nl, nr = left.n_rows, right.n_rows
        left_rows = np.repeat(np.arange(nl), nr)
        right_rows = np.tile(np.arange(nr), nl)
        right_has = np.ones(nl * nr, dtype=bool)
        return _gather_join_output(left, right, left_rows, right_rows,
                                   right_has, jc, ralias, alias_prefixes,
                                   "ALL", dev)
    else:
        raise ExecError("JOIN requires ON or USING")
    if jc.strictness == "ASOF":
        if asof_term is None:
            raise ExecError("ASOF JOIN requires an inequality in ON")
        return _apply_asof_join(left, right, jc, ralias, alias_prefixes,
                                pairs, asof_term, dev)

    lenv = Env(left, device=dev)
    renv = Env(right, device=dev)
    lkeys, rkeys = [], []
    for le, re_ in pairs:
        lv = eval_expr(Ident(le.name), lenv)
        rv = eval_expr(Ident(re_.name), renv)
        lk, rk = _join_key_arrays(lv, rv)
        lkeys.append(lk)
        rkeys.append(rk)

    M.increment(M.JOIN_PROBE_ROWS, left.n_rows)
    how, strict = jc.how, jc.strictness
    st = settings if settings is not None else session.settings
    use_grace = st.join_algorithm == "grace_hash" or (
        st.join_algorithm == "auto" and
        right.n_rows > st.max_rows_in_hash_join_build)
    with span("hash_join", how=how, strictness=strict, grace=use_grace,
              probe_rows=left.n_rows, build_rows=right.n_rows):
        if strict in ("ANY", "SEMI", "ANTI"):
            if use_grace:
                res = grace_hash_join_any(
                    tuple(rkeys), tuple(lkeys),
                    n_partitions=st.grace_hash_join_initial_buckets)
            else:
                res = hash_join_any(tuple(rkeys), tuple(lkeys))
            found_np = res.found.cpu().numpy()
            build_row = torch.where(res.found, res.build_row, 0) \
                .cpu().numpy()
            if strict == "ANTI":
                left_rows = np.flatnonzero(~found_np)
                right_rows = np.zeros(len(left_rows), dtype=np.int64)
                right_has = np.zeros(len(left_rows), dtype=bool)
            elif strict == "SEMI" or how == "INNER":
                left_rows = np.flatnonzero(found_np)
                right_rows = build_row[left_rows]
                right_has = np.ones(len(left_rows), dtype=bool)
            else:  # LEFT ANY (and RIGHT/FULL ANY, as in the JAX package)
                left_rows = np.arange(left.n_rows)
                right_rows = build_row
                right_has = found_np
        else:   # ALL multiplicity
            if use_grace:
                exp = grace_hash_join_all(
                    tuple(rkeys), tuple(lkeys),
                    n_partitions=st.grace_hash_join_initial_buckets)
            else:
                exp = hash_join_all(tuple(rkeys), tuple(lkeys))
            left_rows = exp.probe_idx.cpu().numpy()
            right_rows = exp.build_idx.cpu().numpy()
            right_has = np.ones(len(left_rows), dtype=bool)
            found_np = exp.found.cpu().numpy()
            if how in ("LEFT", "FULL"):
                extra = np.flatnonzero(~found_np)
                left_rows = np.concatenate([left_rows, extra])
                right_rows = np.concatenate(
                    [right_rows, np.zeros(len(extra), dtype=right_rows.dtype)])
                right_has = np.concatenate(
                    [right_has, np.zeros(len(extra), dtype=bool)])
            if how in ("RIGHT", "FULL"):
                matched_right = np.zeros(right.n_rows, dtype=bool)
                matched_right[exp.build_idx.cpu().numpy()] = True
                extra_r = np.flatnonzero(~matched_right)
                left_rows = np.concatenate(
                    [left_rows, np.full(len(extra_r), -1,
                                        dtype=left_rows.dtype)])
                right_rows = np.concatenate([right_rows, extra_r])
                right_has = np.concatenate(
                    [right_has, np.ones(len(extra_r), dtype=bool)])

    return _gather_join_output(left, right, left_rows, right_rows, right_has,
                               jc, ralias, alias_prefixes, strict, dev)


def _gather_side(c: Column, name: str, rows: np.ndarray, has, device):
    """One output column of a join: c's rows gathered by the host row ids,
    NULL where ``has`` (a bool tensor, or None for all rows) is False."""
    if c.offsets is not None:
        rc = c.take_ragged(rows)
        data, valid, offsets = rc.data, rc.valid, rc.offsets
    else:
        offsets = None
        if len(c) == 0:
            # a side with no rows contributes only NULLs (a String column
            # NULL ids, which its empty dictionary decodes as NULL)
            dtype = c.data.dtype if not c.is_host \
                else torch_dtype(c.data.dtype)
            data = torch.full((len(rows),) + tuple(c.data.shape[1:]),
                              NULL_ID if c.dictionary is not None else 0,
                              dtype=dtype, device=device)
            valid = torch.zeros(len(rows), dtype=torch.bool, device=device)
        elif c.is_host:
            data = to_tensor(c.data[rows], device)
            valid = to_tensor(c.valid[rows], device) \
                if c.valid is not None else None
        else:
            idx = torch.as_tensor(rows, device=device)
            data = c.data.index_select(0, idx)
            valid = c.valid.index_select(0, idx) \
                if c.valid is not None else None
    if has is not None:
        valid = has if valid is None else valid & has
    # as in the JAX package, the output keeps no FixedString width
    elem = c.field.elem if offsets is not None else None
    return Column(Field(name, c.dtype, valid is not None, c.field.vector_dim,
                        elem), data, valid, c.dictionary, None, offsets)


def _gather_join_output(left: Table, right: Table, left_rows, right_rows,
                        right_has, jc, ralias: str, alias_prefixes: dict,
                        strict: str, device) -> Table:
    """Materialize the joined table from host row-index pairs (left_rows < 0
    => left side NULL, right_has False => right side NULL)."""
    left_rows = np.asarray(left_rows, dtype=np.int64)
    right_rows = np.asarray(right_rows, dtype=np.int64)
    right_has = np.asarray(right_has, dtype=bool)
    left_has = left_rows >= 0
    safe_left = np.where(left_has, left_rows, 0)
    lh = None if left_has.all() else torch.as_tensor(left_has, device=device)
    rh = None if right_has.all() else torch.as_tensor(right_has,
                                                      device=device)
    cols = [_gather_side(c, c.name, safe_left, lh, device)
            for c in left.columns.values()]
    lnames = set(left.column_names)
    using_names = set(jc.using or [])
    for c in right.columns.values():
        if c.name in using_names:
            continue
        out_name = c.name if c.name not in lnames else f"{ralias}.{c.name}"
        cols.append(_gather_side(c, out_name, right_rows, rh, device))
    alias_prefixes[ralias] = ""
    return Table(cols, name=left.name)


def _apply_asof_join(left: Table, right: Table, jc, ralias: str,
                     alias_prefixes: dict, pairs, asof_term,
                     device) -> Table:
    """ASOF JOIN: per equality-key group, match each left row to the closest
    right row satisfying the inequality (reference: AsofRowRefs sorted
    lookup, src/Interpreters/joinDispatch.h + HashJoin ASOF maps).

    Host-side rank trick: factorize (eq-keys, asof-values) jointly, sort the
    right side by the composite key, one vectorized searchsorted resolves
    every left row."""
    lenv, renv = Env(left, device=device), Env(right, device=device)
    lkeys, rkeys = [], []
    for le, re_ in pairs:
        lv = eval_expr(Ident(le.name), lenv)
        rv = eval_expr(Ident(re_.name), renv)
        lk, rk = _join_key_arrays(lv, rv)
        lkeys.append(lk.cpu().numpy())
        rkeys.append(rk.cpu().numpy())
    lexpr, op, rexpr = asof_term
    lval = eval_expr(Ident(lexpr.name), lenv).data.cpu().numpy() \
        .astype(np.float64)
    rval = eval_expr(Ident(rexpr.name), renv).data.cpu().numpy() \
        .astype(np.float64)
    nl, nr = left.n_rows, right.n_rows

    # composite equality-key id per side (joint factorization)
    if lkeys:
        both = np.stack([np.concatenate([lk, rk])
                         for lk, rk in zip(lkeys, rkeys)], axis=1)
        _, inv = np.unique(both, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        lkid, rkid = inv[:nl].astype(np.int64), inv[nl:].astype(np.int64)
    else:
        lkid = np.zeros(nl, dtype=np.int64)
        rkid = np.zeros(nr, dtype=np.int64)

    # global value ranks so (key, rank) packs into one sortable int64
    allv = np.concatenate([lval, rval])
    uniq_v = np.unique(allv)
    lrank = np.searchsorted(uniq_v, lval).astype(np.int64)
    rrank = np.searchsorted(uniq_v, rval).astype(np.int64)
    R = len(uniq_v) + 2
    rcomp = rkid * R + rrank + 1
    order = np.argsort(rcomp, kind="stable")
    rcomp_s = rcomp[order]

    if op in (">=", ">"):
        # want the LAST right row with rval <= lval (or < for '>')
        probe = lkid * R + lrank + (1 if op == ">=" else 0)
        pos = np.searchsorted(rcomp_s, probe, side="right") - 1
        ok = pos >= 0
    else:
        # '<=' / '<': the FIRST right row with rval >= lval (or > for '<')
        probe = lkid * R + lrank + (1 if op == "<=" else 2)
        pos = np.searchsorted(rcomp_s, probe, side="left")
        ok = pos < nr
    safe = np.where(ok, pos, 0)
    found = ok & (rkid[order[safe]] == lkid) if nr else ok

    build_row = np.where(found, order[safe], 0).astype(np.int64) if nr \
        else np.zeros(nl, dtype=np.int64)
    if jc.how == "LEFT":
        left_rows = np.arange(nl)
        right_rows = build_row
        right_has = found
    else:   # INNER
        left_rows = np.flatnonzero(found)
        right_rows = build_row[left_rows]
        right_has = np.ones(len(left_rows), dtype=bool)
    return _gather_join_output(left, right, left_rows, right_rows, right_has,
                               jc, ralias, alias_prefixes, "ASOF", device)


def _join_key_arrays(lv: Value, rv: Value):
    """Align join key dtypes across the two sides (string dictionaries are
    remapped host-side into the left dictionary; float keys join on their
    bits, -0.0 folded into 0.0)."""
    if (lv.dictionary is None) != (rv.dictionary is None):
        raise ExecError("cannot join string with non-string column")
    if lv.dictionary is not None:
        remap = np.array([lv.dictionary.encode_one(s)
                          for s in rv.dictionary.values] or [-2],
                         dtype=np.int32)
        return lv.data, _dict_map(rv, remap)
    lk, rk = lv.data, rv.data
    if lk.is_floating_point() or rk.is_floating_point():
        return float_bits_key(lk), float_bits_key(rk)
    common = torch.promote_types(lk.dtype, rk.dtype)
    return lk.to(common), rk.to(common)


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


def _aggregate_column(name: str, arr: np.ndarray, dtype, device) -> Column:
    """An aggregate's result column.  A UInt64 result past 2^63-1 (a sum
    whose int64 bits wrapped, the empty set's min) has no place in the
    int64 device storage, which ingest keeps refusing it: such a column
    stays host-resident, holding uint64."""
    host = dtype is DataType.UINT64 and not fits_device(
        arr.astype(np.uint64))
    return Column.from_numpy(name, arr, dtype=dtype, build_zonemap=False,
                             to_device=not host, device=device)


# aggregates whose state over a String argument is an order (min, max:
# the dictionary's sort rank) or a row's dictionary id (any)
_STRING_STATE_FNS = ("min", "max", "any")


def _string_state(r: str, fn: str, v: Value, data: torch.Tensor, valid,
                  string_aggs: dict) -> torch.Tensor:
    """The state input of a String min/max/any: min/max compare the
    dictionary's sort ranks, any keeps the id.  Records what turns the
    state back into strings in ``string_aggs[r]``."""
    string_aggs[r] = (v.dictionary, fn, valid, v.valid is not None)
    if fn == "any":
        return data
    ranks = to_tensor(v.dictionary.ranks(), data.device)
    if ranks.numel() == 0:
        return torch.zeros_like(data)
    return ranks[torch.clamp(data.to(torch.int64), min=0)]


def _string_aggregate_column(name: str, state: np.ndarray, cnt: np.ndarray,
                             info: tuple, device) -> Column:
    """A String min/max/any result over the argument's dictionary: the ids
    the states name, '' for a group with no argument row (NULL when the
    argument is Nullable), as ClickHouse gives them."""
    d, fn, _valid, nullable = info
    ids = np.asarray(state, dtype=np.int64)
    if fn != "any" and len(d):
        ids = np.argsort(d.ranks(), kind="stable")[np.clip(ids, 0,
                                                           len(d) - 1)]
    empty = np.asarray(cnt) == 0
    valid = None
    if empty.any():
        if nullable:
            ids = np.where(empty, NULL_ID, ids)
            valid = to_tensor(~empty, device)
        else:
            ids = np.where(empty, d.encode_one("", grow=True), ids)
    return Column(Field(name, DataType.STRING, valid is not None),
                  to_tensor(ids.astype(np.int32), device), valid, d)


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
        for node in walk_outside_windows(e):
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
        if name in _STRING_STATE_FNS and col.dtype.is_string:
            # merged states would compare ids, not the dictionary's
            # order: the resident path's String min/max/any takes these
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
    logical = tuple(physical_dtype(a.dtype) if a is not None else None
                    for a in args)
    outs = finalize(states, gc, tuple(fns), logical)
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
            logical_dtypes=logical)
        outs = [o[:1] for o in finalize(id_states, id_gc, tuple(fns),
                                        logical)]
    cols, mapping = [], {}
    for kname, kcol, rep in zip(key_names, key_cols, rep_keys):
        cols.append(Column(Field(kname, kcol.dtype, False,
                                 kcol.field.vector_dim, kcol.field.elem),
                           to_tensor(rep, dev), None, kcol.dictionary))
        mapping[kname] = kname
    for r, out in zip(names, outs):
        cols.append(_aggregate_column(r, out, out_types.get(r), dev))
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
        for node in walk_outside_windows(e):
            if isinstance(node, FuncCall) and node.name.lower() in AGG_NAMES:
                for inner in node.args:
                    for sub in walk_outside_windows(inner):
                        if isinstance(sub, FuncCall) and \
                                sub.name.lower() in AGG_NAMES:
                            raise ExecError("nested aggregate functions")
                agg_calls[render(node)] = node

    # per aggregate: fn, argument tensor (None for counts: nothing reads
    # it), its own validity, zone-map range and logical numpy dtype
    fns, args, arg_valids, arg_ranges, logical = [], [], [], [], []
    normal_order: list[str] = []
    special: dict[str, tuple] = {}       # render -> (kind, arg Values, params)
    string_aggs: dict[str, tuple] = {}   # render -> String min/max/any state
    out_types = {}
    for r, call in agg_calls.items():
        name = call.name.lower()
        if call.distinct:
            # -Distinct combinator (count(DISTINCT x) maps to uniqExact,
            # reference: count_distinct_implementation setting)
            name = {"count": "uniqexact", "sum": "sumdistinct",
                    "avg": "avgdistinct"}.get(name, name)
        state = _state_call(name, call, env, alias_exprs, table)
        if state is not None:
            special[r] = state
            continue
        if name in SPECIAL_AGGS:
            special[r] = _special_call(name, call, env, alias_exprs, table)
            continue
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
            if base in _STRING_STATE_FNS and v.is_string and not v.is_scalar:
                data = _string_state(r, base, v, data, valid, string_aggs)
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
        if v.u64 and v.umax is None and name not in ("count", "any"):
            raise ExecError(f"{call.name}() over a UInt64 value past 2^63-1 "
                            "is not supported by the torch port")
        lt = _expr_logical_dtype(arg_e, v, table)
        data = v.data.expand(n) if v.is_scalar else v.data
        if name in _STRING_STATE_FNS and v.is_string and not v.is_scalar:
            data = _string_state(r, name, v, data, v.valid, string_aggs)
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
        # an array key groups by its whole value (ClickHouse compares
        # arrays); the JAX package fails here (ROADMAP section 3)
        gid, G, _strategy = _group_ids(
            [Value(array_row_keys(kv, dev)) if kv.is_array else kv
             for kv in key_vals], n, m,
            session.settings.group_by_capacity_hint)
    else:
        gid, G = torch.zeros(n, dtype=torch.int32, device=dev), 1

    # a String min/max/any also counts its argument's rows per group: an
    # empty group gives '' (NULL for a Nullable argument)
    for r, (_d, _f, valid, _nl) in string_aggs.items():
        fns.append("count")
        args.append(None)
        arg_valids.append(valid)
        arg_ranges.append(None)
        logical.append(None)
    # the route is chosen for all n rows: gathering the kept ones sends no
    # statement from the scatter to the one-hot matmul
    agg_gid, agg_m, args, arg_valids = _kept_rows_only(
        mask, gid, m, G, args, arg_valids)
    states, gc = partial_aggregate_matmul(agg_gid, agg_m, tuple(args),
                                          tuple(fns), G, tuple(arg_valids),
                                          tuple(arg_ranges), tuple(logical),
                                          route_rows=n)
    del agg_gid, agg_m
    outs = finalize(states, gc, tuple(fns), tuple(logical))
    gc_np = gc.cpu().numpy()
    present = np.flatnonzero(gc_np > 0)
    if not key_vals and len(present) == 0:
        present = np.array([0])   # global agg over empty set still yields a row

    # representative row per group (its lowest row id) -> group key output
    # values; a global aggregate has no key to fetch
    if key_vals:
        rep_np = _first_rows(gid, m, G, dev).cpu().numpy()[present]
        rep_np = np.where(rep_np == INT32_MAX, 0, rep_np)
        rep_dev = torch.as_tensor(rep_np, dtype=torch.int64, device=dev)
    gid_kept = gid if special else None
    del gid

    cols = []
    mapping = {}
    for ke, kv in zip(key_exprs, key_vals):
        name = render(ke)
        if kv.is_array:
            cols.append(_value_to_column(name, kv, n, dev)
                        .take_ragged(rep_np))
            mapping[name] = name
            continue
        data = kv.data.index_select(0, rep_dev)
        valid = kv.valid.index_select(0, rep_dev) \
            if kv.valid is not None else None
        cols.append(Column(Field(name, _expr_logical_dtype(ke, kv, table),
                                 valid is not None),
                           data, valid, kv.dictionary))
        mapping[name] = name
    counts = dict(zip(string_aggs, outs[len(normal_order):]))
    for r, out in zip(normal_order, outs):
        if r in string_aggs:
            cols.append(_string_aggregate_column(r, out[present],
                                                 counts[r][present],
                                                 string_aggs[r], dev))
        else:
            cols.append(_aggregate_column(r, out[present], out_types.get(r),
                                          dev))
        mapping[r] = r
    for r, (kind, vals, sparams) in special.items():
        if kind == "aggstate":
            col = state_column(sparams[0], vals[0], gid_kept, m, G, present,
                               n)
        elif kind == "aggmerge":
            col = merge_column(sparams[0], vals[0], gid_kept, m, G, present,
                               n, sparams[1], session)
        else:
            col = _special_aggregate(kind, vals, gid_kept, m, G, present, n,
                                     sparams, session.settings)
        cols.append(Column(Field(r, col.dtype, col.field.nullable,
                                 col.field.vector_dim, col.field.elem),
                           col.data, col.valid, col.dictionary, None,
                           col.offsets))
        mapping[r] = r
    return Table(cols, name=table.name), mapping


# from this many rows, a WHERE that keeps under half of them has the
# grouped aggregation read the kept rows only
COMPACT_MIN_ROWS = 1 << 16


def _kept_rows_only(mask, gid, m, G: int, args: list, valids: list):
    """(gid, mask, args, validities) for a grouped aggregation's
    partials: over the rows a WHERE keeps, gathered first when it keeps
    under half of many rows (a count and the gather: two host syncs), so
    no dropped row passes through K3, the matmul histogram or a scatter's
    spare slot, whichever route the aggregation takes; else as they are.
    Rows keep their order."""
    n = gid.shape[0]
    if mask is None or G <= 1 or n < COMPACT_MIN_ROWS:
        return gid, m, args, valids
    if int(m.sum()) >= n // 2:
        return gid, m, args, valids
    rows = torch.nonzero(m).flatten()
    return (gid[rows], torch.ones_like(rows, dtype=torch.bool),
            [None if a is None else a[rows] for a in args],
            [None if v is None else v[rows] for v in valids])


_TWO_ARG_AGGS = {"argmin", "argmax", "covarpop", "covarsamp", "corr"}


# slots the lowest-row scatter may spread its rows over (int32 each)
FIRST_ROW_SLOTS = 1 << 24


def _first_rows(gid, m, G: int, dev) -> torch.Tensor:
    """(G,) int32: each group's lowest row id among the rows ``m`` keeps
    (INT32_MAX for none).  A scatter-min into (chunk, group) slots, then a
    min over the chunks: with one slot a group, every row of a group (and
    every row the mask drops, into the spare slot) queues on one address
    (PERF.md); chunks of consecutive rows split that queue up to
    ``FIRST_ROW_SLOTS`` ways.  The minimum is the same."""
    n = gid.shape[0]
    tgt = torch.where(m & (gid >= 0) & (gid < G), gid.to(torch.int64), G)
    chunks = max(1, min(n >> 16, FIRST_ROW_SLOTS // (G + 1)))
    size = -(-n // chunks) if n else 1
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    if chunks > 1:
        tgt = tgt + torch.div(rows, size, rounding_mode="floor") \
            .to(torch.int64) * (G + 1)
    rep = torch.full((chunks * (G + 1),), INT32_MAX, dtype=torch.int32,
                     device=dev)
    rep.scatter_reduce_(0, tgt, rows, "amin")
    return rep.view(chunks, G + 1).amin(0)[:G]


def _state_call(name: str, call: FuncCall, env: Env, alias_exprs: dict,
                table: Table) -> Optional[tuple]:
    """("aggstate" | "aggmerge", argument Values, (base, level)) of a
    -State/-Merge combinator call (quantileTDigestMerge(0.5)(st) carries
    its level), or None for another aggregate."""
    for suffix, ckind in (("state", "aggstate"), ("merge", "aggmerge")):
        base = name[:-len(suffix)]
        if not name.endswith(suffix) or base not in STATE_BASES:
            continue
        cargs = list(call.args)
        level = None
        if base == "quantiletdigest" and len(cargs) == 2 and \
                isinstance(cargs[0], Literal):
            level = float(cargs[0].value)
            cargs = cargs[1:]
        if len(cargs) != 1:
            raise ExecError(f"{call.name} expects one argument")
        v = eval_expr(_expand_item_aliases(cargs[0], alias_exprs, table),
                      env)
        return ckind, [v], (base, level)
    return None


def _special_call(name: str, call: FuncCall, env: Env, alias_exprs: dict,
                  table: Table) -> tuple:
    """(kind, argument Values, params) of one special aggregate call: the
    parametric forms quantile(0.9)(x), topK(k)(x), groupArray(n)(x) and
    quantiles(l1, l2, ...)(x), and the aliases median, quantileExact*,
    countDistinct."""
    params = None
    cargs = list(call.args)
    if name in ("quantile", "quantileexact", "quantileexactlow",
                "quantiletdigest") \
            and len(cargs) == 2 and isinstance(cargs[0], Literal):
        params = float(cargs[0].value)   # quantile(0.9)(x)
        cargs = cargs[1:]
    if name in ("quantileexact", "quantileexactlow"):
        name = "quantile"
    if name == "median":
        name, params = "quantile", 0.5
    if name == "countdistinct":
        name = "uniqexact"
    if name == "quantiles":
        params = [float(a.value) for a in cargs if isinstance(a, Literal)]
        cargs = [a for a in cargs if not isinstance(a, Literal)]
    if name in ("topk", "grouparray", "groupuniqarray") and \
            len(cargs) == 2 and isinstance(cargs[0], Literal):
        params = int(cargs[0].value)   # topK(k)(x) / groupArray(n)(x)
        cargs = cargs[1:]
    if name == "topk" and params is None:
        params = 10   # reference default (AggregateFunctionTopK)
    vals = [eval_expr(_expand_item_aliases(a, alias_exprs, table), env)
            for a in cargs]
    if name in _TWO_ARG_AGGS and len(vals) != 2:
        raise ExecError(f"{call.name} expects two arguments")
    if name not in _TWO_ARG_AGGS and name not in UNIQ_KINDS \
            and len(vals) != 1:
        raise ExecError(f"{call.name} expects one argument")
    if name in UNIQ_KINDS and not vals:
        raise ExecError(f"{call.name} expects at least one argument")
    # the uniq kinds and anyLast read UInt64 bits as they are; the others
    # order, sum or print the values
    ordered = vals[1:] if name in ("argmin", "argmax") else \
        [] if name in UNIQ_KINDS or name == "anylast" else vals
    for v in ordered:
        if v.u64 and v.umax is None:
            raise ExecError(f"{call.name}() over a UInt64 value past 2^63-1 "
                            "is not supported by the torch port")
    return name, vals, params


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

def _session_env(session, table: Table, aliases=None) -> Env:
    """An Env of the statement's session: on its device, with the runner
    ``IN (subquery)`` evaluates through (the JAX package sets it only on
    the first Env of a statement: ROADMAP section 3)."""
    env = Env(table, aliases, device=session.device)
    env.subquery_runner = lambda sub: execute_any(session, sub)
    env.dictionaries = session.dictionaries
    env.session = session                 # joinGet's Join-engine tables
    return env


# ---------------------------------------------------------------------------
# arrayJoin() and [LEFT] ARRAY JOIN

def _rewrite_arrayjoin_calls(q: SelectQuery):
    """Rewrite arrayJoin(arr) calls into internal ARRAY JOIN items named
    ``__aj<i>``, one per distinct argument: identical arguments expand
    together, distinct ones one after another (a cartesian product)."""
    from dataclasses import replace as dc_replace
    mapping: dict = {}

    def rewrite(e):
        if isinstance(e, FuncCall):
            if e.name.lower() == "arrayjoin" and len(e.args) == 1:
                key = render(e.args[0])
                if key not in mapping:
                    mapping[key] = (f"__aj{len(mapping)}", rewrite(e.args[0]))
                return Ident(mapping[key][0])
            return FuncCall(e.name, [rewrite(a) for a in e.args], e.distinct)
        if isinstance(e, BinOp):
            return BinOp(e.op, rewrite(e.left), rewrite(e.right))
        if isinstance(e, UnOp):
            return UnOp(e.op, rewrite(e.operand))
        if isinstance(e, Between):
            return Between(rewrite(e.expr), rewrite(e.low), rewrite(e.high),
                           e.negated)
        if isinstance(e, InList):
            return InList(rewrite(e.expr), e.items, e.negated)
        return e

    new_items = []
    for it in q.items:
        ne = rewrite(it.expr)
        if ne is not it.expr:
            new_items.append(SelectItem(ne, it.alias or render(it.expr)))
        else:
            new_items.append(it)
    if not mapping:
        return q
    new_where = rewrite(q.where) if q.where is not None else None
    new_having = rewrite(q.having) if q.having is not None else None
    new_group = [rewrite(g) for g in q.group_by]
    # as in the JAX package, the rewritten ORDER BY keeps no WITH FILL
    new_order = [OrderItem(rewrite(o.expr), o.ascending, o.nulls_last)
                 for o in q.order_by]
    ajs = list(q.array_joins) + [(expr, alias, False)
                                 for alias, expr in mapping.values()]
    return dc_replace(q, items=new_items, where=new_where, having=new_having,
                      group_by=new_group, order_by=new_order, array_joins=ajs)


def _is_call_item(item) -> bool:
    """An ARRAY JOIN item made from an arrayJoin() call."""
    return (item[1] or "").startswith("__aj")


def _names_read(exprs) -> set:
    names = set()
    for e in exprs:
        for node in walk(e):
            if isinstance(node, Ident):
                names.add(node.name)
                names.add(node.qualified)
            elif isinstance(node, WindowCall):
                names.update(i.name for p in node.partition_by
                             for i in walk(p) if isinstance(i, Ident))
    return names


def _referenced_columns(q: SelectQuery):
    """Names the query reads after its ARRAY JOIN, or None when a ``*``
    reads every column."""
    exprs = [it.expr for it in q.items]
    if any(isinstance(e, Star) for e in exprs):
        return None
    exprs += [e for e in (q.where, q.prewhere, q.having) if e is not None]
    exprs += list(q.group_by) + [o.expr for o in q.order_by]
    exprs += [e for _n, e in q.with_aliases]
    if q.limit_by is not None:
        exprs += list(q.limit_by[1])
    for spec in (q.windows or {}).values():
        exprs += list(spec[0]) + [o.expr for o in spec[1]]
    return _names_read(exprs)


def apply_array_join(session, table: Table, items: list,
                     keep=None) -> Table:
    """[LEFT] ARRAY JOIN: expand each row into one row per array element.
    All joined arrays must have equal per-row lengths; LEFT keeps rows with
    empty arrays, filling the element with the type default.  Row ids and
    element positions are made on the device (``repeat_interleave`` over
    the row lengths); the other columns follow by one gather.  ``keep``:
    the column names the query reads later (None: all), the only other
    columns carried (the rows are the same; the JAX package carries all).
    Without any, an inner ARRAY JOIN makes no row ids: its element column
    is the array's flat tensor as it is."""
    dev = session.device
    env = _session_env(session, table)
    n = table.n_rows
    is_left = any(left for _, _, left in items)
    cols = []      # (out_name, flat, dictionary, replaces_source, umax)
    off = None
    for expr, alias, _ in items:
        v = eval_expr(expr, env)
        flat, o, d = as_array(v, env)
        if off is None:
            off = o
        elif o is not off and not torch.equal(device_offsets(o, dev),
                                              device_offsets(off, dev)):
            raise ExecError("ARRAY JOIN requires arrays of equal sizes")
        out_name = alias or render(expr)
        replaces = alias is None and isinstance(expr, Ident)
        cols.append((out_name, flat, d, replaces, v.umax))
    doff = device_offsets(off, dev)
    lens = doff[1:] - doff[:-1]
    total = offsets_total(off)
    out_lens, out_doff, total_out = lens, doff, total
    if is_left:
        out_lens = torch.clamp(lens, min=1)
        out_doff = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        torch.cumsum(out_lens, 0, out=out_doff[1:])
        total_out = int(out_doff[-1]) if n else 0
    replaced = {name for name, _, _, rep, _ in cols if rep}
    base_cols = [c for c in table.columns.values()
                 if c.name not in replaced and (
                     keep is None or c.name in keep
                     or c.name.rsplit(".", 1)[-1] in keep)]
    rid = None
    if base_cols or is_left:
        rid = torch.repeat_interleave(torch.arange(n, device=dev), out_lens,
                                      output_size=total_out)
    src = real = None
    if is_left:
        pos = torch.arange(total_out, device=dev) \
            - out_doff[:-1].index_select(0, rid)
        real = pos < lens.index_select(0, rid)
        src = torch.where(real, doff[:-1].index_select(0, rid) + pos, 0)
        all_real = bool(real.all())
    out = Table(base_cols, name=table.name).take(rid) if base_cols \
        else Table([], name=table.name)
    for name, flat, d, _, umax in cols:
        data = flat
        if src is not None:
            data = flat.index_select(0, src) if total else \
                torch.zeros(total_out, dtype=flat.dtype, device=dev)
            if not all_real:
                default = d.encode_one("", grow=True) if d is not None \
                    else 0
                data = torch.where(real, data,
                                   torch.tensor(default, dtype=data.dtype,
                                                device=dev))
        dt = DataType.STRING if d is not None else \
            _logical_dtype_of(data, Value(data, umax=umax))
        out = out.with_column(Column(Field(name, dt), data, None, d))
    return out


# ---------------------------------------------------------------------------
# UNION / INTERSECT / EXCEPT

def _align_to(first: Table, p: Table) -> Table:
    """Rename p's columns positionally to match first's (set-op alignment)."""
    if len(p.column_names) != len(first.column_names):
        raise ExecError("set operation arity mismatch")
    cols = []
    for tgt_name, c in zip(first.column_names, p.columns.values()):
        cols.append(Column(Field(tgt_name, c.dtype, c.field.nullable,
                                 c.field.vector_dim, c.field.elem),
                           c.data, c.valid, c.dictionary, None,
                           c.offsets))
    return Table(cols)


# the kinds of value a set-operation key compares (a NULL is its own kind:
# the JAX package compares to_python() values, and None equals None)
_K_NULL, _K_NUM, _K_STR, _K_DATE, _K_DATETIME, _K_SEQ = range(6)


def _key_kind(dtype, dictionary, seq: bool) -> int:
    if seq:
        return _K_SEQ
    if dictionary is not None:
        return _K_STR
    return {DataType.DATE: _K_DATE,
            DataType.DATETIME: _K_DATETIME}.get(dtype, _K_NUM)


def _pair_keys(lx, lkind, lmeta, rx, rkind, rmeta, dev):
    """Two int64 key columns over the rows of both sides (left, then
    right) whose equality is Python's equality of the values: strings of
    two dictionaries through one merged dictionary, an integer equal to
    the float of the same value, -0.0 equal to 0.0, a NaN equal to
    nothing, a UInt64 past 2^63-1 unequal to the negative integer of the
    same bits.  Values of two kinds never compare equal (the kind is a
    key column of its own).  lmeta/rmeta: (dictionary, u64)."""
    nl, nr = lx.shape[0], rx.shape[0]
    zero = torch.zeros(nl + nr, dtype=torch.int64, device=dev)
    if lkind != rkind:
        return zero, zero
    if lkind == _K_STR:
        base = StringDictionary()
        parts = []
        for x, (d, _u) in ((lx, lmeta), (rx, rmeta)):
            remap = base.merge_from(d)
            lut = to_tensor(np.append(remap, -1).astype(np.int64), dev)
            parts.append(lut[torch.where(x < 0, len(remap), x).long()])
        return torch.cat(parts), zero
    if lx.is_floating_point() or rx.is_floating_point():
        x = torch.cat([_f64_of(lx, lmeta[1]), _f64_of(rx, rmeta[1])]) + 0.0
        nan = torch.isnan(x)
        return torch.where(nan, 0.0, x).view(torch.int64), \
            torch.where(nan, torch.arange(1, nl + nr + 1, device=dev), 0)
    big = [x.to(torch.int64) < 0 if u else
           torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
           for x, u in ((lx, lmeta[1]), (rx, rmeta[1]))]
    return torch.cat([lx.to(torch.int64), rx.to(torch.int64)]), \
        torch.cat(big).to(torch.int64)


def _f64_of(x: torch.Tensor, u64: bool) -> torch.Tensor:
    x64 = x.to(torch.float64)
    if u64:
        x64 = x64 + (x < 0).to(torch.float64) * 2.0 ** 64
    return x64


def _seq_row_ids(lseq, rseq, lmeta, rmeta, dev) -> torch.Tensor:
    """One int64 key per array (or vector) row of both sides, equal where
    the rows hold equal elements in the same order: element keys by
    ``_pair_keys``, element ids by one unique, then one unique over the
    rows' (length, element ids) padded to the longest row."""
    (lf, loff), (rf, roff) = lseq, rseq
    ekind = [_key_kind(None, m[0], False) for m in (lmeta, rmeta)]
    ea, eb = _pair_keys(lf, ekind[0], lmeta, rf, ekind[1], rmeta, dev)
    etag = torch.cat([torch.full((lf.shape[0],), ekind[0], device=dev),
                      torch.full((rf.shape[0],), ekind[1], device=dev)])
    doff = torch.cat([loff, roff[1:] + loff[-1]])
    lens = doff[1:] - doff[:-1]
    rows = lens.shape[0]
    total = lf.shape[0] + rf.shape[0]
    if total == 0:
        return torch.zeros(rows, dtype=torch.int64, device=dev)
    _, eid = torch.unique(torch.stack([etag, ea, eb], dim=1), dim=0,
                          return_inverse=True)
    width = int(lens.max())
    rid = torch.repeat_interleave(torch.arange(rows, device=dev), lens,
                                  output_size=total)
    pos = torch.arange(total, device=dev) - doff[:-1].index_select(0, rid)
    mat = torch.full((rows, width + 1), -1, dtype=torch.int64, device=dev)
    mat[:, 0] = lens
    mat[rid, pos + 1] = eid
    return torch.unique(mat, dim=0, return_inverse=True)[1]


def _seq_parts(c: Column, dev):
    """(flat elements, device offsets) of an ARRAY or vector column."""
    if c.offsets is not None:
        return c.data, device_offsets(c.offsets, dev)
    n, k = c.data.shape[0], c.data.shape[1]
    return c.data.reshape(-1), torch.arange(n + 1, device=dev) * k


def _set_op_keep(left: Table, right: Table, intersect: bool, dev):
    """Which left rows INTERSECT (EXCEPT) keeps, with multiset semantics:
    a row whose value tuple occurs c_R times on the right keeps its first
    min(c_L, c_R) copies under INTERSECT, and EXCEPT keeps the others, in
    the left side's order; tuples compare as the JAX package's Python
    tuples of to_python() values do.  On the device: every column pair
    encoded into comparable int64 keys, one unique over the keys of both
    sides, then each left row's rank within its key from a stable sort."""
    nl, nr = left.n_rows, right.n_rows
    keys = []
    for lc, rc in zip(left.columns.values(), right.columns.values()):
        lx, rx = (to_tensor(c.data, dev) if c.is_host else c.data
                  for c in (lc, rc))
        lseq = lc.offsets is not None or lx.dim() > 1
        rseq = rc.offsets is not None or rx.dim() > 1
        lk = _key_kind(lc.dtype, lc.dictionary, lseq)
        rk = _key_kind(rc.dtype, rc.dictionary, rseq)
        lmeta = (lc.dictionary, lc.dtype is DataType.UINT64)
        rmeta = (rc.dictionary, rc.dtype is DataType.UINT64)
        if lk == rk == _K_SEQ:
            a = _seq_row_ids(_seq_parts(lc, dev), _seq_parts(rc, dev),
                             lmeta, rmeta, dev)
            b = torch.zeros_like(a)
        elif _K_SEQ in (lk, rk):
            a = b = torch.zeros(nl + nr, dtype=torch.int64, device=dev)
        else:
            a, b = _pair_keys(lx, lk, lmeta, rx, rk, rmeta, dev)
        kind = torch.cat([torch.full((nl,), lk, device=dev),
                          torch.full((nr,), rk, device=dev)])
        valid = torch.cat([_valid_rows(c, dev) for c in (lc, rc)])
        keys += [torch.where(valid, kind, _K_NULL),
                 torch.where(valid, a, 0), torch.where(valid, b, 0)]
    if nl == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    if not keys:
        keys = [torch.zeros(nl + nr, dtype=torch.int64, device=dev)]
    _, gid = torch.unique(torch.stack(keys, dim=1), dim=0,
                          return_inverse=True)
    gl = gid[:nl]
    count_r = torch.bincount(gid[nl:], minlength=nl + nr).index_select(0, gl)
    order = torch.sort(gl, stable=True).indices
    gs = gl.index_select(0, order)
    first = torch.ones(nl, dtype=torch.bool, device=dev)
    first[1:] = gs[1:] != gs[:-1]
    run = torch.cumsum(first, 0) - 1
    starts = torch.nonzero(first).flatten()
    rank = torch.empty(nl, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(nl, device=dev) - starts.index_select(0, run)
    return rank < count_r if intersect else rank >= count_r


def _valid_rows(c: Column, dev) -> torch.Tensor:
    n = len(c)
    if c.valid is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    v = to_tensor(c.valid, dev) if c.is_host else c.valid
    return v.expand(n) if v.dim() == 0 else v


def _reject_unported(q: SelectQuery) -> None:
    """Raise NotPortedError for every clause the JAX executor runs and this
    one does not yet."""
    tf = getattr(q, "table_function", None)
    if tf is not None and tf[0] not in ("numbers", "ftsindex"):
        raise NotPortedError(f"table function {tf[0]}()",
                             "storage, formats and runtime state")
    if q.sample is not None:
        raise NotPortedError("SAMPLE", "storage, formats and runtime state")


def execute_any(session, q) -> Table:
    """Dispatch SelectQuery | UnionQuery (UNION [ALL|DISTINCT] / INTERSECT
    / EXCEPT [DISTINCT])."""
    if isinstance(q, UnionQuery):
        ops = q.ops or ["UNION ALL"] * (len(q.selects) - 1)
        result = execute_any(session, q.selects[0])
        for op, sel in zip(ops, q.selects[1:]):
            p = _align_to(result, execute_any(session, sel))
            if op in ("UNION ALL", "UNION DISTINCT"):
                result = concat_tables([result, p], name=result.name)
                if op == "UNION DISTINCT" and result.n_rows:
                    result = _distinct_rows(result)
            else:
                # INTERSECT / EXCEPT [DISTINCT]: multiset semantics for
                # the ALL forms, set semantics for DISTINCT
                with span("set_operation", op=op, rows=result.n_rows):
                    keep = _set_op_keep(result, p,
                                        op.startswith("INTERSECT"),
                                        session.device)
                    result = result.take(torch.nonzero(keep).flatten())
                if op.endswith("DISTINCT") and result.n_rows:
                    result = _distinct_rows(result)
        return result
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
    # inner ORDER BYs the outer query destroys (FROM and IN subqueries)
    remove_redundant_sorting(q)
    # CTEs: materialized into session tables for this statement, the
    # earlier bindings restored even when the statement raises
    if q.ctes:
        saved = {}
        try:
            for name, sub in q.ctes:
                saved.setdefault(name, session.tables.get(name))
                t = execute_any(session, sub)
                t.name = name
                session.tables[name] = t
            return execute_select(session,
                                  SelectQuery(**{**vars(q), "ctes": []}))
        finally:
            for name, old in saved.items():
                if old is None:
                    session.tables.pop(name, None)
                else:
                    session.tables[name] = old
    # uncorrelated scalar / EXISTS subqueries -> constants
    slots = [it.expr for it in q.items] + \
        [e for e in (q.where, q.prewhere, q.having) if e is not None] + \
        list(q.group_by) + [o.expr for o in q.order_by] + \
        [e for _, e in q.with_aliases]
    if any(_has_subqueries(e) for e in slots):
        from dataclasses import replace as dc_replace

        def res(e):
            return None if e is None else _resolve_subqueries(e, session)
        q = dc_replace(
            q, items=[SelectItem(res(it.expr), it.alias) for it in q.items],
            where=res(q.where), prewhere=res(q.prewhere),
            having=res(q.having), group_by=[res(e) for e in q.group_by],
            order_by=[OrderItem(res(o.expr), o.ascending, o.nulls_last,
                                o.fill) for o in q.order_by],
            with_aliases=[(n, res(e)) for n, e in q.with_aliases])
    _reject_unported(q)
    # an aggregate projection answers a matching GROUP BY from its cached
    # grouped table (optimizeUseAggregateProjection); the rewrite skips the
    # base table's read, so its SELECT privilege is checked here, and a
    # user under row policies reads the real rows
    pm = match_projection(session, q)
    if pm is not None:
        session.access.check(session.current_user, "SELECT", q.table)
        if session.access.row_policy_exprs(session.current_user,
                                           q.table)[0]:
            pm = None
    if pm is not None:
        sidecar, new_q, hidden = apply_projection(session, q, pm)
        saved_tbl = session.tables.get(hidden)
        try:
            sidecar.name = hidden
            session.tables[hidden] = sidecar
            return execute_select(session, new_q)
        finally:
            if saved_tbl is None:
                session.tables.pop(hidden, None)
            else:
                session.tables[hidden] = saved_tbl
    dev = session.device
    # arrayJoin() calls become ARRAY JOIN items before the LIMIT pushdown
    # looks at the query, so LIMIT counts the expanded rows (the JAX
    # package pushes the LIMIT first: ROADMAP section 3)
    q = _rewrite_arrayjoin_calls(q)

    # 1. source
    if getattr(q, "table_function", None) is not None:
        kind, params = q.table_function
        if kind == "ftsindex":
            base = _ftsindex_table(session, *params)
        else:
            # numbers(n) / numbers(a, n): UInt64 0..n-1 / a..a+n-1
            a, b = params
            start, count = (0, a) if b is None else (a, b)
            base = Table([Column.from_numpy(
                "number", np.arange(start, start + count, dtype=np.uint64),
                build_zonemap=False, device=dev)])
    elif q.subquery is not None:
        base = execute_any(session, q.subquery)
    elif q.table is not None:
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
    for jc in q.joins:
        table = apply_join(session, table, jc, alias_prefixes, settings)
    if q.array_joins:
        # the ARRAY JOIN clause's arrays expand together, then each distinct
        # arrayJoin() argument on its own: a cartesian product (the JAX
        # package expands them all together and fails unless their sizes
        # agree: ROADMAP section 3)
        refs = _referenced_columns(q)
        called = [it for it in q.array_joins if _is_call_item(it)]
        clause = [it for it in q.array_joins if not _is_call_item(it)]
        groups = ([clause] if clause else []) + [[it] for it in called]
        with span("array_join", rows=table.n_rows):
            for i, items in enumerate(groups):
                # carried: what the query and the later groups read
                keep = None if refs is None else refs | _names_read(
                    e for g in groups[i + 1:] for e, _a, _l in g)
                table = apply_array_join(session, table, items, keep)

    env = _session_env(session, table, alias_prefixes)
    alias_exprs = {it.alias: it.expr for it in q.items if it.alias}
    for _wname, _wexpr in q.with_aliases:
        alias_exprs.setdefault(_wname, _wexpr)
    tuple_groups: dict[str, list] = {}

    # 2. search analysis (vector / text / hybrid pseudo-functions)
    with span("analyze"):
        vs = analyze_vector_search(q, session, table, alias_exprs) \
            if q.table is not None else None
        ts = analyze_text_search(q, session, table, alias_exprs) \
            if q.table is not None else None

    # 3. WHERE/PREWHERE split into pre-search and post-search terms
    def refs_dist(e: Expr) -> bool:
        searches = [x for x in (vs, ts) if x is not None]
        for node in walk(e):
            r = render(node)
            for x in searches:
                if r == x.name:
                    return True
                if isinstance(node, Ident) and node.table is None \
                        and x.alias and node.name == x.alias:
                    return True
        return False

    conjuncts = _split_conjuncts(q.prewhere) + _split_conjuncts(q.where)
    pre_terms = [c for c in conjuncts if not refs_dist(c)]
    post_terms = [c for c in conjuncts if refs_dist(c)]
    pre_expr = _conjoin([_expand_item_aliases(c, alias_exprs, table)
                         for c in pre_terms])
    # zone-map and skip-index pruning: if the block statistics prove the
    # filter empty, short-cut the whole scan.  A text search keeps every
    # row: its BM25 statistics and its index cover the whole table, and the
    # filter becomes its mask (the JAX package prunes here and scores the
    # kept blocks alone).  A fused vector search keeps every row too, the
    # pruned blocks deselected in its mask: the column's cached norms and
    # SQ8 sidecar then serve it, and as a block (2^16 rows) is a whole
    # number of K1's 128-row segments, its rows, distances and ties are
    # those of a scan over the kept blocks alone
    block_sel = None
    if pre_terms and ts is None:
        bmask = _zonemap_block_mask(
            table, [_expand_item_aliases(c, alias_exprs, table)
                    for c in pre_terms], session)
        if bmask is not None and not bmask.all():
            nblocks = int(bmask.sum())
            M.increment("ZonemapPrunedBlocks", len(bmask) - nblocks)
            if nblocks == 0:
                M.increment("ZonemapPrunedScans")
                table = table.head(0)
                env = _session_env(session, table, alias_prefixes)
                pre_terms, post_terms = [], []
                pre_expr = None
            else:
                nrows = table.n_rows
                tail = nrows - (len(bmask) - 1) * BLOCK_ROWS
                kept = nblocks * BLOCK_ROWS - (BLOCK_ROWS - tail
                                               if bmask[-1] else 0)
                M.increment("ZonemapSkippedRows", nrows - kept)
                if vs is not None and vs.fused:
                    block_sel = torch.repeat_interleave(
                        torch.as_tensor(bmask, device=dev), BLOCK_ROWS,
                        output_size=len(bmask) * BLOCK_ROWS)[:nrows]
                else:
                    # gather only the candidate blocks into the scan: their
                    # row ids made on the device from the kept block ids
                    # (the last block, if kept, is cut to the table's end)
                    kb = torch.as_tensor(np.flatnonzero(bmask), device=dev)
                    rows = (kb[:, None] * BLOCK_ROWS + torch.arange(
                        BLOCK_ROWS, device=dev)).reshape(-1)[:kept]
                    table = table.take(rows)
                    env = _session_env(session, table, alias_prefixes)
    mask = None
    if pre_expr is not None:
        mask = as_bool_mask(eval_expr(pre_expr, env), table.n_rows)
    if block_sel is not None:
        mask = block_sel if mask is None else mask & block_sel

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
            elif vs.binary:
                # binary vector scan: XOR/AND/OR + popcount on packed
                # words (BruteForceSearch.h:95-110); the packed sidecar
                # belongs to the BASE table and is cached per table epoch
                base_tab = session.tables.get(q.table) if q.table else None
                qw = words_tensor(vs.qvec, dev)
                if base_tab is not None and vs.col in base_tab and \
                        base_tab[vs.col].data is table[vs.col].data:
                    x3, n_rows = _binary_sidecar(session, q.table, table,
                                                 vs.col)
                    d, ids = binary_distance_scan(x3, qw, metric=vs.metric,
                                                  k=vs.k, mask=mask,
                                                  layout="segs", n=n_rows)
                else:                  # scanned column was replaced: pack
                    xw = words_tensor(_pack_column(table[vs.col]), dev)
                    d, ids = binary_distance_scan(xw, qw, metric=vs.metric,
                                                  k=vs.k, mask=mask)
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
            with span("materialize", rows=int(ids.numel())):
                table, env = _materialize_topk(table, vs, d, ids,
                                               tuple_groups, dev)
                env.subquery_runner = lambda sub: execute_any(session, sub)
        mask = None
        # post-search filters on the distance value (WHERE d < x applies
        # AFTER the top-k search)
        if post_terms:
            pe = _conjoin([substitute(c, {vs.name: vs.name})
                           for c in post_terms])
            pm = as_bool_mask(eval_expr(pe, env), table.n_rows)
            table, _ = compact_table_host(table, pm)
            env = _session_env(session, table)
            if vs.alias and vs.name in table:
                c = table[vs.name]
                env.extra[vs.alias] = Value(c.data, c.valid)
            post_terms = []
    elif ts is not None and ts.fused:
        # 4a'. fused text / hybrid top-k
        d2, i2 = _text_search_topk(session, q, table, ts, mask, settings)
        with span("materialize", rows=int(i2.numel())):
            table, env = _materialize_topk(table, ts, d2, i2, tuple_groups,
                                           dev)
            env.subquery_runner = lambda sub: execute_any(session, sub)
        mask = None
        if post_terms:
            pe = _conjoin([substitute(c, {ts.name: ts.name})
                           for c in post_terms])
            pm = as_bool_mask(eval_expr(pe, env), table.n_rows)
            table, _ = compact_table_host(table, pm)
            env = _session_env(session, table)
            if ts.alias and ts.name in table:
                c = table[ts.name]
                env.extra[ts.alias] = Value(c.data, c.valid)
            post_terms = []
    elif ts is not None and ts.kind == "text":
        # non-fused TextSearch: the full score column, masked like the JAX
        # package's; the score terms of the WHERE filter it afterwards (the
        # JAX package drops them)
        idx = _get_text_index(session, q.table, table, ts.text_col)
        sc = idx.scores(ts.query, ts.operator)
        if mask is not None:
            sc = torch.where(mask, sc, 0.0)
        env.extra[ts.name] = Value(sc)
        if ts.alias:
            env.extra[ts.alias] = Value(sc)
        if post_terms:
            pe = _conjoin([substitute(_expand_item_aliases(c, alias_exprs,
                                                           table),
                                      {ts.name: ts.name})
                           for c in post_terms])
            pm = as_bool_mask(eval_expr(pe, env), table.n_rows)
            mask = pm if mask is None else mask & pm
            post_terms = []
    elif ts is not None:
        raise ExecError("HybridSearch requires ORDER BY <score> DESC LIMIT k")
    elif vs is not None:
        if vs.binary:
            # the JAX package runs the float formula over the string ids
            # here (ROADMAP queue 3)
            raise NotPortedError("binary distance() outside ORDER BY "
                                 "distance LIMIT k",
                                 "expression and function breadth")
        # non-fused: materialize the full distance column (batch_distance
        # always fuses: _apply_vs_fusion refuses it without LIMIT BY)
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
            for node in walk_outside_windows(e):
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
        env = _session_env(session, table)
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
            env = _session_env(session, table)
        # default deterministic order: by group key columns ascending
        if not order_by and q.group_by:
            order_by = [OrderItem(Ident(render(k)), True, True)
                        for k in q.group_by]
    else:
        items = q.items
        order_by = q.order_by
        if mask is not None:
            carry_ts = ts is not None and not ts.fused \
                and ts.name in env.extra
            keep = torch.nonzero(mask.bool()).flatten() if carry_ts else None
            table, _ = compact_table_host(table, mask)
            new_env = _session_env(session, table, alias_prefixes)
            # recompute the non-fused distance on the compacted table
            if vs is not None and not vs.fused and vs.name in env.extra:
                dist = rowwise_distance(table[vs.col].data, vs.qvec,
                                        vs.metric)
                new_env.extra[vs.name] = Value(dist)
                if vs.alias:
                    new_env.extra[vs.alias] = Value(dist)
            # the non-fused text score follows its rows (the JAX package
            # loses it here and fails on the TextSearch() call)
            if carry_ts:
                sc = Value(env.extra[ts.name].data[keep])
                new_env.extra[ts.name] = sc
                if ts.alias:
                    new_env.extra[ts.alias] = sc
            env = new_env
            mask = None

    # 4c. window functions: computed into extra columns before projection
    _compute_windows(items + [SelectItem(o.expr) for o in order_by], env,
                     table, alias_exprs, session)

    # 5. projection (before sort: aliases must exist as columns for ORDER BY)
    out_cols, out_order = _project(items, env, table, alias_exprs,
                                   tuple_groups, dev)
    proj_table = Table(out_cols, name=table.name)

    # 5b. DISTINCT (before ORDER BY, SQL semantics): keep the first row of
    # each distinct projected tuple
    if q.distinct and proj_table.n_rows:
        proj_table = _distinct_rows(proj_table)

    # 6. ORDER BY
    if order_by:
        n2 = proj_table.n_rows
        sks = []
        penv = _session_env(session, proj_table)
        for o in order_by:
            oe = _expand_item_aliases(o.expr, alias_exprs, table)
            # resolve against projected/materialized columns first (a fused
            # distance column exists by its rendered name), then evaluate
            v = None
            for cn in (render(o.expr), render(oe)):
                for t in (proj_table, table):
                    if cn in t:
                        c = t[cn]
                        v = Value(c.data, c.valid, c.dictionary,
                                  offsets=c.offsets,
                                  u64=c.dtype is DataType.UINT64)
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
        has_fill = any(o.fill is not None for o in order_by)
        on_host = any(isinstance(sk.values, np.ndarray) for sk in sks)
        # read-in-order (optimizeReadInOrder.cpp analog): for one plain
        # ascending key over a large table, ONE monotonicity pass detects
        # already-ordered data; the identity permutation is the stable
        # sort's
        if (len(sks) == 1 and not has_fill and n2 >= (1 << 20)
                and sks[0].ascending and sks[0].valid is None
                and not on_host and sks[0].values.dim() == 1):
            d0 = sks[0].values
            if bool(torch.all(d0[1:] >= d0[:-1])):
                M.increment("ReadInOrderSorts")
                if q.limit is not None and q.limit_by is None:
                    hi = min(q.limit + q.offset, n2)
                    proj_table = proj_table.take(torch.arange(hi,
                                                              device=dev))
                sks = None
        if sks is not None:
            with span("sort", rows=n2, keys=len(sks)):
                if q.limit is not None and q.limit_by is None \
                        and not has_fill:
                    if on_host:
                        # host-resident sort key: external top-n (spill
                        # tier = host RAM, MergeSortingTransform.h:29
                        # analog)
                        M.increment("StreamingTopN")
                        perm = streaming_topn_permutation(
                            sks, q.limit + q.offset, n2,
                            settings.stream_chunk_rows, device=dev)
                    else:
                        perm = topn_permutation(sks, q.limit + q.offset,
                                                n2)
                else:
                    perm = sort_permutation([_key_on_device(sk, dev)
                                             for sk in sks])
            proj_table = proj_table.take(perm)
            if has_fill:
                proj_table = _apply_with_fill(proj_table, order_by)

    # 7. LIMIT BY
    if q.limit_by is not None:
        nlb, lb_exprs = q.limit_by
        with span("limit_by", rows=proj_table.n_rows):
            proj_table = _limit_by(proj_table, lb_exprs, nlb, alias_exprs,
                                   table, dev)

    # 8. OFFSET / LIMIT
    if q.limit is not None or q.offset:
        n_out = proj_table.n_rows
        lo = min(q.offset, n_out)
        hi = (q.offset + q.limit) if q.limit is not None else n_out
        idx = torch.arange(lo, min(hi, n_out), device=dev)
        if len(idx) < proj_table.n_rows:
            proj_table = proj_table.take(idx)

    # order output columns as written
    final = proj_table.select(out_order)
    final.tuple_groups = tuple_groups
    if totals_src is not None:
        tcols, torder = _project(items, _session_env(session, totals_src),
                                 totals_src, alias_exprs, {}, dev)
        final.totals = Table(tcols, name="totals").select(torder)
    return final


def _materialize_topk(table: Table, vs, d, ids, tuple_groups, device):
    """Gather the top-k rows of a VSInfo or a TSInfo search and attach its
    distance or score column — for
    batch_distance the (query index, distance) tuple members ``<alias>.1``
    (UInt32) and ``<alias>.2`` (Float32), rows in query order."""
    d_np = d.cpu().numpy()
    ids_np = ids.cpu().numpy()
    nq = ids_np.shape[0]
    rows, qids, dists = [], [], []
    for qi in range(nq):
        valid = ids_np[qi] != INVALID_ID
        rows.append(ids_np[qi][valid])
        dists.append(d_np[qi][valid])
        qids.append(np.full(valid.sum(), qi, dtype=np.uint32))
    rows = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64)
    gathered = table.take(torch.as_tensor(rows, device=device))
    dist_col = np.concatenate(dists).astype(np.float32) if dists else \
        np.zeros(0, dtype=np.float32)
    if vs.is_batch:
        alias = vs.alias or vs.name
        c1 = Column.from_numpy(alias + ".1", np.concatenate(qids),
                               DataType.UINT32, build_zonemap=False,
                               device=device)
        c2 = Column(Field(alias + ".2", DataType.FLOAT32),
                    to_tensor(dist_col, device))
        gathered = gathered.with_column(c1).with_column(c2)
        tuple_groups[alias] = [alias + ".1", alias + ".2"]
        if alias != vs.name:
            tuple_groups[vs.name] = tuple_groups[alias]
        return gathered, Env(gathered, device=device)
    col = Column(Field(vs.name, DataType.FLOAT32), to_tensor(dist_col,
                                                             device))
    gathered = gathered.with_column(col)
    env = Env(gathered, device=device)
    if vs.alias:
        env.extra[vs.alias] = Value(col.data, col.valid)
    return gathered, env


def _project(items, env: Env, table: Table, alias_exprs, tuple_groups,
             device):
    out_cols: list[Column] = []
    out_order: list[str] = []
    seen = set()
    n = table.n_rows

    def emit_members(group):
        for member in group:
            if member not in seen:
                out_cols.append(table[member])
                out_order.append(member)
                seen.add(member)

    for it in items:
        if isinstance(it.expr, Star):
            for c in table.columns.values():
                if c.name.startswith("__"):
                    continue   # hidden columns
                if any(c.name in grp for grp in tuple_groups.values()):
                    continue   # tuple members emitted via their group
                if c.name not in seen:
                    out_cols.append(c)
                    out_order.append(c.name)
                    seen.add(c.name)
            continue
        e = _expand_item_aliases(it.expr, alias_exprs, table)
        name = it.alias or render(it.expr)
        if name in seen and name not in tuple_groups:
            # repeated select item: the reference emits both columns under
            # one display name; Table keys are unique, so suffix \x00k
            k = 2
            while f"{name}\x00{k}" in seen:
                k += 1
            name = f"{name}\x00{k}"
        # tuple column (batch distance): the item emits its member columns
        if name in tuple_groups or render(e) in tuple_groups:
            emit_members(tuple_groups[name if name in tuple_groups
                                      else render(e)])
            continue
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


def _limit_by(table: Table, lb_exprs, nlb: int, alias_exprs, src_table,
              device) -> Table:
    """LIMIT n BY exprs: keep the first n rows per key group, preserving the
    current (post-ORDER BY) row order.  On the device: group ids by
    ``torch.unique`` over the keys, each row's rank in its group from a
    stable sort of the ids.  Keys compare as the JAX package's host loop
    compares them: by value, -0.0 equal to 0.0, every NaN its own group."""
    n = table.n_rows
    penv = Env(table, device=device)
    rows = torch.arange(n, device=device)
    cols = []
    for e in lb_exprs:
        v = eval_expr(_expand_item_aliases(e, alias_exprs, src_table), penv)
        d = v.data.expand(n) if v.is_scalar else v.data
        if d.is_floating_point():
            cols.append(torch.where(torch.isnan(d), rows, -1))
            d = d + 0.0                       # -0.0 -> 0.0
            d = d.view({2: torch.int16, 4: torch.int32,
                        8: torch.int64}[d.element_size()])
        cols.append(d.to(torch.int64))
    if n == 0:
        return table
    _, gid = torch.unique(torch.stack(cols, dim=1), dim=0,
                          return_inverse=True)
    gsorted, order = torch.sort(gid, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=device)
    first[1:] = gsorted[1:] != gsorted[:-1]
    start = torch.cummax(torch.where(first, rows, 0), dim=0).values
    keep = torch.empty(n, dtype=torch.bool, device=device)
    keep[order] = (rows - start) < nlb
    return table.take(torch.nonzero(keep).flatten())


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


# ---------------------------------------------------------------------------
# window functions and WITH FILL

def explain_select(session, q: SelectQuery, depth: int = 0) -> list:
    """Textual logical plan (EXPLAIN PIPELINE's stage lines; reference:
    InterpreterExplainQuery), the JAX package's: execute_select's stage
    dispatch, without executing.  No table of the port is distributed, so
    the JAX package's distributed notes never appear."""
    pad = "  " * depth
    steps: list = []

    def add(s_):
        steps.append(pad + s_)

    inner = explain_select(session, q.subquery, depth + 1) \
        if q.subquery is not None else None
    add("Projection [" + ", ".join(
        (it.alias or render(it.expr)) for it in q.items) + "]")
    if q.limit is not None or q.offset:
        add(f"Limit (limit={q.limit}, offset={q.offset})")
    if q.limit_by is not None:
        add(f"LimitBy (n={q.limit_by[0]}, keys=["
            + ", ".join(render(e) for e in q.limit_by[1]) + "])")
    if q.order_by:
        keys = ", ".join(render(o.expr) + ("" if o.ascending else " DESC")
                         for o in q.order_by)
        if q.limit is not None:
            add(f"TopN (k={q.limit + q.offset}, keys=[{keys}])")
        else:
            add(f"Sorting (keys=[{keys}])")
    if q.having is not None:
        add(f"Having ({render(q.having)})")
    table = vs = None
    if q.table is not None:
        try:
            table = session.get_table(q.table)
            alias_exprs = {it.alias: it.expr for it in q.items if it.alias}
            vs = analyze_vector_search(q, session, table, alias_exprs)
        except (ExecError, KeyError):
            pass
    aggs = [render(node) for it in q.items for node in walk(it.expr)
            if isinstance(node, FuncCall) and node.name.lower() in AGG_NAMES]
    if q.group_by or aggs:
        add("Aggregating (keys=[" + ", ".join(render(k) for k in q.group_by)
            + "], aggregates=[" + ", ".join(aggs) + "])")
    if vs is not None and vs.fused:
        add(f"VectorTopK (metric={vs.metric}, k={vs.k}, "
            f"queries={vs.qvec.shape[0]}, two-stage exact scan)")
    elif vs is not None:
        add(f"DistanceMaterialize (metric={vs.metric})")
    if q.where is not None or q.prewhere is not None:
        conds = [render(c) for c in
                 _split_conjuncts(q.prewhere) + _split_conjuncts(q.where)]
        add("Filter (" + " AND ".join(conds) + ")")
    for jc in q.joins:
        add(f"HashJoin ({jc.how} {jc.strictness}, table={jc.table}, "
            f"strategy=hash)")
    if inner is not None:
        add("ReadFromSubquery")
        steps.extend(inner)
    elif q.table is not None:
        add(f"ReadFromTable {q.table}" + (f" ({table.n_rows} rows)"
                                          if table is not None else ""))
    return steps


def _zonemap_possible_blocks(table: Table, conjuncts,
                             session=None) -> Optional[int]:
    """Blocks that can hold rows satisfying the ANDed terms, or None when
    no term prunes; zero means the scan is provably empty."""
    mask = _zonemap_block_mask(table, conjuncts, session)
    return None if mask is None else int(mask.sum())


WINDOW_FNS = {"row_number", "rank", "dense_rank", "sum", "count", "avg",
              "min", "max", "lag", "lead", "first_value", "last_value",
              "ntile"}


def walk_outside_windows(e):
    """walk() that does NOT descend into OVER(...) calls — sum(x) OVER ()
    is a window, not an aggregate."""
    if isinstance(e, WindowCall):
        return
    yield e
    if isinstance(e, BinOp):
        yield from walk_outside_windows(e.left)
        yield from walk_outside_windows(e.right)
    elif isinstance(e, UnOp):
        yield from walk_outside_windows(e.operand)
    elif isinstance(e, FuncCall):
        for a in e.args:
            yield from walk_outside_windows(a)
    elif isinstance(e, Lambda):
        yield from walk_outside_windows(e.body)
    elif isinstance(e, InList):
        yield from walk_outside_windows(e.expr)
    elif isinstance(e, Between):
        yield from walk_outside_windows(e.expr)
        yield from walk_outside_windows(e.low)
        yield from walk_outside_windows(e.high)


def _rows_tensor(v: Value, n: int) -> torch.Tensor:
    """A value's (n,) data (a constant broadcast)."""
    return v.data.expand(n) if v.is_scalar else v.data


def _compute_windows(items, env: Env, table: Table, alias_exprs, session):
    """Evaluate every OVER(...) call into env.extra columns (reference:
    WindowTransform runs between aggregation and projection)."""
    wcs = {}
    for it in items:
        for node in walk(it.expr):
            if isinstance(node, WindowCall):
                wcs[render(node)] = node
    if not wcs:
        return
    n = table.n_rows
    dev = session.device

    def arg(e):
        return eval_expr(_expand_item_aliases(e, alias_exprs, table), env)

    layouts: dict = {}
    for r, wc in wcs.items():
        fn = wc.func.name.lower()
        if fn not in WINDOW_FNS:
            raise ExecError(f"unsupported window function {wc.func.name!r}")
        lkey = (tuple(render(p) for p in wc.partition_by),
                tuple((render(o.expr), o.ascending) for o in wc.order_by))
        layout = layouts.get(lkey)
        if layout is None:
            if wc.partition_by:
                gid, _, _ = _group_ids([arg(p) for p in wc.partition_by], n,
                                       None,
                                       session.settings.group_by_capacity_hint)
            else:
                gid = torch.zeros(n, dtype=torch.int32, device=dev)
            operands = []
            for o in wc.order_by:
                nl = o.nulls_last if o.nulls_last is not None else o.ascending
                operands.extend(encode_sort_key(_sort_key_from_value(
                    arg(o.expr), o.ascending, nl, n, dev)))
            layout = WindowLayout(gid, operands, n)
            layouts[lkey] = layout
        if fn in ("row_number", "rank", "dense_rank"):
            env.extra[r] = Value(getattr(layout, fn)())
        elif fn == "ntile":
            env.extra[r] = Value(layout.ntile(int(wc.func.args[0].value)))
        elif fn in ("first_value", "last_value"):
            v = arg(wc.func.args[0])
            out = getattr(layout, fn)(_rows_tensor(v, n))
            env.extra[r] = Value(out, None, v.dictionary)
        elif fn in ("lag", "lead"):
            args = wc.func.args
            if not args:
                raise ExecError(f"{fn} requires a column argument")
            v = arg(args[0])

            def _const(e):
                if isinstance(e, Literal):
                    return e.value
                if isinstance(e, UnOp) and e.op == "-" and \
                        isinstance(e.operand, Literal):
                    return -e.operand.value
                raise ExecError("lag/lead offset/default must be literals")
            offset = int(_const(args[1])) if len(args) > 1 else 1
            default = _const(args[2]) if len(args) > 2 else None
            out, ok = layout.shift(_rows_tensor(v, n), offset,
                                   default if default is not None else 0,
                                   lead=(fn == "lead"))
            valid = None if default is not None else ok
            if v.valid is not None:
                shifted_valid, _ = layout.shift(v.valid, offset, True,
                                                lead=(fn == "lead"))
                valid = shifted_valid if valid is None else \
                    valid & shifted_valid
            env.extra[r] = Value(out, valid, v.dictionary)
        else:
            args = wc.func.args
            if fn == "count" and (not args or isinstance(args[0], Star)):
                out, _ = layout.agg(fn, torch.ones(n, dtype=torch.int64,
                                                   device=dev))
                env.extra[r] = Value(out)
                continue
            v = arg(args[0])
            data = _rows_tensor(v, n)
            valid = v.valid
            if valid is not None and valid.dim() == 0:
                valid = valid.expand(n)
            if not v.is_string or fn == "count":
                out, ok = layout.agg(fn, data, valid)
                env.extra[r] = Value(out, ok)
                continue
            if fn in ("sum", "avg"):
                raise ExecError(f"{fn} over a String column: illegal type "
                                "String of argument")
            # String min/max compare the dictionary's sort ranks and
            # return the string of the winning rank, as _string_state does
            ranks = to_tensor(v.dictionary.ranks(), dev)
            by_rank = to_tensor(np.argsort(v.dictionary.ranks(),
                                           kind="stable"), dev)
            if ranks.numel() == 0:
                env.extra[r] = Value(data, valid, v.dictionary)
                continue
            rk, ok = layout.agg(fn, ranks[data.to(torch.int64).clamp(min=0)],
                                valid)
            env.extra[r] = Value(by_rank[rk].to(torch.int32), ok,
                                 v.dictionary)


def _apply_with_fill(proj_table: Table, order_by) -> Table:
    """ORDER BY x WITH FILL [FROM a] [TO b] [STEP s]: insert rows for grid
    values of x missing from the sorted result; other columns take their
    default values (reference: FillingTransform,
    src/Processors/Transforms/FillingTransform.cpp).  The grid is built on
    the host (fill output is tiny relative to the scan); the rows it adds
    join the table on its device."""
    o = next(o for o in order_by if o.fill is not None)
    name = render(o.expr)
    if name not in proj_table:
        raise ExecError("WITH FILL column must appear in SELECT")
    col = proj_table[name]
    if col.dictionary is not None or col.offsets is not None:
        raise ExecError("WITH FILL requires a numeric column")
    data = col.data if col.is_host else col.data.cpu().numpy()
    f, asc = o.fill, o.ascending
    step = f.get("step", 1 if asc else -1)
    if step == 0 or (step > 0) != asc:
        raise ExecError("WITH FILL STEP sign must match the sort direction")
    if asc:
        start = f.get("from", data.min() if len(data) else None)
        stop = f.get("to", data.max() + step if len(data) else None)
    else:
        start = f.get("from", data.max() if len(data) else None)
        stop = f.get("to", data.min() + step if len(data) else None)
    if start is None or stop is None:
        return proj_table
    if data.dtype.kind in "iu":
        grid = np.arange(int(start), int(stop), int(step),
                         dtype=np.int64).astype(data.dtype)
    else:
        grid = np.arange(start, stop, step).astype(data.dtype)
    missing = grid[~np.isin(grid, data)]
    if len(missing) == 0:
        return proj_table
    k = len(missing)
    dev = proj_table.device
    fill_cols = []
    for c in proj_table.columns.values():
        if c.name == name:
            fill_cols.append(Column(c.field, to_tensor(missing, dev), None))
        elif c.offsets is not None:
            fill_cols.append(Column(
                c.field, c.data[:0], None, c.dictionary,
                None, np.zeros(k + 1, dtype=np.int64)))
        elif c.dictionary is not None:
            empty_id = c.dictionary.encode_one("", grow=True)
            fill_cols.append(Column(
                c.field, torch.full((k,), empty_id, dtype=torch.int32,
                                    device=dev),
                torch.zeros(k, dtype=torch.bool, device=dev)
                if c.field.nullable else None, c.dictionary))
        else:
            fill_cols.append(Column(
                c.field, torch.zeros((k,) + tuple(c.data.shape[1:]),
                                     dtype=c.data.dtype, device=dev),
                torch.zeros(k, dtype=torch.bool, device=dev)
                if c.field.nullable else None))
    combined = concat_tables([proj_table, Table(fill_cols)],
                             name=proj_table.name)
    key = np.concatenate([data, missing]).astype(np.float64)
    order = np.argsort(key if asc else -key, kind="stable")
    return combined.take(torch.as_tensor(order, device=dev))
