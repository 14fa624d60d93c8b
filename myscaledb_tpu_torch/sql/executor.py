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
column (``_set_op_keep``).  The file(), url() and s3() table functions
read an external source through runtime/formats.py, behind
``check_external_source`` (the FILE/URL grants and ``user_files_path``);
SAMPLE keeps the rows whose row-id hash falls under the fraction, hashed
and compacted on the device (``sample_mask``).
A distributed table (parallel/dist_table.py: rows padded to a multiple of
its mesh, a hidden ``__row_valid__`` mask, shard p's rows tensors of
their own on ``mesh.device(p)``) takes the shard bodies of parallel/: the
WHERE mask is evaluated per shard over the shard's rows on its card (the
row mask folded in), and so are the operands of the shard-routed
operators: a fused vector top-k runs ``sharded_distance_topk``; TextSearch
and HybridSearch score each shard under global BM25 statistics
(text/distributed.py); GROUP BY merges per-shard partials
(``sharded_group_aggregate``) or, above
``distributed_group_by_shuffle_threshold`` groups, shuffles rows by group
(``sharded_shuffle_group_states``); ORDER BY ... LIMIT cuts per-shard
top-n candidates (``_distributed_topn_ids``); a join probes per shard
against a build side copied to each card (``_distributed_join``) or
shuffles both sides (``_distributed_shuffle_join``).  What crosses to
shard 0's card: a top-k's, top-n's or shuffle join's rows (``take_rows``
of the ids the shards kept); a GROUP BY's key values and its special
aggregates' arguments (``_cat_values``: the groups are numbered once);
and, for any other statement, the rows the WHERE kept of the columns the
statement names (``undistribute``; a non-fused TextSearch takes every
real row, its index covering them).  Zone-map pruning, the LIMIT
pushdown and the spill route are skipped, and SAMPLE is refused, as in
the JAX package.
``TextSearch`` (BM25, text/bm25.py) and ``HybridSearch`` (RSF/RRF over a
vector and a text candidate list, text/fusion.py) fuse with ORDER BY
<score> DESC LIMIT k; TextSearch outside that is a score column.  Their
index is cached per (table, column, mutation epoch) (``_get_text_index``),
and ``ftsIndex(table, column, 'query')`` reads its statistics.  Error texts the
goldens pin stay byte-equal to the JAX package's.
"""

from __future__ import annotations

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
from myscaledb_tpu_torch.core.derived import _derived, derived_state
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
from myscaledb_tpu_torch.ops.hashtable import (at_run_start, build_group_ids,
                                               INT32_MAX)
from myscaledb_tpu_torch.ops.join import (build_join, probe, probe_any,
                                          grace_hash_join_any,
                                          grace_hash_join_all, rows_to_host,
                                          JoinResult)
from myscaledb_tpu_torch.ops.binary_vector import (BINARY_METRICS,
                                                   binary_distance_scan,
                                                   pack_binary,
                                                   to_segs_layout,
                                                   words_tensor)
from myscaledb_tpu_torch.ops.aggregate import (partial_aggregate_matmul,
                                               finalize, kept_rows_only,
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
from myscaledb_tpu_torch.parallel.dist_table import (ROW_VALID, _set_mesh,
                                                     gather_table,
                                                     is_distributed,
                                                     shard_tables,
                                                     take_rows)
from myscaledb_tpu_torch.parallel.mesh import RowSplit
from myscaledb_tpu_torch.parallel.ops import (sharded_distance_topk,
                                              sharded_group_aggregate,
                                              sharded_topn, sqnorm_parts)
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.memory import charge
from myscaledb_tpu_torch.runtime.tracing import span, sync

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
    if is_distributed(table):
        # over the real rows gathered in order (its doc ids are those of
        # ``gather_table(table)``), kept while the column's parts live
        return derived_state(
            session, ("bm25", table_name, col), table[col].data,
            lambda: BM25Index.from_column(
                gather_table(table, names={col})[col], session.device))
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
    from myscaledb_tpu_torch.text.distributed import sharded_text_search
    dev = session.device
    # a distributed table scores per shard under global statistics: no
    # whole-table index over its rows; ``mask`` is then one per shard
    dist = is_distributed(table)
    idx = None if dist else _get_text_index(session, q.table, table,
                                            ts.text_col)

    def text_topk(k):
        if dist:
            return sharded_text_search(session, q.table, table, ts.text_col,
                                       ts.query, k, mask=mask,
                                       operator=ts.operator)
        return idx.search(ts.query, k, mask=mask, operator=ts.operator)

    if ts.kind == "text":
        with span("text_search", k=ts.k, rows=table.n_rows,
                  distributed=dist):
            scores, ids = text_topk(ts.k)
        return scores[None, :], ids[None, :]
    ncand = ts.k * settings.hybrid_search_top_k_multiple_base
    with span("hybrid_search", k=ts.k, rows=table.n_rows, distributed=dist):
        vcol = table[ts.vec_col]
        qv = torch.as_tensor(ts.qvec, device=dev)
        if dist:
            sqn = _derived(session, "sqnorm", q.table, table, ts.vec_col,
                           lambda c: RowSplit(sqnorm_parts(c.data)))
            vd, vids = sharded_distance_topk(
                table.mesh, vcol.data, qv, ts.metric, ncand, mask=mask,
                block_rows=settings.vector_scan_block_rows, x_sqnorm=sqn)
        elif vcol.is_host:
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
        tscores, tids = text_topk(ncand)
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
    valid = v.valid
    if valid is not None and valid.dim() == 0:
        valid = valid.expand(n).clone()     # a NULL literal's validity
    dt = _logical_dtype_of(data, v)
    fld = Field(name, dt, nullable=valid is not None)
    return Column(fld, data, valid, v.dictionary)


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


def _distributed_topn_ids(q, table, senvs, masks, alias_exprs):
    """ORDER BY ... LIMIT over a distributed table: per-shard top-n and the
    merge cut (``sharded_topn``; the reference's remote stage
    WithMergeableStateAfterAggregationAndLimit) instead of sorting every
    row.  The sort keys are evaluated per shard (``senvs``) on its card.
    Returns the candidate global row ids (limit + offset of them; rows
    failing the shard's mask in ``masks`` sort last and the caller drops
    any in the cut), or None where the pattern does not apply."""
    if not q.order_by or q.limit is None or q.limit_by is not None \
            or q.distinct or q.group_by or q.having is not None:
        return None
    if any(o.fill is not None for o in q.order_by):
        return None
    k = q.limit + q.offset
    if k <= 0 or k >= getattr(table, "real_rows", table.n_rows):
        return None
    for it in list(q.items) + [SelectItem(o.expr) for o in q.order_by]:
        for node in walk(it.expr):
            if isinstance(node, WindowCall):
                return None   # window frames need the full row set
    n = table.n_rows
    # rows failing WHERE (and the mesh padding) sort behind every row
    sks = [SortKey([(~m.bool()).to(torch.int32) for m in masks],
                   ascending=True)]
    try:
        for o in q.order_by:
            oe = _expand_item_aliases(o.expr, alias_exprs, table)
            vals = [eval_expr(oe, se) for se in senvs]
            if any(v.dictionary is not vals[0].dictionary for v in vals):
                return None      # strings ranked by per-shard dictionaries
            nl = o.nulls_last if o.nulls_last is not None else o.ascending
            parts = [_key_on_device(_sort_key_from_value(
                v, o.ascending, nl, se.n_rows, se.device), se.device)
                for v, se in zip(vals, senvs)]
            valids = None
            if any(sk.valid is not None for sk in parts):
                valids = [torch.ones(se.n_rows, dtype=torch.bool,
                                     device=se.device)
                          if sk.valid is None else
                          sk.valid.expand(se.n_rows)
                          for sk, se in zip(parts, senvs)]
            sks.append(SortKey([sk.values for sk in parts], o.ascending,
                               valids, nl))
    except (EvalError, ExecError):
        return None
    with span("distributed_topn", rows=n, k=int(k)):
        gids = sharded_topn(table.mesh, sks, int(k))
    M.increment("DistributedTopNQueries")
    return gids


def _compact_distributed(table: Table) -> Table:
    """A distributed table's real rows gathered as a plain table (joins on
    the host's row pairs never see the padding)."""
    return gather_table(table) if is_distributed(table) else table


# the hidden column that carries a distributed statement's WHERE mask
# through a gather
WHERE_COL = "__where__"


def _with_split_column(table: Table, name: str, parts: list) -> Table:
    """A distributed table with one more (bool) column of shard parts."""
    t = Table(list(table.columns.values()) +
              [Column(Field(name, DataType.BOOL), RowSplit(parts))],
              name=table.name)
    return _set_mesh(t, table.mesh, table.mesh_axis, table.real_rows)


def _split_where(t: Table) -> tuple:
    """(``t`` without the WHERE column, the WHERE column's data); a table
    left with no column keeps its row count in an all-true row mask."""
    where = t[WHERE_COL].data
    cols = [c for c in t.columns.values() if c.name != WHERE_COL]
    if not cols:
        cols = [Column(Field(ROW_VALID, DataType.BOOL),
                       torch.ones_like(where))]
    return Table(cols, name=t.name), where


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

def _join_right_table(session, jc) -> Table:
    if jc.subquery is not None:
        return execute_any(session, jc.subquery)
    try:
        return session.read_table_checked(jc.table)
    except KeyError:
        raise ExecError(f"unknown join table {jc.table!r}")


def apply_join(session, left: Table, jc, alias_prefixes: dict,
               settings=None, right: Optional[Table] = None,
               right_terms=(), keep=None) -> Table:
    """``left`` joined with the clause's table (``right`` where the caller
    read it already).  ``right_terms``: WHERE conjuncts pushed below the
    join (``_plan_joins``), which filter the right table before its
    build; ``keep``: the names the rest of the statement reads (None:
    every column), the only columns of either side the join carries."""
    if right is None:
        right = _join_right_table(session, jc)
    ralias = jc.alias or jc.table or "_subquery"
    dev = session.device
    st = settings if settings is not None else session.settings
    cross = jc.how == "CROSS" and not jc.using and jc.condition is None
    pairs, asof_term = ([], None) if cross else \
        _join_on(jc, left, right, ralias)
    if is_distributed(left):
        out = _distributed_join(session, left, right, jc, ralias,
                                alias_prefixes, st, pairs)
        if out is not None:
            return out
    left = _compact_distributed(left)
    right = _compact_distributed(right)
    if cross:
        # cartesian product (reference: JoinAlgorithm CROSS)
        right = _filter_side(session, right, right_terms, keep)
        nl, nr = left.n_rows, right.n_rows
        left_rows = np.repeat(np.arange(nl), nr)
        right_rows = np.tile(np.arange(nr), nl)
        right_has = np.ones(nl * nr, dtype=bool)
        return _gather_join_output(left, right, *_host_pairs(
            left_rows, right_rows, right_has, dev), jc, ralias,
            alias_prefixes, "ALL", dev, keep=keep)
    if jc.strictness == "ASOF":
        if asof_term is None:
            raise ExecError("ASOF JOIN requires an inequality in ON")
        return _apply_asof_join(left, right, jc, ralias, alias_prefixes,
                                pairs, asof_term, dev, keep)

    M.increment(M.JOIN_PROBE_ROWS, left.n_rows)
    how, strict = jc.how, jc.strictness
    all_rows = strict not in ("ANY", "SEMI", "ANTI")
    use_grace = st.join_algorithm == "grace_hash" or (
        st.join_algorithm == "auto" and
        right.n_rows > st.max_rows_in_hash_join_build)
    with span("join", how=how, strictness=strict, grace=use_grace,
              probe_rows=left.n_rows, build_rows=right.n_rows):
        with span("join_build"):
            right = _filter_side(session, right, right_terms, None if
                                 keep is None else keep | _clause_reads(jc))
            (lkeys,), rkeys = _join_keys(pairs, [Env(left, device=dev)],
                                         Env(right, device=dev))
            b = None if use_grace else \
                build_join(rkeys, probe_rows=left.n_rows)
        with span("join_probe"):
            if use_grace:
                res = (grace_hash_join_all if all_rows else
                       grace_hash_join_any)(
                    tuple(rkeys), tuple(lkeys),
                    n_partitions=st.grace_hash_join_initial_buckets)
            else:
                res = probe(b, lkeys, all_rows)
            pairs_ = _join_pairs_on_card(left.n_rows, right.n_rows, res, how,
                                         strict, dev)
        with span("join_gather"):
            return _gather_join_output(left, right, *pairs_, jc, ralias,
                                       alias_prefixes, strict, dev,
                                       keep=keep)


def _join_on(jc, left: Table, right: Table, ralias: str):
    """The ON or USING clause of a join read once for every path: its
    (left Ident, right Ident) equality pairs and, for ASOF, its one
    inequality (left Ident, op, right Ident) or None."""
    if jc.using:
        return [(Ident(c), Ident(c)) for c in jc.using], None
    if jc.condition is None:
        raise ExecError("JOIN requires ON or USING")
    pairs = []
    asof_term = None

    def side(e):
        if isinstance(e, Ident):
            if e.table == ralias or (e.table is None and e.name in right
                                     and e.name not in left):
                return "right"
            return "left"
        raise ExecError("JOIN ON terms must be column = column")
    for term in _split_conjuncts(jc.condition):
        is_eq = isinstance(term, BinOp) and term.op == "="
        is_ineq = isinstance(term, BinOp) and \
            term.op in (">=", ">", "<=", "<")
        if not is_eq and not (is_ineq and jc.strictness == "ASOF"):
            raise ExecError("JOIN ON supports conjunctions of equalities")
        l, r, op = term.left, term.right, term.op
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
    return pairs, asof_term


def _join_keys(pairs, lenvs, renv):
    """The aligned key tensors of the equality pairs (``_join_key_arrays``):
    per left ``Env`` its list of keys, and the right side's keys, its
    columns evaluated once."""
    lkeys, rkeys = [[] for _ in lenvs], []
    for le, re_ in pairs:
        rv = eval_expr(Ident(re_.name), renv)
        for keys, env in zip(lkeys, lenvs):
            lk, rk = _join_key_arrays(eval_expr(Ident(le.name), env), rv)
            keys.append(lk)
        rkeys.append(rk)
    return lkeys, rkeys


def _nonzero(mask: torch.Tensor, site: str) -> torch.Tensor:
    """The rows a mask keeps, charged to the query's budget (8 B each)."""
    with sync(site):
        rows = torch.nonzero(mask).flatten()
    charge(8 * rows.shape[0], site)
    return rows


def _join_pairs_on_card(n_left: int, n_right: int, res, how: str,
                        strict: str, dev):
    """The joined row pairs as device tensors: (left_rows or None for every
    left row in order, right_rows, right_has or None for all, left_has or
    None for all), from a probe's ``JoinResult`` (one match a left row)
    or ``JoinExpansion`` (every match).  Pairs come in the order the JAX
    package gives them: matches by left row, then a LEFT or FULL join's
    unmatched left rows, then a RIGHT or FULL join's unmatched right
    rows.  Host reads: the output sizes."""
    if isinstance(res, JoinResult):
        if strict == "ANTI":
            rows = _nonzero(~res.found, "executor.join.anti_rows")
            zeros = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
            return rows, zeros, zeros.bool(), None
        if strict != "ALL" and not (strict == "SEMI" or how == "INNER"):
            # LEFT ANY (and RIGHT/FULL ANY, as in the JAX package)
            return (None, torch.where(res.found, res.build_row, 0),
                    res.found, None)
        probe_idx = _nonzero(res.found, "executor.join.matched_rows")
        found = res.found
        if probe_idx.shape[0] == n_left and (
                strict != "ALL" or how == "INNER"):
            return None, res.build_row, None, None    # every left row
        build_idx = res.build_row.index_select(0, probe_idx)
        if strict != "ALL" or how == "INNER":
            return probe_idx, build_idx, None, None
        build_idx = build_idx.long()
    else:
        probe_idx, build_idx, found = res.probe_idx, res.build_idx, res.found
    # ALL multiplicity
    parts_l, parts_r = [probe_idx], [build_idx]
    n_pairs = probe_idx.shape[0]
    right_has = left_has = None
    n_extra_l = n_extra_r = 0
    if how in ("LEFT", "FULL"):
        extra = _nonzero(~found, "executor.join.left_misses")
        n_extra_l = extra.shape[0]
        parts_l.append(extra)
        parts_r.append(torch.zeros_like(extra))
    if how in ("RIGHT", "FULL"):
        matched_right = torch.zeros(n_right, dtype=torch.bool, device=dev)
        matched_right[build_idx] = True
        extra_r = _nonzero(~matched_right, "executor.join.right_misses")
        n_extra_r = extra_r.shape[0]
        parts_l.append(torch.full_like(extra_r, -1))
        parts_r.append(extra_r)
    left_rows, right_rows = torch.cat(parts_l), torch.cat(parts_r)
    if n_extra_l:
        right_has = torch.ones(left_rows.shape[0], dtype=torch.bool,
                               device=dev)
        right_has[n_pairs:n_pairs + n_extra_l] = False
    if n_extra_r:
        left_has = left_rows >= 0
    return left_rows, right_rows, right_has, left_has


# WHERE conjuncts below the joins, and the columns a join carries

# calls whose value depends on more than their row's arguments, or that the
# statement evaluates apart from its WHERE: a conjunct holding one stays
_UNPUSHED_FNS = frozenset({
    "arrayjoin", "now", "now64", "today", "yesterday", "generateuuidv4",
    "rownumberinblock", "rownumberinallblocks", "blocknumber",
    "runningdifference", "runningdifferencestartingwithfirstvalue",
    "runningaccumulate", "neighbor", "ftsindex"}) | TEXT_FNS | DIST_FNS


def _statement_reads(q) -> Optional[set]:
    """Names the statement reads after its joins (``_referenced_columns``
    and its grouping sets and fills), or None where it may read any
    column: a ``*``, or a subquery that may correlate."""
    refs = _referenced_columns(q)
    if refs is None:
        return None
    exprs = [e for gs in (q.grouping_sets or []) for e in gs]
    exprs += [v for o in q.order_by for v in (o.fill or {}).values()
              if isinstance(v, Expr)]
    exprs += [e for e, _a, _l in q.array_joins]
    clauses = [it.expr for it in q.items] + exprs + [
        e for e in (q.where, q.prewhere, q.having) if e is not None]
    if any(isinstance(n, (ScalarSubquery, ExistsSubquery, InSubquery))
           for e in clauses for n in walk(e)):
        return None
    return refs | _names_read(exprs)


def _clause_reads(jc) -> set:
    names = set(jc.using or [])
    if jc.condition is not None:
        names |= _names_read([jc.condition])
    return names


def _pushable(term, aliases) -> bool:
    for n in walk(term):
        if isinstance(n, (ScalarSubquery, ExistsSubquery, InSubquery,
                          WindowCall, Lambda)):
            return False
        if isinstance(n, FuncCall):
            name = n.name.lower()
            if name in _UNPUSHED_FNS or name in AGG_NAMES \
                    or name.startswith("rand"):
                return False
        if isinstance(n, Ident) and n.name in aliases:
            return False
    return True


def _term_source(term, sources) -> Optional[int]:
    """The one source (0 the FROM table, i the i-th join's table) whose
    columns every identifier of ``term`` names, or None."""
    found = set()
    for n in walk(term):
        if not isinstance(n, Ident):
            continue
        hits = [i for i, (names, cols) in enumerate(sources)
                if n.name in cols and (n.table is None or n.table in names)]
        if len(hits) != 1:
            return None
        found.add(hits[0])
    return found.pop() if len(found) == 1 else None


def _keeps_left(jc) -> bool:
    """The join keeps or drops each left row by a test of that row alone,
    so a filter of the left rows commutes with it."""
    return jc.how in ("INNER", "LEFT", "CROSS")


def _right_filter_commutes(jc) -> bool:
    """A filter of the right rows commutes with the join: every matching
    right row is joined (ALL) and unmatched right rows stay only under
    RIGHT, where they are right rows too."""
    return jc.how == "CROSS" or (jc.how in ("INNER", "RIGHT")
                                 and jc.strictness == "ALL")


def _filter_side(session, table: Table, terms, keep=None) -> Table:
    """``table``'s rows that every conjunct of ``terms`` keeps, of the
    columns ``keep`` names (None: all; with none named, the first)."""
    rows = None
    if terms:
        env = _session_env(session, table)
        mask = as_bool_mask(eval_expr(_conjoin(list(terms)), env),
                            table.n_rows)
        rows = _nonzero(mask, "executor.join.pushed_rows")
    if keep is not None:
        table = Table([c for c in table.columns.values()
                       if _carried(c.name, keep)]
                      or list(table.columns.values())[:1], name=table.name)
    if rows is not None and rows.shape[0] < table.n_rows:
        table = table.take(rows)
    return table


def _plan_joins(session, q, base: Table):
    """Before the joins: what each join carries, and the WHERE and
    PREWHERE conjuncts that read one side's columns alone moved below the
    joins, where the join kinds keep their meaning:

      * a conjunct of the FROM table's columns filters it before the first
        join, when every join keeps or drops each left row by that row
        alone (INNER, LEFT, CROSS: never RIGHT or FULL);
      * a conjunct of the i-th join's table filters that table before its
        build, when the join is INNER ALL, RIGHT ALL or CROSS and every
        later join keeps the left rows as above.

    A conjunct with a search, an aggregate, a window, a lambda, a
    subquery, a non-deterministic call or a SELECT alias stays, as does
    every conjunct of a statement with an ARRAY JOIN, a vector or text
    search, or a distributed table.  The statement's rows and their order
    are what the WHERE after the joins gives.

    Returns (the statement without the moved conjuncts, the FROM table
    filtered and cut to what the joins carry, and per join (its table or
    None, the conjuncts moved into it, the names it carries or None))."""
    from dataclasses import replace as dc_replace
    plan = [[None, [], None] for _jc in q.joins]

    def carried(q):
        """Each join's carried names after the conjuncts moved, and the
        FROM table's."""
        refs = _statement_reads(q)
        later = set()
        for p, jc in reversed(list(zip(plan, q.joins))):
            p[2] = None if refs is None else refs | later
            later |= _clause_reads(jc)
        return None if refs is None else refs | later
    base_keep = carried(q)
    where, prewhere = _split_conjuncts(q.where), _split_conjuncts(q.prewhere)
    searches = any(isinstance(n, FuncCall) and (
        n.name.lower() in DIST_FNS or n.name.lower() in TEXT_FNS)
        for e in [it.expr for it in q.items] + [o.expr for o in q.order_by]
        + where + prewhere for n in walk(e))
    if is_distributed(base) or q.array_joins or searches \
            or not (where or prewhere):
        return q, _filter_side(session, base, [], base_keep) \
            if not is_distributed(base) else base, plan
    for p, jc in zip(plan, q.joins):
        p[0] = _join_right_table(session, jc)
        if is_distributed(p[0]):
            return q, _filter_side(session, base, [], base_keep), plan
    aliases = {it.alias for it in q.items if it.alias}
    aliases |= {n for n, _e in q.with_aliases}
    sources = [({q.table_alias, q.table} - {None}, set(base.column_names))]
    sources += [({jc.alias, jc.table} - {None}, set(p[0].column_names))
                for p, jc in zip(plan, q.joins)]
    base_terms = []

    def place(term) -> bool:
        if not _pushable(term, aliases):
            return False
        src = _term_source(term, sources)
        if src is None:
            return False
        if not all(_keeps_left(jc) for jc in q.joins[src:]):
            return False
        if src == 0:
            base_terms.append(term)
            return True
        if not _right_filter_commutes(q.joins[src - 1]):
            return False
        plan[src - 1][1].append(map_expr(
            term, lambda n: Ident(n.name) if isinstance(n, Ident) else n))
        return True
    where = [t for t in where if not place(t)]
    prewhere = [t for t in prewhere if not place(t)]
    base_terms = [map_expr(t, lambda n: Ident(n.name)
                           if isinstance(n, Ident) else n)
                  for t in base_terms]
    q = dc_replace(q, where=_conjoin(where), prewhere=_conjoin(prewhere))
    return q, _filter_side(session, base, base_terms, carried(q)), plan


def _distributed_join(session, left: Table, right: Table, jc, ralias: str,
                      alias_prefixes: dict, st, pairs) -> Optional[Table]:
    """A join whose left side is distributed, with no gather of that side
    (StorageDistributed's GLOBAL join; the strategy is
    ``plan.choose_join_strategy``'s, which EXPLAIN prints):

      * a build side under the broadcast threshold: the build table is
        replicated and every shard probes its own rows; the output stays
        distributed, its row mask narrowed to the kept rows;
      * both sides distributed and large: the shuffle join
        (``_distributed_shuffle_join``).

    ``pairs``: the clause's equality pairs (``_join_on``).  Returns None
    for what neither covers (ASOF, CROSS, RIGHT/FULL, an ALL join over
    duplicate build keys under broadcast, an empty or ragged build side):
    the caller joins the compacted tables on the host."""
    how, strict = jc.how, jc.strictness
    if strict == "ASOF" or how == "CROSS" or \
            (jc.condition is None and not jc.using):
        return None
    if how not in ("INNER", "LEFT") or strict not in ("ANY", "ALL", "SEMI",
                                                      "ANTI"):
        return None
    from myscaledb_tpu_torch.sql.plan import choose_join_strategy
    strategy = choose_join_strategy(left, right, st, how, strict)
    if strategy == "shuffle":
        return _distributed_shuffle_join(session, left, right, jc, ralias,
                                         alias_prefixes, pairs)
    if strategy != "broadcast":
        return None
    right = _compact_distributed(right)
    if right.n_rows == 0 or \
            any(c.offsets is not None for c in right.columns.values()):
        return None
    dev = session.device
    mesh = left.mesh
    try:
        lkeys, rkeys = _join_keys(
            pairs, [Env(lt, device=lt.device) for lt in shard_tables(left)],
            Env(right, device=dev))
    except (EvalError, ExecError):
        return None
    if strict == "ALL":
        # one match per probe row: only while the build keys are unique
        rk_all = torch.stack([k.to(torch.int64) for k in rkeys])
        if torch.unique(rk_all, dim=1).shape[1] != rk_all.shape[1]:
            return None
    # the build side replicated: one copy of its keys, its probe
    # structure and its columns on each card the shards use
    cards = {}
    for p in range(mesh.size):
        d = str(mesh.device(p))
        if d not in cards:
            cards[d] = build_join([k.to(d) for k in rkeys])
    M.increment(M.JOIN_PROBE_ROWS, getattr(left, "real_rows", left.n_rows))
    with span("broadcast_join", how=how, strictness=strict,
              probe_rows=left.n_rows, build_rows=right.n_rows):
        res = [probe_any(cards[str(mesh.device(p))], lkeys[p])
               for p in range(mesh.size)]
    founds = [r.found for r in res]
    rv_old = left[ROW_VALID].data.parts
    if strict == "ANTI":
        new_rv = [v & ~f for v, f in zip(rv_old, founds)]
    elif how == "LEFT" and strict != "SEMI":
        new_rv = list(rv_old)
    else:   # INNER, SEMI (the JAX package keeps a LEFT SEMI join's misses)
        new_rv = [v & f for v, f in zip(rv_old, founds)]
    cols = [c for c in left.columns.values() if c.name != ROW_VALID]
    lnames = {c.name for c in cols}
    using_names = set(jc.using or [])
    safe_rows = [torch.where(r.found, r.build_row, 0).long() for r in res]
    right_oks = [f & (strict != "ANTI") for f in founds]
    for c in right.columns.values():
        if c.name in using_names:
            continue
        out_name = c.name if c.name not in lnames else f"{ralias}.{c.name}"
        data = c.data if not c.is_host else to_tensor(c.data, dev)
        cv = None
        if c.valid is not None:
            cv = (c.valid if not c.is_host else to_tensor(c.valid, dev)) \
                .bool()
        on_card, datas, valids = {}, [], []
        for p, (sr, ok) in enumerate(zip(safe_rows, right_oks)):
            d = str(sr.device)
            if d not in on_card:
                on_card[d] = (data.to(sr.device),
                              None if cv is None else cv.to(sr.device))
            cd, cvd = on_card[d]
            datas.append(cd.index_select(0, sr))
            valids.append(ok if cvd is None else ok & cvd[sr])
        cols.append(Column(Field(out_name, c.dtype, True,
                                 c.field.vector_dim),
                           RowSplit(datas), RowSplit(valids), c.dictionary))
    cols.append(Column(Field(ROW_VALID, DataType.BOOL), RowSplit(new_rv)))
    out = Table(cols, name=left.name)
    _set_mesh(out, mesh, left.mesh_axis,
              int(sum(int(v.sum()) for v in new_rv)))
    out.join_strategy = "broadcast"
    alias_prefixes[ralias] = ""
    return out


def _distributed_shuffle_join(session, left: Table, right: Table, jc,
                              ralias: str, alias_prefixes: dict,
                              pairs) -> Optional[Table]:
    """Big-big distributed join: both sides hash-repartitioned so equal
    keys colocate, joined per shard, and only the matched global row pairs
    gathered (the reference's shuffle join).  One integer key pair only;
    else None."""
    from myscaledb_tpu_torch.parallel.shuffle import \
        sharded_shuffle_join_pairs
    how, strict = jc.how, jc.strictness
    if len(pairs) != 1:
        return None
    dev = session.device
    if right.mesh.size != left.mesh.size:
        return None
    lks, rks = [], []
    try:
        # the shards of a column share its dictionary (``shard_table``)
        for lt, rt in zip(shard_tables(left), shard_tables(right)):
            (lk,), rk = _join_keys(pairs, [Env(lt, device=lt.device)],
                                   Env(rt, device=rt.device))
            lks += lk
            rks += rk
    except (EvalError, ExecError):
        return None
    if lks[0].is_floating_point() or lks[0].dtype == torch.bool:
        return None
    lvalid = left[ROW_VALID].data
    rvalid = right[ROW_VALID].data
    M.increment(M.JOIN_PROBE_ROWS, getattr(left, "real_rows", left.n_rows))
    with span("shuffle_join", how=how, strictness=strict,
              probe_rows=left.n_rows, build_rows=right.n_rows):
        pl_, pr_ = sharded_shuffle_join_pairs(
            left.mesh, lks, rks,
            how="ANY" if strict in ("ANY", "SEMI", "ANTI") else "ALL",
            left_valid=lvalid, right_valid=rvalid)
    if strict == "ANTI" or (how == "LEFT" and strict != "SEMI"):
        lv_np = np.asarray(lvalid).astype(bool)
        matched = np.zeros(left.n_rows, dtype=bool)
        matched[pl_] = True
        if strict == "ANTI":
            left_rows = np.flatnonzero(lv_np & ~matched)
            right_rows = np.zeros(len(left_rows), dtype=np.int64)
            right_has = np.zeros(len(left_rows), dtype=bool)
        else:   # LEFT (ANY or ALL)
            extra = np.flatnonzero(lv_np & ~matched)
            left_rows = np.concatenate([pl_.astype(np.int64), extra])
            right_rows = np.concatenate(
                [pr_.astype(np.int64), np.zeros(len(extra), dtype=np.int64)])
            right_has = np.concatenate([np.ones(len(pl_), dtype=bool),
                                        np.zeros(len(extra), dtype=bool)])
    else:   # INNER / SEMI
        left_rows = pl_.astype(np.int64)
        right_rows = pr_.astype(np.int64)
        right_has = np.ones(len(left_rows), dtype=bool)
    # only the joined rows of each side are gathered from their shards
    lrows = take_rows(left, left_rows)
    rrows = take_rows(right, right_rows)
    pos = np.arange(len(left_rows), dtype=np.int64)
    out = _gather_join_output(lrows, rrows,
                              *_host_pairs(pos, pos, right_has, dev), jc,
                              ralias, alias_prefixes, strict, dev)
    out.join_strategy = "shuffle"
    return out


def _gather_side(c: Column, name: str, rows, has, device):
    """One output column of a join: c's rows gathered by the row ids (a
    device tensor; None keeps every row in order), NULL where ``has`` (a
    bool tensor, or None for all rows) is False."""
    if rows is None:
        data, valid, offsets = c.data, c.valid, c.offsets
    elif c.offsets is not None:
        rc = c.take_ragged(rows_to_host(rows, "executor.join.ragged_rows"))
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
            rows_np = rows_to_host(rows, "executor.join.host_rows")
            data = to_tensor(c.data[rows_np], device)
            valid = to_tensor(c.valid[rows_np], device) \
                if c.valid is not None else None
        else:
            data = c.data.index_select(0, rows)
            valid = c.valid.index_select(0, rows) \
                if c.valid is not None else None
    if has is not None:
        valid = has if valid is None else valid & has
    # as in the JAX package, the output keeps no FixedString width
    elem = c.field.elem if offsets is not None else None
    out = Column(Field(name, c.dtype, valid is not None, c.field.vector_dim,
                       elem), data, valid, c.dictionary, None, offsets)
    if rows is not None:
        M.increment(M.JOIN_CARRIED_BYTES, _column_bytes(out))
    return out


def _column_bytes(c: Column) -> int:
    """Storage bytes of a column: its data and its validity."""
    n = 0
    for t in (c.data, c.valid):
        if t is not None:
            n += int(t.nbytes)
    return n


def _host_pairs(left_rows, right_rows, right_has, device) -> tuple:
    """Host row pairs (left_rows < 0 => left side NULL, right_has False =>
    right side NULL) as ``_gather_join_output`` takes them."""
    left_rows = np.asarray(left_rows, dtype=np.int64)
    right_has = np.asarray(right_has, dtype=bool)
    left_has = left_rows >= 0
    return (torch.as_tensor(np.where(left_has, left_rows, 0), device=device),
            torch.as_tensor(np.asarray(right_rows, dtype=np.int64),
                            device=device),
            None if right_has.all() else torch.as_tensor(right_has,
                                                         device=device),
            None if left_has.all() else torch.as_tensor(left_has,
                                                        device=device))


def _carried(name: str, keep) -> bool:
    return keep is None or name in keep or name.rsplit(".", 1)[-1] in keep


def _gather_join_output(left: Table, right: Table, left_rows, right_rows,
                        right_has, left_has, jc, ralias: str,
                        alias_prefixes: dict, strict: str, device,
                        keep=None) -> Table:
    """Materialize the joined table from device row-index pairs: left_rows
    (None: every left row in order; a negative index is a NULL left side),
    right_rows, and the masks right_has and left_has (None: all True).
    Only the columns ``keep`` names are carried (None: all); a join that
    would carry none keeps its first left column for the row count."""
    safe_left = None if left_rows is None else left_rows.clamp(min=0)
    lcols = [c for c in left.columns.values() if _carried(c.name, keep)]
    lnames = set(left.column_names)
    using_names = set(jc.using or [])
    rcols = []
    for c in right.columns.values():
        if c.name in using_names:
            continue
        if c.name not in lnames:
            if _carried(c.name, keep):
                rcols.append((c.name, c))
        elif keep is None or f"{ralias}.{c.name}" in keep:
            # a name both sides have is the left's unless qualified
            rcols.append((f"{ralias}.{c.name}", c))
    if not lcols and not rcols:
        lcols = list(left.columns.values())[:1]
    cols = [_gather_side(c, c.name, safe_left, left_has, device)
            for c in lcols]
    cols += [_gather_side(c, out_name, right_rows, right_has, device)
             for out_name, c in rcols]
    alias_prefixes[ralias] = ""
    return Table(cols, name=left.name)


def _apply_asof_join(left: Table, right: Table, jc, ralias: str,
                     alias_prefixes: dict, pairs, asof_term,
                     device, keep=None) -> Table:
    """ASOF JOIN: per equality-key group, match each left row to the closest
    right row satisfying the inequality (reference: AsofRowRefs sorted
    lookup, src/Interpreters/joinDispatch.h + HashJoin ASOF maps).

    Host-side rank trick: factorize (eq-keys, asof-values) jointly, sort the
    right side by the composite key, one vectorized searchsorted resolves
    every left row."""
    lenv, renv = Env(left, device=device), Env(right, device=device)
    (lkeys,), rkeys = _join_keys(pairs, [lenv], renv)
    lkeys = [k.cpu().numpy() for k in lkeys]
    rkeys = [k.cpu().numpy() for k in rkeys]
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
    return _gather_join_output(left, right, *_host_pairs(
        left_rows, right_rows, right_has, device), jc, ralias,
        alias_prefixes, "ASOF", device, keep=keep)


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
            with sync("executor._group_ids.lo"):
                lo = int(torch.min(torch.where(sel, data, data[0])))
            with sync("executor._group_ids.hi"):
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
    if is_distributed(table) or table.n_rows == 0:
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


class _AggOperands:
    """What ``run_aggregate`` evaluates over one Env (the table's rows, or
    one shard's): per plain aggregate its fn, argument tensor (None for
    counts: nothing reads it), validity, zone-map range and logical numpy
    dtype; the special and -State/-Merge calls' argument Values; the
    String min/max/any states' info; the result types."""

    def __init__(self):
        self.fns, self.args, self.arg_valids = [], [], []
        self.arg_ranges, self.logical = [], []
        self.normal_order: list[str] = []
        self.special: dict[str, tuple] = {}   # render -> (kind, Values, params)
        self.string_aggs: dict[str, tuple] = {}
        self.out_types = {}


def _agg_operands(env: Env, agg_calls: dict, alias_exprs: dict,
                  table: Table) -> _AggOperands:
    """Evaluate the aggregates' arguments over ``env``'s rows; ``table``
    is the statement's table (its schema and zone maps)."""
    n = env.n_rows
    ops = _AggOperands()
    fns, args, arg_valids = ops.fns, ops.args, ops.arg_valids
    arg_ranges, logical = ops.arg_ranges, ops.logical
    normal_order, special = ops.normal_order, ops.special
    string_aggs, out_types = ops.string_aggs, ops.out_types
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
    return ops


def run_aggregate(env: Env, q: SelectQuery, mask, session,
                  alias_exprs: dict, shards=None) -> tuple[Table, dict]:
    """GROUP BY / aggregates over ``env``'s table under ``mask``.  For a
    distributed table ``shards`` is (one Env per shard over the shard's
    rows on its card, one WHERE mask per shard): the arguments are
    evaluated per shard and the plain aggregates' partial states made per
    shard (``sharded_group_aggregate`` / ``sharded_shuffle_group_states``);
    the group keys and the special aggregates' arguments are gathered to
    shard 0's card, where the groups are numbered.  Raises
    ``_NotShardable`` where the shards' values do not merge (a String
    state over per-shard dictionaries): the caller gathers the rows."""
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

    if shards is None:
        ops = _agg_operands(env, agg_calls, alias_exprs, table)
        per = None
    else:
        senvs, smasks = shards
        dev = senvs[0].table.device
        per = [_agg_operands(se, agg_calls, alias_exprs, table)
               for se in senvs]
        ops = per[0]
        for o in per[1:]:
            for r, info in o.string_aggs.items():
                if info[0] is not ops.string_aggs[r][0]:
                    raise _NotShardable(r)
        # the special aggregates read every row: their Values gathered
        for r, (kind, vals, sparams) in ops.special.items():
            ops.special[r] = (kind, [_cat_values([o.special[r][1][i]
                                                  for o in per], dev)
                                     for i in range(len(vals))], sparams)
    fns, args, arg_valids = ops.fns, ops.args, ops.arg_valids
    arg_ranges, logical = ops.arg_ranges, ops.logical
    normal_order, special = ops.normal_order, ops.special
    string_aggs, out_types = ops.string_aggs, ops.out_types

    # group keys
    key_exprs = [_expand_item_aliases(k, alias_exprs, table)
                 for k in q.group_by]
    if per is None:
        key_vals = [eval_expr(k, env) for k in key_exprs]
    else:
        key_vals = [_cat_values([eval_expr(k, se) for se in senvs], dev)
                    for k in key_exprs]
    for kv in key_vals:
        if kv.is_scalar:
            raise ExecError("GROUP BY constant not supported")

    m = _mask_or_true(mask, n, dev) if per is None else \
        torch.cat([sm.to(dev) for sm in smasks])
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
        for o in (per or [])[1:]:
            o.args.append(None)
            o.arg_valids.append(o.string_aggs[r][2])
    if per is not None:
        mesh = table.mesh
        n_loc = n // mesh.size
        gid_parts = [gid[p * n_loc:(p + 1) * n_loc].to(mesh.device(p))
                     for p in range(mesh.size)]
        d_args = tuple(_by_shard([o.args[j] for o in per])
                       for j in range(len(fns)))
        d_valids = tuple(_by_shard([o.arg_valids[j] for o in per])
                         for j in range(len(fns)))
        if key_vals and \
                G > session.settings.distributed_group_by_shuffle_threshold:
            # high cardinality: one all_to_all of the rows beats G-wide
            # partial states from every shard (the reference's two-level
            # shuffle merge)
            from myscaledb_tpu_torch.parallel.shuffle import \
                sharded_shuffle_group_states
            M.increment("DistributedShuffleGroupBy")
            states, gc = sharded_shuffle_group_states(
                mesh, gid_parts, list(smasks), d_args, tuple(fns), G,
                arg_valids=d_valids)
        else:
            # each shard's kept rows gathered first, the route chosen for
            # the statement's rows, as the undistributed path does
            states, gc = sharded_group_aggregate(
                mesh, gid_parts, list(smasks), d_args, tuple(fns), G,
                d_valids, tuple(arg_ranges), tuple(logical),
                route_rows=n, compact_min_rows=COMPACT_MIN_ROWS)
    else:
        # the route is chosen for all n rows: gathering the kept ones
        # sends no statement from the scatter to the one-hot matmul
        agg_gid, agg_m, agg_args, agg_valids = _kept_rows_only(
            mask, gid, m, G, args, arg_valids)
        states, gc = partial_aggregate_matmul(
            agg_gid, agg_m, tuple(agg_args), tuple(fns), G,
            tuple(agg_valids), tuple(arg_ranges), tuple(logical),
            route_rows=n)
        del agg_gid, agg_m, agg_args, agg_valids
    outs = finalize(states, gc, tuple(fns), tuple(logical))
    with sync("executor.run_aggregate.counts"):
        gc_np = gc.cpu().numpy()
    present = np.flatnonzero(gc_np > 0)
    if not key_vals and len(present) == 0:
        present = np.array([0])   # global agg over empty set still yields a row

    # representative row per group (its lowest row id) -> group key output
    # values; a global aggregate has no key to fetch
    if key_vals:
        first = _first_rows(gid, m, G, dev)
        with sync("executor.run_aggregate.first_rows"):
            rep_np = first.cpu().numpy()[present]
        rep_np = np.where(rep_np == INT32_MAX, 0, rep_np)
        with sync("executor.run_aggregate.keys"):
            rep_dev = torch.as_tensor(rep_np, dtype=torch.int64,
                                      device=dev)
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


class _NotShardable(Exception):
    """A statement part whose per-shard values do not merge: its rows are
    gathered and it runs undistributed."""


def _by_shard(parts: list):
    """One aggregate's per-shard tensors as a row-split argument: None
    where no shard has one, a shard's missing validity as all-true."""
    if all(t is None for t in parts):
        return None
    if any(t is None for t in parts):
        ref = next(t for t in parts if t is not None)
        parts = [torch.ones(ref.shape[0], dtype=torch.bool,
                            device=ref.device) if t is None else t
                 for t in parts]
    return list(parts)


def _cat_values(vals: list, dev) -> Value:
    """The Values of one expression over every shard, concatenated in
    shard order on ``dev``: the expression's value over the whole padded
    table.  Strings of per-shard dictionaries are re-encoded into one."""
    v0 = vals[0]
    if v0.is_scalar:
        return Value(None if v0.data is None else v0.data.to(dev),
                     None if v0.valid is None else v0.valid.to(dev),
                     v0.dictionary, True, v0.py, v0.offsets, v0.dt,
                     v0.umax, v0.u64)
    dictionary = v0.dictionary
    datas = [v.data.to(dev) for v in vals]
    if dictionary is not None and any(v.dictionary is not dictionary
                                      for v in vals):
        dictionary = StringDictionary()
        for i, v in enumerate(vals):
            remap = dictionary.merge_from(v.dictionary)
            lut = to_tensor(np.append(remap, NULL_ID).astype(np.int32), dev)
            datas[i] = torch.where(datas[i] == NULL_ID, NULL_ID,
                                   lut[datas[i].long()])
    valid = None
    if any(v.valid is not None for v in vals):
        valid = torch.cat([
            torch.ones(_rows_of(v), dtype=torch.bool, device=dev)
            if v.valid is None else v.valid.to(dev).expand(_rows_of(v))
            for v in vals])
    offsets = None
    if v0.offsets is not None:
        offs, base = [np.zeros(1, dtype=np.int64)], 0
        for v in vals:
            o = np.asarray(v.offsets, dtype=np.int64)
            offs.append(o[1:] + base)
            base += int(o[-1])
        offsets = np.concatenate(offs)
    umax = None if any(v.umax is None for v in vals) else \
        max(v.umax for v in vals)
    return Value(torch.cat(datas), valid, dictionary, False, None, offsets,
                 v0.dt, umax, any(v.u64 for v in vals))


def _rows_of(v: Value) -> int:
    return len(v.offsets) - 1 if v.offsets is not None else \
        int(v.data.shape[0])




def _kept_rows_only(mask, gid, m, G: int, args: list, valids: list):
    """``ops.aggregate.kept_rows_only`` from COMPACT_MIN_ROWS rows."""
    return kept_rows_only(mask, gid, m, G, args, valids, COMPACT_MIN_ROWS)


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

def _session_env(session, table: Table, aliases=None, device=None) -> Env:
    """An Env of the statement's session: on its device (a shard's
    ``device`` for a shard's rows), with the runner ``IN (subquery)``
    evaluates through (the JAX package sets it only on the first Env of a
    statement: ROADMAP section 3)."""
    env = Env(table, aliases,
              device=session.device if device is None else device)
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
    table = _compact_distributed(table)
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


def check_external_source(session, kind: str, path: str | None = None) -> str:
    """Gate + confine external-source access (file()/url()/s3() table
    functions, File/URL/S3/FileLog engines, INFILE, INTO OUTFILE and FILE
    dictionary sources).  Reference:
    StorageFile::checkCreationIsAllowed (src/Storages/StorageFile.cpp)
    restricts paths to user_files_path, and ContextAccess checks the
    FILE/URL source privileges (src/Access/Common/AccessType.h).  Returns
    the resolved path.

    * privilege: the current user needs FILE (or URL) — the implicit
      'default' user holds ALL, so embedded/library sessions are unaffected;
      servers can create restricted users that cannot touch the filesystem.
    * confinement: when ``settings.user_files_path`` is set (servers set it
      at startup), relative paths resolve under it and absolute paths must
      stay inside it."""
    import os
    session.access.check(session.current_user,
                         "URL" if kind == "url" else "FILE", "*")
    if path is None or kind == "url":
        return path
    root = session.settings.user_files_path
    if not root:
        return path
    root = os.path.realpath(root)
    resolved = os.path.realpath(
        path if os.path.isabs(path) else os.path.join(root, path))
    if resolved != root and not resolved.startswith(root + os.sep):
        raise ExecError(
            f"path {path!r} is outside the user_files directory {root!r} "
            f"(reference: StorageFile::checkCreationIsAllowed)")
    return resolved


def _file_url_table(session, kind: str, src: str, fmt, schema) -> Table:
    """file('path', fmt, 'a Int64, ...') / url('http://...', fmt, schema)
    table functions (reference: src/TableFunctions/TableFunctionFile.cpp,
    TableFunctionURL.cpp — reads an external source as a one-shot table).
    Self-describing formats (Parquet/Arrow/ORC/Native) may omit the
    structure clause."""
    src = check_external_source(session, kind, src) or src
    from myscaledb_tpu_torch.runtime import formats
    from myscaledb_tpu_torch.sql.ddl import (fields_from_defs,
                                             parse_schema_string,
                                             read_fetched, _fetch)
    fields = fields_from_defs(parse_schema_string(schema)) if schema else []
    fmt = fmt or formats.format_from_extension(src, default="CSV")
    if not fields and not formats.is_self_describing(fmt):
        raise ExecError(f"{kind}() needs a structure argument for "
                        f"format {fmt!r} (e.g. 'a Int64, b String')")
    if kind == "url":
        return read_fetched(session, _fetch({"engine": "URL", "url": src}),
                            src, fmt, fields)
    return formats.read_file(src, fmt, fields, settings=session.settings,
                             device=session.device)


def _s3_table(session, src: str, fmt, schema, access_key: str,
              secret_key: str) -> Table:
    """s3('url'[, key, secret][, fmt[, structure]]) table function
    (reference: src/TableFunctions/TableFunctionS3.cpp over StorageS3) —
    signed GET via the SigV4 client (runtime/object_storage.py)."""
    check_external_source(session, "url")
    from myscaledb_tpu_torch.runtime import formats
    from myscaledb_tpu_torch.sql.ddl import (fields_from_defs,
                                             parse_schema_string,
                                             read_fetched, _fetch)
    fields = fields_from_defs(parse_schema_string(schema)) if schema else []
    fmt = fmt or formats.format_from_extension(src, default="CSV")
    if not fields and not formats.is_self_describing(fmt):
        raise ExecError("s3() needs a structure argument for format "
                        f"{fmt!r} (e.g. 'a Int64, b String')")
    payload = _fetch({"engine": "S3", "url": src, "key": access_key,
                      "secret": secret_key})
    return read_fetched(session, payload, src, fmt, fields)


def sample_mask(n: int, fraction: float, device) -> torch.Tensor:
    """SAMPLE f: the rows whose row-id hash (``hash32`` of the int64 row
    id) lies below f x (2^32 - 1), as the JAX package keeps them (the
    reference samples by ranges of the sampling-key hash,
    MergeTreeDataSelectExecutor); f > 1 asks for about f rows.  Hashed and
    compared on ``device``, in int64 lanes, so no value wraps."""
    from myscaledb_tpu_torch.ops.hash import hash32
    frac = fraction if fraction <= 1.0 else min(1.0, fraction / n)
    h = hash32(torch.arange(n, dtype=torch.int64, device=device))
    return h < int(frac * 0xFFFFFFFF)


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
        elif kind in ("file", "url"):
            base = _file_url_table(session, kind, *params)
        elif kind == "s3":
            base = _s3_table(session, *params)
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
    if q.sample is not None and base.n_rows:
        if is_distributed(base):
            raise ExecError("SAMPLE over distributed tables not supported")
        base, _ = compact_table_host(base, sample_mask(base.n_rows,
                                                       q.sample, dev))
    if q.limit is not None and base.n_rows and not is_distributed(base) \
            and _limit_prunable(q):
        # LIMIT pushdown into the scan: only limit+offset base rows are
        # evaluated when no clause looks past them
        keep = min(base.n_rows, q.limit + (q.offset or 0))
        if keep < base.n_rows:
            base = base.take(torch.arange(keep, device=dev))
    table = base
    alias_prefixes = {}
    if q.table_alias:
        alias_prefixes[q.table_alias] = ""
    if q.joins:
        q, table, plan = _plan_joins(session, q, table)
        for jc, (right, right_terms, keep) in zip(q.joins, plan):
            table = apply_join(session, table, jc, alias_prefixes, settings,
                               right, right_terms, keep)
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
    if pre_terms and ts is None and not is_distributed(table):
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
    # a distributed table: the WHERE mask is evaluated per shard, over the
    # shard's rows on its card, its padding rows folded in; a statement
    # that no shard-routed operator below takes reads the kept rows
    # gathered (``undistribute``)
    senvs = shard_masks = None
    if is_distributed(table):
        senvs = [_session_env(session, st, alias_prefixes, st.device)
                 for st in shard_tables(table)]
        shard_masks = []
        memo = {}          # the shards' host tables over one dictionary
        for se in senvs:
            m = se.table[ROW_VALID].data
            se.live, se.memo = m, memo
            if pre_expr is not None:
                m = as_bool_mask(eval_expr(pre_expr, se), se.n_rows) & m
            se.live = m
            shard_masks.append(m)
    elif pre_expr is not None:
        mask = as_bool_mask(eval_expr(pre_expr, env), table.n_rows)
    if block_sel is not None:
        mask = block_sel if mask is None else mask & block_sel
    env.live = mask           # the rows that aggregates and filters keep

    def undistribute(keep_mask: bool = False):
        """The distributed table's rows that the statement reads, gathered
        to shard 0's card as a plain table: the kept rows of the columns
        it names, or with ``keep_mask`` every real row and the WHERE mask
        beside them."""
        nonlocal table, env, mask, senvs, shard_masks
        refs = _referenced_columns(q)
        if keep_mask:
            table, mask = _split_where(gather_table(
                _with_split_column(table, WHERE_COL, shard_masks),
                names=None if refs is None else refs | {WHERE_COL}))
        else:
            table = gather_table(table, shard_masks, refs)
        env = _session_env(session, table, alias_prefixes)
        env.live = mask
        senvs = shard_masks = None

    if shard_masks is not None and vs is not None and vs.fused and \
            vs.binary:
        undistribute()

    # 4a. fused vector top-k
    if vs is not None and vs.fused:
        M.increment(M.VECTOR_SCAN_QUERIES)
        M.increment(M.VECTOR_SCAN_ROWS, table.n_rows * vs.qvec.shape[0])
        with span("vector_topk", metric=vs.metric, k=vs.k,
                  rows=table.n_rows):
            x = table[vs.col].data
            # rows whose stored vector is invalid never rank
            _vcv = table[vs.col].valid
            if _vcv is not None and shard_masks is not None:
                shard_masks = [m & v for m, v in zip(shard_masks,
                                                     _vcv.parts)]
            elif _vcv is not None:
                mask = _vcv if mask is None else mask & _vcv
            with sync("executor.execute_select.qvec"):
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
            elif is_distributed(table):
                # per-shard exact top-k on each shard's card and the
                # cross-shard merge, over the column's cached per-shard
                # squared norms
                sqn = None
                base_tab = session.tables.get(q.table) if q.table else None
                if base_tab is not None and vs.col in base_tab \
                        and base_tab[vs.col].data is x:
                    sqn = _derived(session, "sqnorm", q.table, table,
                                   vs.col,
                                   lambda c: RowSplit(sqnorm_parts(c.data)))
                d, ids = sharded_distance_topk(
                    table.mesh, x, qv, vs.metric, vs.k, mask=shard_masks,
                    block_rows=settings.vector_scan_block_rows,
                    x_sqnorm=sqn)
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
        mask = shard_masks = None
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
        d2, i2 = _text_search_topk(
            session, q, table, ts,
            mask if shard_masks is None else shard_masks, settings)
        with span("materialize", rows=int(i2.numel())):
            table, env = _materialize_topk(table, ts, d2, i2, tuple_groups,
                                           dev)
            env.subquery_runner = lambda sub: execute_any(session, sub)
        mask = shard_masks = None
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
        if shard_masks is not None:
            # the index covers the real rows in gathered order
            undistribute(keep_mask=True)
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
        if shard_masks is not None:
            undistribute()
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
    if has_aggs and shard_masks is not None and (
            q.grouping_sets is not None or q.with_totals or
            (q.group_modifier and q.group_by)):
        undistribute()
    if has_aggs:
        M.increment(M.AGG_ROWS, table.n_rows)
        with span("aggregate", rows=table.n_rows):
            try:
                agg_table, mapping = run_aggregate(
                    env, q, mask, session, alias_exprs,
                    None if shard_masks is None else (senvs, shard_masks))
            except _NotShardable:
                undistribute()
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
        cand = None
        if shard_masks is not None:
            cand = _distributed_topn_ids(q, table, senvs, shard_masks,
                                         alias_exprs)
        if cand is not None:
            # the candidate cut ran per shard; only limit + offset rows
            # are gathered.  Rows failing the mask may pad the cut when
            # fewer than k pass: dropped here with the WHERE column.
            refs = _referenced_columns(q)
            small, keep = _split_where(take_rows(
                _with_split_column(table, WHERE_COL, shard_masks), cand,
                None if refs is None else refs | {WHERE_COL}))
            table, _ = compact_table_host(small, keep)
            env = _session_env(session, table, alias_prefixes)
            mask = shard_masks = None
        elif shard_masks is not None:
            undistribute()
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
    with sync("executor._materialize_topk.distances"):
        d_np = d.cpu().numpy()
    with sync("executor._materialize_topk.ids"):
        ids_np = ids.cpu().numpy()
    nq = ids_np.shape[0]
    rows, qids, dists = [], [], []
    for qi in range(nq):
        valid = ids_np[qi] != INVALID_ID
        rows.append(ids_np[qi][valid])
        dists.append(d_np[qi][valid])
        qids.append(np.full(valid.sum(), qi, dtype=np.uint32))
    rows = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int64)
    # a distributed table's rows come from their shards (global ids)
    if is_distributed(table):
        gathered = take_rows(table, rows)
    else:
        with sync("executor._materialize_topk.take"):
            rows_dev = torch.as_tensor(rows, device=device)
        gathered = table.take(rows_dev)
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
    start = at_run_start(rows, first, torch.cumsum(first, 0) - 1)
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
    dispatch, without executing, with the JAX package's notes on a
    distributed table (its top-n, vector top-k and join strategies, its
    shard count)."""
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
    table = vs = None
    if q.table is not None:
        try:
            table = session.get_table(q.table)
        except (ExecError, KeyError):
            pass
    dist = table is not None and is_distributed(table)
    if q.order_by:
        keys = ", ".join(render(o.expr) + ("" if o.ascending else " DESC")
                         for o in q.order_by)
        if q.limit is not None:
            note = ", strategy=sharded per-shard top-n + merge" \
                if dist and not q.group_by and not q.distinct and \
                q.limit_by is None else ""
            add(f"TopN (k={q.limit + q.offset}, keys=[{keys}]{note})")
        else:
            add(f"Sorting (keys=[{keys}])")
    if q.having is not None:
        add(f"Having ({render(q.having)})")
    if table is not None:
        try:
            alias_exprs = {it.alias: it.expr for it in q.items if it.alias}
            vs = analyze_vector_search(q, session, table, alias_exprs)
        except ExecError:
            pass
    aggs = [render(node) for it in q.items for node in walk(it.expr)
            if isinstance(node, FuncCall) and node.name.lower() in AGG_NAMES]
    if q.group_by or aggs:
        add("Aggregating (keys=[" + ", ".join(render(k) for k in q.group_by)
            + "], aggregates=[" + ", ".join(aggs) + "])")
    if vs is not None and vs.fused:
        add(f"VectorTopK (metric={vs.metric}, k={vs.k}, "
            f"queries={vs.qvec.shape[0]}, two-stage exact scan"
            + (", distributed" if dist else "") + ")")
    elif vs is not None:
        add(f"DistanceMaterialize (metric={vs.metric})")
    if q.where is not None or q.prewhere is not None:
        conds = [render(c) for c in
                 _split_conjuncts(q.prewhere) + _split_conjuncts(q.where)]
        add("Filter (" + " AND ".join(conds) + ")")
    for jc in q.joins:
        strategy = "hash"
        if dist:
            try:
                rt = session.get_table(jc.table) if jc.table else None
            except KeyError:
                rt = None
            strategy = "gather+hash"
            if rt is not None and jc.strictness != "ASOF" and \
                    jc.how in ("INNER", "LEFT"):
                thr = session.settings.distributed_broadcast_join_threshold
                strategy = "broadcast" if rt.n_rows <= thr else (
                    "shuffle" if is_distributed(rt) else "gather+hash")
        add(f"HashJoin ({jc.how} {jc.strictness}, table={jc.table}, "
            f"strategy={strategy})")
    if inner is not None:
        add("ReadFromSubquery")
        steps.extend(inner)
    elif q.table is not None:
        desc = f"ReadFromTable {q.table}"
        if table is not None:
            desc += f" ({getattr(table, 'real_rows', table.n_rows)} rows)"
            if dist:
                desc += f" [distributed over {table.mesh.size} shards]"
        add(desc)
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
