"""Query driver: the port of myscaledb_tpu/sql/driver.py (``execute_query``
for SELECT, EXPLAIN PLAN/PIPELINE/ESTIMATE/AST/SYNTAX and the statements
of sql/ddl.py, ``_ast_lines``), with its plumbing: a root trace span per
query, counters, the query log, the per-query memory scope, the result
cache, the result-size / time limits, the readonly and privilege checks of
DDL; ``SELECT ... INTO OUTFILE 'f' [FORMAT fmt]`` writes the result
through runtime/formats.py.

A data or definition change moves the mutation epoch after it runs (the
cached results and scan sidecars of the old epoch die with it).  These do
not: ALTER ... ADD VECTOR INDEX moves it itself before it builds, so its
build serves the next query; DETACH/ATTACH change no data, so an attached
table keeps its sidecar; SET, SYSTEM, a plain CREATE VIEW and the access
statements (users, roles, grants, row policies, quotas) only clear the
result cache; SHOW and DESCRIBE change nothing.
"""

from __future__ import annotations

import re
import time

import numpy as np

from myscaledb_tpu_torch.sql.parser import parse_sql
from myscaledb_tpu_torch.sql.executor import execute_any, explain_select
from myscaledb_tpu_torch.sql.ddl import (DDLParser, execute_statement,
                                         required_privilege, SetStatement,
                                         SystemStatement, AddVectorIndex,
                                         DetachTable, AttachTable,
                                         CreateView, READ_ONLY_STATEMENTS,
                                         ACCESS_STATEMENTS)
from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.memory import query_scope
from myscaledb_tpu_torch.runtime.tracing import span


DDL_KEYWORDS = ("CREATE", "INSERT", "DROP", "TRUNCATE", "DETACH", "ATTACH",
                "SET ", "SET\t",
                "SHOW", "DESCRIBE", "DESC ", "ALTER", "GRANT", "REVOKE",
                "SYSTEM", "DELETE", "OPTIMIZE")

_OUTFILE_RE = re.compile(
    r"\s+INTO\s+OUTFILE\s+'([^']+)'(?:\s+FORMAT\s+(\w+))?\s*$", re.IGNORECASE)


def _ast_lines(q, depth: int = 0) -> list:
    """Indented parse-tree dump (EXPLAIN AST)."""
    from myscaledb_tpu_torch.sql.ast import UnionQuery, SelectQuery
    from myscaledb_tpu_torch.sql.render import render
    pad = " " * depth
    out = []
    if isinstance(q, UnionQuery):
        out.append(pad + f"UnionQuery (branches {len(q.selects)})")
        for s in q.selects:
            out.extend(_ast_lines(s, depth + 1))
        return out
    assert isinstance(q, SelectQuery)
    out.append(pad + "SelectQuery")
    for it in q.items:
        out.append(pad + f" SelectItem {render(it.expr)}"
                   + (f" AS {it.alias}" if it.alias else ""))
    if q.table:
        out.append(pad + f" TableIdentifier {q.table}")
    if q.subquery is not None:
        out.append(pad + " Subquery")
        out.extend(_ast_lines(q.subquery, depth + 2))
    for clause, e in (("Prewhere", q.prewhere), ("Where", q.where),
                      ("Having", q.having)):
        if e is not None:
            out.append(pad + f" {clause} {render(e)}")
    for k in q.group_by:
        out.append(pad + f" GroupBy {render(k)}")
    for o in q.order_by:
        out.append(pad + f" OrderBy {render(o.expr)}"
                   + ("" if o.ascending else " DESC"))
    if q.limit is not None:
        out.append(pad + f" Limit {q.limit}")
    return out


# EXPLAIN PIPELINE's processor per stage: what the port runs there (the
# JAX package names its TPU programs: "HBM-resident", "MXU matmul",
# "PallasVPUGroupAccumulate", ...; ROADMAP section 3)
_PIPELINE_KERNELS = {
    "ReadFromTable": "DeviceColumnScan (card-resident, zone-map pruned)",
    "Filter": "TorchMaskEval (elementwise predicate, mask not compacted)",
    "VectorTopK": "SegminTopK (segmin_sq8.cu K1 int8 wgmma, segmin_f32.cu "
                  "K2 3xTF32, exact rescore)",
    "Aggregating": "GroupAggregate (group_agg.cu K3, G <= 256) / "
                   "OneHotMatmulHistogram / ScatterReduce",
    "Sorting": "StableRadixSort (torch.sort)",
    "TopN": "SegmentPrefilterTopK",
    "Join": "SortMergeJoin / merge_count.cu K4",
}


def _pipeline_annotate(line: str) -> str:
    for step, kernel in _PIPELINE_KERNELS.items():
        if line.lstrip().startswith(step):
            return line + "  [" + kernel + "]"
    return line


def _syntax_lines(q) -> list:
    """EXPLAIN SYNTAX: each SELECT's clauses rendered back, one a line."""
    from myscaledb_tpu_torch.sql.ast import UnionQuery
    from myscaledb_tpu_torch.sql.render import render
    lines = []
    for s in (q.selects if isinstance(q, UnionQuery) else [q]):
        lines.append("SELECT " + ", ".join(
            render(it.expr) + (f" AS {it.alias}" if it.alias else "")
            for it in s.items))
        if s.table:
            lines.append(f"FROM {s.table}")
        if s.where is not None:
            lines.append("WHERE " + render(s.where))
        if s.group_by:
            lines.append("GROUP BY " + ", ".join(render(k)
                                                 for k in s.group_by))
        if s.order_by:
            lines.append("ORDER BY " + ", ".join(
                render(o.expr) + ("" if o.ascending else " DESC")
                for o in s.order_by))
        if s.limit is not None:
            lines.append(f"LIMIT {s.limit}")
    return lines


def _estimate(session, q) -> Table:
    """EXPLAIN ESTIMATE: per table read, its rows, its zone-map blocks and
    the blocks the WHERE provably skips (reference: (database, table,
    parts, rows, marks))."""
    from myscaledb_tpu_torch.core.table import BLOCK_ROWS
    from myscaledb_tpu_torch.sql.ast import UnionQuery
    from myscaledb_tpu_torch.sql.executor import (_zonemap_block_mask,
                                                  _split_conjuncts)
    names, rows, blocks, pruned = [], [], [], []
    for s in (q.selects if isinstance(q, UnionQuery) else [q]):
        if s.table is None:
            continue
        t = session.get_table(s.table)
        names.append(s.table)
        nrows = getattr(t, "real_rows", t.n_rows)
        rows.append(nrows)
        blocks.append(-(-nrows // BLOCK_ROWS))
        conj = _split_conjuncts(s.prewhere) + _split_conjuncts(s.where)
        bm = _zonemap_block_mask(t, conj, session) if conj else None
        pruned.append(0 if bm is None else int((~bm).sum()))
    return Table.from_dict({
        "table": names, "rows": np.asarray(rows, dtype=np.int64),
        "blocks": np.asarray(blocks, dtype=np.int64),
        "blocks_pruned": np.asarray(pruned, dtype=np.int64)},
        device=session.device)


def _explain(session, rest: str) -> Table:
    """EXPLAIN [PLAN | PIPELINE | ESTIMATE | AST | SYNTAX] statement: PLAN
    renders sql/plan.py's DAG (the stage lines where it cannot be built),
    PIPELINE the stage lines with the processor each runs."""
    from myscaledb_tpu_torch.sql.ast import UnionQuery
    from myscaledb_tpu_torch.sql.plan import build_plan, render_plan
    kind = "PLAN"
    for kw in ("PLAN", "PIPELINE", "ESTIMATE", "AST", "SYNTAX"):
        if rest.upper().startswith(kw):
            kind = kw
            rest = rest[len(kw):].lstrip()
            break
    q = parse_sql(rest)
    if kind == "ESTIMATE":
        return _estimate(session, q)
    if kind == "AST":
        lines = _ast_lines(q)
    elif kind == "SYNTAX":
        lines = _syntax_lines(q)
    else:
        def plan_lines(s):
            if kind == "PLAN":
                try:
                    return render_plan(build_plan(session, s))
                except Exception:       # noqa: BLE001 (the JAX fallback)
                    pass
            return explain_select(session, s)
        if isinstance(q, UnionQuery):
            lines = []
            for i, s in enumerate(q.selects):
                lines.append(f"Union branch {i}")
                lines.extend("  " + ln for ln in plan_lines(s))
        else:
            lines = plan_lines(q)
        if kind == "PIPELINE":
            lines = [_pipeline_annotate(ln) for ln in lines]
    return Table.from_dict({"explain": lines}, device=session.device)


def _execute_ddl(session, sql: str, stmt) -> Table:
    if session.settings.readonly and not isinstance(
            stmt, (SetStatement,) + READ_ONLY_STATEMENTS):
        raise PermissionError("Cannot execute query in readonly mode")
    priv = required_privilege(stmt)
    if priv is not None:
        session.access.check(session.current_user, *priv)
    session.access.quota_check(session.current_user)
    t0 = time.perf_counter()
    entry = {"query": sql, "event_time": time.time(), "duration_ms": 0.0,
             "result_rows": 0, "status": "QueryStart", "error": ""}
    try:
        with span("ddl", query=sql[:200]):
            result = execute_statement(session, stmt)
        entry["status"] = "QueryFinish"
        if isinstance(stmt, READ_ONLY_STATEMENTS):
            pass
        elif isinstance(stmt, (SetStatement, SystemStatement, DetachTable,
                               AttachTable) + ACCESS_STATEMENTS) or (
                isinstance(stmt, CreateView) and not stmt.materialized):
            # no data moved: the sidecars stay, cached results go
            session._query_cache.clear()
        elif not isinstance(stmt, AddVectorIndex):
            session.bump_epoch()
        return result
    except Exception as e:
        entry["status"] = "ExceptionWhileProcessing"
        entry["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        entry["duration_ms"] = (time.perf_counter() - t0) * 1e3
        session.query_log.append(entry)
        session.access.quota_consume(
            session.current_user, execution_time=entry["duration_ms"] / 1e3,
            errors=int(entry["status"] != "QueryFinish"))


def execute_query(session, sql: str, params=None) -> Table:
    """Run one statement under its ``query`` span; the result Table carries
    the span's ids, the parent of its ``to_rows`` span."""
    with span("query", query=sql.lstrip()[:200]) as qs:
        result = _execute_query(session, sql, params)
    result.span_ids = (qs.trace_id, qs.span_id)
    return result


def _execute_query(session, sql: str, params=None) -> Table:
    stripped = sql.lstrip().rstrip().rstrip(";")
    m = _OUTFILE_RE.search(stripped)
    if m and stripped.upper().lstrip().startswith("SELECT"):
        # SELECT ... INTO OUTFILE 'f' [FORMAT fmt] (reference:
        # src/Client/ClientBase.cpp out-file handling; server-side here)
        # the path is confined and the FILE grant checked as for INFILE
        from myscaledb_tpu_torch.runtime import formats
        from myscaledb_tpu_torch.sql.executor import check_external_source
        path, fmt = m.group(1), m.group(2)
        fmt = fmt or formats.format_from_extension(path)
        path = check_external_source(session, "file", path)
        result = execute_query(session, stripped[:m.start()], params)
        formats.write_file(result, path, fmt, settings=session.settings)
        return result
    sql = stripped
    upper = stripped.upper()
    if any(upper.startswith(kw) for kw in DDL_KEYWORDS):
        stmt = DDLParser(stripped).parse_statement()
        if stmt is not None:
            return _execute_ddl(session, sql, stmt)
    if upper.startswith("EXPLAIN"):
        return _explain(session, stripped[len("EXPLAIN"):].lstrip())

    M.increment(M.QUERY)
    M.increment(M.SELECT_QUERY)
    session.access.quota_check(session.current_user)
    t0 = time.perf_counter()
    entry = {"query": sql, "event_time": time.time(), "duration_ms": 0.0,
             "result_rows": 0, "status": "QueryStart", "error": ""}
    settings = session.settings
    cache_key = None
    if settings.use_query_cache:
        cache_key = (sql, session._mutation_epoch)
        hit = session._query_cache.get(cache_key)
        if hit is not None:
            M.increment("QueryCacheHits")
            entry["status"] = "QueryFinish"
            entry["result_rows"] = hit.n_rows
            entry["duration_ms"] = (time.perf_counter() - t0) * 1e3
            session.query_log.append(entry)
            return hit
        M.increment("QueryCacheMisses")
    try:
        with query_scope(settings.max_memory_bytes_per_query):
            with span("parse"):
                q = parse_sql(sql)
            result = execute_any(session, q)
        entry["result_rows"] = result.n_rows
        entry["status"] = "QueryFinish"
        M.increment(M.RESULT_ROWS, result.n_rows)
        if settings.max_result_rows and result.n_rows > settings.max_result_rows:
            raise RuntimeError(
                f"result rows {result.n_rows} exceed max_result_rows "
                f"{settings.max_result_rows}")
        dt = time.perf_counter() - t0
        if settings.max_execution_time and dt > settings.max_execution_time:
            raise RuntimeError(
                f"query took {dt:.3f}s, over max_execution_time "
                f"{settings.max_execution_time}s")
        if cache_key is not None:
            if len(session._query_cache) >= settings.query_cache_max_entries:
                session._query_cache.pop(next(iter(session._query_cache)))
            session._query_cache[cache_key] = result
        return result
    except Exception as e:
        entry["status"] = "ExceptionWhileProcessing"
        entry["error"] = f"{type(e).__name__}: {e}"
        M.increment(M.FAILED_QUERY)
        raise
    finally:
        entry["duration_ms"] = (time.perf_counter() - t0) * 1e3
        session.query_log.append(entry)
        session.access.quota_consume(
            session.current_user, result_rows=entry["result_rows"],
            execution_time=entry["duration_ms"] / 1e3,
            errors=int(entry["status"] != "QueryFinish"))
