"""Query driver: the port of myscaledb_tpu/sql/driver.py (``execute_query``
for SELECT, EXPLAIN AST and the DDL/DML subset of sql/ddl.py, ``_ast_lines``),
with its plumbing: a root trace span per query, counters, the query log,
the per-query memory scope, the result cache, the result-size / time
limits, the readonly and privilege checks of DDL.  The other EXPLAIN kinds,
INTO OUTFILE and the statements sql/ddl.py does not port raise
``NotPortedError``.

A data or definition change moves the mutation epoch after it runs (the
cached results and scan sidecars of the old epoch die with it).  Three
kinds do not: ALTER ... ADD VECTOR INDEX moves it itself before it builds,
so its build serves the next query; DETACH/ATTACH change no data, so an
attached table keeps its sidecar; SET and SYSTEM only clear the result
cache.
"""

from __future__ import annotations

import re
import time

from myscaledb_tpu_torch.sql.parser import parse_sql
from myscaledb_tpu_torch.sql.executor import execute_any
from myscaledb_tpu_torch.sql.ddl import (DDLParser, execute_statement,
                                         required_privilege, SetStatement,
                                         SystemStatement, AddVectorIndex,
                                         DetachTable, AttachTable)
from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.errors import NotPortedError
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


def _execute_ddl(session, sql: str, stmt) -> Table:
    if session.settings.readonly and not isinstance(stmt, SetStatement):
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
        if isinstance(stmt, (SetStatement, SystemStatement, DetachTable,
                             AttachTable)):
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
    stripped = sql.lstrip().rstrip().rstrip(";")
    if _OUTFILE_RE.search(stripped):
        raise NotPortedError("SELECT ... INTO OUTFILE",
                             "storage, formats and runtime state")
    sql = stripped
    upper = stripped.upper()
    if any(upper.startswith(kw) for kw in DDL_KEYWORDS):
        stmt = DDLParser(stripped).parse_statement()
        if stmt is not None:
            return _execute_ddl(session, sql, stmt)
    if upper.startswith("EXPLAIN"):
        rest = stripped[len("EXPLAIN"):].lstrip()
        kind = "PLAN"
        for kw in ("PLAN", "PIPELINE", "ESTIMATE", "AST", "SYNTAX"):
            if rest.upper().startswith(kw):
                kind = kw
                rest = rest[len(kw):].lstrip()
                break
        if kind != "AST":
            raise NotPortedError(f"EXPLAIN {kind}",
                                 "expression and function breadth")
        return Table.from_dict({"explain": _ast_lines(parse_sql(rest))},
                               device=session.device)

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
        with span("query", query=sql[:200]), \
                query_scope(settings.max_memory_bytes_per_query):
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
