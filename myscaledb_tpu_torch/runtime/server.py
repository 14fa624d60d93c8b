"""HTTP query server: the port of myscaledb_tpu/runtime/server.py
(reference analog: src/Server/HTTPHandler.cpp on port 8123 —
`echo 'SELECT 1' | curl --data-binary @- http://host:8123/`).

Endpoints:
    POST /            SQL in the body (or GET /?query=...) -> TSV (default),
                      JSON, JSONEachRow, JSONCompact, Pretty, CSV,
                      CSVWithNames, and through ``formats.write_file``
                      Parquet, Arrow, ArrowStream, Native, RowBinary, ORC —
                      chosen by the X-Format header or a FORMAT clause
    GET  /ping        "Ok." health check (same as the reference)
    GET  /metrics     Prometheus text exposition of events/metrics
                      (reference: PrometheusRequestHandler)

Statements run through ``Session.sql_as`` under the session's one
execution lock, which every protocol server of the session shares; the
server itself is threaded so pings and metrics answer during a long
query.  ``open_tables`` registers every part directory under a data
directory as a table named after it, and raises when one fails to open.
"""

from __future__ import annotations

import csv
import io
import json
import os
import re
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime import tracing
from myscaledb_tpu_torch.runtime.access import (AccessDeniedError,
                                                QuotaExceededError)
from myscaledb_tpu_torch.session import Session
from myscaledb_tpu_torch.sql.format import format_tsv

_FORMAT_RE = re.compile(r"\s+FORMAT\s+(\w+)\s*$", re.IGNORECASE)
BINARY_FORMATS = ("PARQUET", "ARROW", "ARROWSTREAM", "NATIVE", "ROWBINARY",
                  "ORC")


def _py(v):
    return v.tolist() if hasattr(v, "tolist") else v


def result_to_json(table) -> str:
    cols = [{"name": c.name, "type": str(c.field)}
            for c in table.columns.values()]
    rows = [[_py(v) for v in r] for r in table.to_rows()]
    return json.dumps({"meta": cols, "data": rows, "rows": len(rows)},
                      default=str)


def result_to_json_each_row(table) -> str:
    names = table.column_names
    return "\n".join(json.dumps({n: _py(v) for n, v in zip(names, r)},
                                default=str) for r in table.to_rows())


def result_to_csv(table, with_names: bool) -> str:
    names = [n for n in table.column_names if not n.startswith("__")]
    buf = io.StringIO()
    w = csv.writer(buf)
    if with_names:
        w.writerow(names)
    pycols = [table[n].to_python() for n in names]
    for i in range(table.n_rows):
        w.writerow([c[i] for c in pycols])
    return buf.getvalue()


def result_bytes(table, fmt: str) -> bytes:
    """A binary format's bytes, as ``formats.write_file`` writes them."""
    from myscaledb_tpu_torch.runtime.formats import write_file
    with tempfile.NamedTemporaryFile(suffix=".out") as tf:
        write_file(table, tf.name, fmt)
        with open(tf.name, "rb") as fh:
            return fh.read()


def render(table, fmt: str) -> tuple[bytes, str]:
    """(body, content type) of a result in the upper-cased format ``fmt``:
    what the server sends."""
    if fmt == "JSON":
        return result_to_json(table).encode(), "application/json"
    if fmt == "JSONEACHROW":
        return result_to_json_each_row(table).encode(), "application/json"
    if fmt == "JSONCOMPACT":
        from myscaledb_tpu_torch.runtime.formats import format_json
        return format_json(table, compact=True).encode(), "application/json"
    if fmt in ("PRETTY", "PRETTYCOMPACT"):
        from myscaledb_tpu_torch.runtime.formats import format_pretty
        return (format_pretty(table) + "\n").encode(), "text/plain"
    if fmt in ("CSV", "CSVWITHNAMES"):
        return result_to_csv(table, fmt == "CSVWITHNAMES").encode(), \
            "text/csv"
    if fmt in BINARY_FORMATS:
        return result_bytes(table, fmt), "application/octet-stream"
    body = format_tsv(table)
    return (body + ("\n" if body else "")).encode(), \
        "text/tab-separated-values"


def metrics_text() -> str:
    lines = [f"msdb_events_{k} {v}"
             for k, v in sorted(M.events_snapshot().items())]
    lines += [f"msdb_metrics_{k} {v}"
              for k, v in sorted(M.metrics_snapshot().items())]
    lines += [f"msdb_seconds_{k} {v:.6f}"
              for k, v in sorted(tracing.timings_snapshot().items())]
    return "\n".join(lines) + "\n"


class QueryHandler(BaseHTTPRequestHandler):
    server_version = "myscaledb-tpu/0.1"
    session: Session = None

    def log_message(self, fmt, *args):   # quiet access log
        pass

    def _send_bytes(self, code: int, data: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send(self, code: int, body: str, ctype="text/tab-separated-values"):
        self._send_bytes(code, body.encode(), ctype + "; charset=UTF-8")

    def _auth(self, qs: dict) -> str:
        """Resolve + authenticate the request user (reference: HTTPHandler
        authenticateUser — X-ClickHouse-User/Key headers or user/password
        URL params; default user otherwise)."""
        user = self.headers.get("X-ClickHouse-User") or \
            qs.get("user", ["default"])[0]
        password = self.headers.get("X-ClickHouse-Key")
        if password is None:
            password = qs.get("password", [None])[0]
        return self.session.access.authenticate(user, password)

    def _run_query(self, sql: str, qs: dict):
        sql = sql.strip()
        if not sql:
            return self._send(400, "empty query\n", "text/plain")
        fmt = "TSV"
        m = _FORMAT_RE.search(sql)
        if m:
            fmt = m.group(1).upper()
            sql = sql[:m.start()]
        hdr_fmt = self.headers.get("X-Format")
        if hdr_fmt:
            fmt = hdr_fmt.upper()
        try:
            result = self.session.sql_as(self._auth(qs), sql)
        except (AccessDeniedError, QuotaExceededError) as e:
            M.increment("HTTPFailedQuery")
            return self._send(403, f"{type(e).__name__}: {e}\n", "text/plain")
        except Exception as e:                            # noqa: BLE001
            M.increment("HTTPFailedQuery")
            return self._send(500, f"{type(e).__name__}: {e}\n", "text/plain")
        body, ctype = render(result, fmt)
        if fmt not in BINARY_FORMATS:
            ctype += "; charset=UTF-8"
        return self._send_bytes(200, body, ctype)

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/ping":
            return self._send(200, "Ok.\n", "text/plain")
        if url.path == "/metrics":
            return self._send(200, metrics_text(), "text/plain")
        qs = parse_qs(url.query)
        if "query" in qs:
            return self._run_query(qs["query"][0], qs)
        return self._send(200, "myscaledb-tpu. POST SQL to / or use "
                               "/?query=...\n", "text/plain")

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length).decode()
        url = urlparse(self.path)
        qs = parse_qs(url.query)
        sql = qs.get("query", [body])[0] or body
        return self._run_query(sql, qs)


def make_server(session: Session, host: str = "127.0.0.1",
                port: int = 8123) -> ThreadingHTTPServer:
    try:
        # the Parquet/Arrow/ORC writers import pyarrow; loaded first on a
        # request thread, it has crashed the process (SIGSEGV)
        import pyarrow  # noqa: F401
    except ImportError:
        pass
    handler = type("BoundHandler", (QueryHandler,), {"session": session})
    return ThreadingHTTPServer((host, port), handler)


def open_tables(session: Session, data_dir: str) -> None:
    """Register every part directory under ``data_dir`` as a table named
    after it; a directory that fails to open raises."""
    from myscaledb_tpu_torch.storage.table_store import open_table
    for d in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, d)
        if os.path.isdir(path):
            session.register(d, open_table(path, device=session.device))

