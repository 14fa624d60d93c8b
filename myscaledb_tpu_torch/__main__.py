"""Unified binary dispatcher: ``python -m myscaledb_tpu_torch <tool> ...``.

Reference analog: programs/main.cpp — one entry point dispatching
``clickhouse server|client|local|benchmark|format``.  Tools:

  server     HTTP (+ optional native TCP, MySQL, PostgreSQL, gRPC) server
  client     remote client / REPL                       (programs/client)
  local      embedded session over local data           (programs/local)
  benchmark  QPS/latency load tool                      (programs/benchmark)
  format     pretty-print a SQL statement               (programs/format)

Every tool that opens a session takes the CUDA card unless it is given
``--device cpu``; with no CUDA device and no ``--device``, it exits with
``connect()``'s error.
"""

from __future__ import annotations

import argparse
import sys


def _usage() -> int:
    print(__doc__.strip(), file=sys.stderr)
    return 2


def _server(rest) -> int:
    ap = argparse.ArgumentParser(prog="myscaledb-tpu server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--tcp-port", type=int, default=0,
                    help="also serve the native TCP protocol")
    ap.add_argument("--mysql-port", type=int, default=0,
                    help="also serve the MySQL wire protocol")
    ap.add_argument("--pg-port", type=int, default=0,
                    help="also serve the PostgreSQL wire protocol")
    ap.add_argument("--grpc-port", type=int, default=0,
                    help="also serve the gRPC protocol")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--user-files", default="user_files",
                    help="directory file()/File-engine paths are "
                         "confined to (reference: user_files_path)")
    ap.add_argument("--device", default=None,
                    help="the session's device (default: the CUDA card; "
                         "'cpu' to run on the CPU)")
    a = ap.parse_args(rest)
    import os
    from myscaledb_tpu_torch.runtime.client import local_session
    from myscaledb_tpu_torch.runtime.server import make_server
    session = local_session(a.device, a.data_dir)
    session.settings.user_files_path = os.path.abspath(a.user_files)
    urls = []
    if a.tcp_port:
        from myscaledb_tpu_torch.runtime.tcp_server import serve_tcp
        serve_tcp(session, a.host, a.tcp_port)
        urls.append(f"tcp://{a.host}:{a.tcp_port}")
    if a.mysql_port:
        from myscaledb_tpu_torch.runtime.mysql_server import serve_mysql
        serve_mysql(session, a.host, a.mysql_port)
        urls.append(f"mysql://{a.host}:{a.mysql_port}")
    if a.pg_port:
        from myscaledb_tpu_torch.runtime.pg_server import serve_pg
        serve_pg(session, a.host, a.pg_port)
        urls.append(f"pg://{a.host}:{a.pg_port}")
    if a.grpc_port:
        from myscaledb_tpu_torch.runtime.grpc_server import serve_grpc
        serve_grpc(session, a.host, a.grpc_port)
        urls.append(f"grpc://{a.host}:{a.grpc_port}")
    httpd = make_server(session, a.host, a.port)
    print(" ".join([f"listening on http://{a.host}:{a.port}"] + urls),
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _format(rest) -> int:
    ap = argparse.ArgumentParser(prog="myscaledb-tpu format")
    ap.add_argument("--device", default=None)
    a, words = ap.parse_known_args(rest)
    from myscaledb_tpu_torch.session import connect
    sql = " ".join(words) or sys.stdin.read()
    out = connect(device=a.device).sql(
        "EXPLAIN SYNTAX " + sql.strip().rstrip(";"))
    for (line,) in out.to_rows():
        print(line)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        return _usage()
    tool, rest = argv[0], argv[1:]
    if tool == "client":
        from myscaledb_tpu_torch.runtime.client import main as m
    elif tool == "local":
        from myscaledb_tpu_torch.runtime.client import main as m
        rest = ["--local"] + rest
    elif tool == "benchmark":
        from myscaledb_tpu_torch.runtime.benchmark import main as m
    elif tool == "server":
        m = _server
    elif tool == "format":
        m = _format
    else:
        return _usage()
    from myscaledb_tpu_torch.errors import NoDeviceError
    try:
        return m(rest) or 0
    except NoDeviceError as e:
        print(f"myscaledb-tpu {tool}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
