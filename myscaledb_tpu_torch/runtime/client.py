"""Command-line client: the port of myscaledb_tpu/runtime/client.py
(reference analog: clickhouse-client, src/Client/ClientBase.cpp — batch
`-q` mode and an interactive REPL over the HTTP protocol; `--local` runs an
embedded session like clickhouse-local, on the CUDA card unless
`--device cpu` is given).
"""

from __future__ import annotations

import argparse
import sys
import urllib.error
import urllib.request


def http_query(host: str, port: int, sql: str, fmt: str | None = None,
               timeout: float = 600) -> str:
    req = urllib.request.Request(
        f"http://{host}:{port}/", data=sql.encode(),
        headers={"X-Format": fmt} if fmt else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode()
    except urllib.error.HTTPError as e:
        raise RuntimeError(e.read().decode().strip()) from None


def local_session(device=None, data_dir=None):
    """A session on ``device`` (the card by default: ``connect()`` raises
    without one) with the part directories under ``data_dir`` opened as
    tables."""
    from myscaledb_tpu_torch.runtime.server import open_tables
    from myscaledb_tpu_torch.session import connect
    session = connect(device=device)
    if data_dir:
        open_tables(session, data_dir)
    return session


def run_local(args):
    session = local_session(args.device, args.data_dir)
    return session.sql_tsv


def run_remote(args):
    def run(sql):
        return http_query(args.host, args.port, sql, args.format).rstrip("\n")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(prog="myscaledb-tpu client")
    ap.add_argument("-q", "--query", action="append",
                    help="query to run (repeatable); omit for REPL")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8123)
    ap.add_argument("--format", default=None, help="TSV | JSON | JSONEachRow")
    ap.add_argument("--local", action="store_true",
                    help="embedded session (clickhouse-local analog)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="--local: the session's device (default: the CUDA "
                         "card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    run = run_local(args) if args.local else run_remote(args)

    if args.query:
        for sql in args.query:
            out = run(sql)
            if out:
                print(out)
        return 0

    # REPL
    print("myscaledb-tpu client. Type SQL; 'exit' to quit.")
    while True:
        try:
            line = input(":) ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        if line.lower() in ("exit", "quit", "\\q"):
            return 0
        try:
            out = run(line.rstrip(";"))
            if out:
                print(out)
        except Exception as e:                            # noqa: BLE001
            print(f"Error: {e}", file=sys.stderr)
