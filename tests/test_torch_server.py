"""The port's HTTP server against the JAX package's, on the CPU: both
serve the same tables (one numpy seed) on ephemeral ports, and every reply
— TSV, JSON, JSONEachRow, JSONCompact, Pretty, CSV, CSVWithNames, Native,
RowBinary, Parquet, Arrow, ORC, by X-Format header and by FORMAT clause —
has the JAX server's status, content type and bytes; so do /ping, the
403 of a denied statement and the 500 of a failing one.  /metrics has the
same names for the same traffic.  ``server --data-dir`` raises on a table
directory that does not open (the JAX package's ``serve()`` prints the
traceback and serves on).
After tests/test_server.py."""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime.server import make_server as j_make_server
from myscaledb_tpu_torch.__main__ import main
from myscaledb_tpu_torch.runtime.client import http_query
from myscaledb_tpu_torch.runtime.server import make_server

FORMATS = ["TSV", "JSON", "JSONEachRow", "JSONCompact", "Pretty", "CSV",
           "CSVWithNames", "Native", "RowBinary", "Parquet", "Arrow", "ORC"]
STATEMENTS = [
    "SELECT id, v, name, price FROM t ORDER BY id LIMIT 7",
    "SELECT v, count(), sum(id), max(price) FROM t GROUP BY v ORDER BY v",
    "SELECT id, distance(emb, [0.1, 0.2, 0.3, 0.4]) AS d FROM t "
    "ORDER BY d LIMIT 5",
    "SELECT id, nullIf(v, 3) AS n, day FROM t ORDER BY id LIMIT 6",
    "SELECT name, 'tab\\there' AS s FROM t ORDER BY id LIMIT 2",
]


def table_data(n=100):
    rng = np.random.default_rng(0)
    return {"id": np.arange(n, dtype=np.int64),
            "v": rng.integers(0, 10, n).astype(np.int64),
            "name": np.array([f"n{i % 13}" for i in range(n)]),
            "price": rng.standard_normal(n),
            "day": (np.datetime64("2024-01-01") +
                    rng.integers(0, 60, n).astype("timedelta64[D]")),
            "emb": rng.standard_normal((n, 4)).astype(np.float32)}


def start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def servers():
    """(JAX address, port address), each session holding table t and a
    user ``bob`` with SELECT on t alone."""
    out, srvs = [], []
    for mod, make, kw in ((myscaledb_tpu, j_make_server, {}),
                          (myscaledb_tpu_torch, make_server,
                           {"device": "cpu"})):
        s = mod.connect(**kw)
        s.create_table("t", table_data())
        s.create_table("secret", {"x": np.arange(3, dtype=np.int64)})
        s.sql("CREATE USER bob IDENTIFIED BY 'pw'")
        s.sql("GRANT SELECT ON t TO bob")
        srv = start(make(s, "127.0.0.1", 0))
        srvs.append(srv)
        out.append(srv.server_address)
    yield out
    for srv in srvs:
        srv.shutdown()
        srv.server_close()


def fetch(addr, path="/", body=None, headers=None):
    """(status, content type, body bytes) of one request."""
    host, port = addr
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("stmt", range(len(STATEMENTS)))
def test_reply_bytes_equal_the_jax_server(servers, fmt, stmt):
    sql = STATEMENTS[stmt].encode()
    want = fetch(servers[0], body=sql, headers={"X-Format": fmt})
    got = fetch(servers[1], body=sql, headers={"X-Format": fmt})
    assert want[0] == 200
    assert got == want


@pytest.mark.parametrize("fmt", ["JSONEachRow", "CSVWithNames", "Native"])
def test_format_clause_and_get_query(servers, fmt):
    sql = f"SELECT id, name FROM t ORDER BY id LIMIT 3 FORMAT {fmt}"
    assert fetch(servers[1], body=sql.encode()) == \
        fetch(servers[0], body=sql.encode())
    path = "/?query=" + urllib.request.quote(sql)
    assert fetch(servers[1], path) == fetch(servers[0], path)


def test_ping_and_banner(servers):
    for path in ("/ping", "/"):
        assert fetch(servers[1], path) == fetch(servers[0], path)
    assert fetch(servers[1], "/ping")[2] == b"Ok.\n"


@pytest.mark.parametrize("sql,headers,code", [
    ("SELECT count() FROM secret", {"X-ClickHouse-User": "bob",
                                    "X-ClickHouse-Key": "pw"}, 403),
    ("SELECT 1", {"X-ClickHouse-User": "bob",
                  "X-ClickHouse-Key": "wrong"}, 403),
    ("SELECT 1 FROM missing_table", {}, 500),
    ("SELECT nonsense_column FROM t", {}, 500),
])
def test_errors_equal_the_jax_server(servers, sql, headers, code):
    want = fetch(servers[0], body=sql.encode(), headers=headers)
    got = fetch(servers[1], body=sql.encode(), headers=headers)
    assert want[0] == code
    assert got == want


def test_user_from_url_params(servers):
    path = "/?user=bob&password=pw&query=" + urllib.request.quote(
        "SELECT count() FROM t")
    assert fetch(servers[1], path) == fetch(servers[0], path) == \
        (200, "text/tab-separated-values; charset=UTF-8", b"100\n")


def test_metrics_names(servers):
    """The same traffic gives each package's /metrics the same names of
    events a statement counts, one Prometheus line each."""
    for addr in servers:
        fetch(addr, body=b"SELECT 1 FROM missing_table")
        fetch(addr, body=b"SELECT v, count() FROM t GROUP BY v")
    names = []
    for addr in servers:
        status, ctype, body = fetch(addr, "/metrics")
        assert status == 200 and ctype == "text/plain; charset=UTF-8"
        lines = body.decode().splitlines()
        assert all(ln.startswith("msdb_") and len(ln.split()) == 2
                   for ln in lines)
        names.append({ln.split()[0] for ln in lines})
    shared = {"msdb_events_Query", "msdb_events_SelectQuery",
              "msdb_events_HTTPFailedQuery", "msdb_events_ResultRows"}
    assert shared <= names[0] and shared <= names[1]


def test_client_http_query(servers):
    host, port = servers[1]
    assert http_query(host, port, "SELECT count(*) FROM t").strip() == "100"
    with pytest.raises(RuntimeError, match="unknown table"):
        http_query(host, port, "SELECT 1 FROM missing_table")


def test_serve_raises_on_a_table_that_does_not_open(tmp_path):
    """A part whose metadata does not parse stops ``server --data-dir``
    before it listens (it runs on a thread here so that a regression cannot
    hang the run)."""
    from myscaledb_tpu_torch.core.table import Table
    from myscaledb_tpu_torch.storage.table_store import TableStore
    t = Table.from_dict({"v": np.arange(10, dtype=np.int64)}, device="cpu")
    TableStore(str(tmp_path / "nums"), device="cpu").insert(t)
    (meta,) = tmp_path.glob("nums/*/meta.json")
    meta.write_text("{not json")
    raised = []

    def run():
        try:
            main(["server", "--device", "cpu", "--port", "0",
                  "--data-dir", str(tmp_path)])
        except Exception as e:                            # noqa: BLE001
            raised.append(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(10)
    assert not th.is_alive() and len(raised) == 1
