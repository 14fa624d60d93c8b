"""The port's PostgreSQL wire server against the JAX package's, on the
CPU: both serve the same tables, and every reply — RowDescription /
DataRow / CommandComplete / ReadyForQuery, NULL and raw strings, errors —
is the JAX server's message for message.  The extended protocol
(Parse/Bind/Describe/Execute/Sync with $N parameters, a portal suspended
at a row limit, Describe of a statement, the error state that lasts until
Sync, placeholders inside string literals) answers alike, and so does the
cleartext password exchange.  After tests/test_pg_server.py."""

import socket
import struct

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime.pg_server import serve_pg as j_serve
from myscaledb_tpu_torch.runtime.pg_server import serve_pg
from tools.wire_clients import PGClient

SIMPLE = [
    "SELECT id, name, v FROM t ORDER BY id LIMIT 3",
    "SELECT nullIf(1, 1), 'tab\\there'",
    "SELECT * FROM nope",
    "SELECT count(), sum(id) FROM t",
    "",
    "CREATE TABLE made (a Int64) ENGINE = Memory",
]


@pytest.fixture(scope="module")
def servers():
    out = []
    for mod, serve, kw in ((myscaledb_tpu, j_serve, {}),
                           (myscaledb_tpu_torch, serve_pg,
                            {"device": "cpu"})):
        s = mod.connect(**kw)
        s.create_table("t", {"id": np.arange(10, dtype=np.int64),
                             "name": np.array([f"n{i}" for i in range(10)]),
                             "v": np.arange(10, dtype=np.float64) * 1.5})
        s.sql("CREATE USER alice IDENTIFIED BY 'secret'")
        s.sql("GRANT SELECT ON t TO alice")
        out.append(serve(s, "127.0.0.1", 0))
    yield [srv.server_address for srv in out]
    for srv in out:
        srv.shutdown()
        srv.server_close()


def _both(servers, fn, **kw):
    out = []
    for addr in servers:
        c = PGClient(*addr, **kw)
        try:
            out.append(fn(c))
        finally:
            c.close()
    return out


@pytest.mark.parametrize("stmt", range(len(SIMPLE)))
def test_simple_query_equals_the_jax_server(servers, stmt):
    got = _both(servers, lambda c: c.raw_query(SIMPLE[stmt]))
    assert got[1] == got[0]


def _extended_select(c):
    c.parse("s1", "SELECT id, name FROM t WHERE id >= $1 AND name != $2 "
                  "ORDER BY id LIMIT 3")
    c.bind("p1", "s1", params=[5, "n6"])
    c.describe("P", "p1")
    c.execute("p1")
    c.sync()
    return c.collect_until_ready()


def _row_limit(c):
    c.parse("", "SELECT id FROM t ORDER BY id")
    c.bind("", "")
    c.execute("", max_rows=4)
    c.execute("", max_rows=0)
    c.sync()
    return c.collect_until_ready()


def _describe_statement(c):
    c.parse("s2", "SELECT v FROM t WHERE id = $1")
    c.describe("S", "s2")
    c.sync()
    return c.collect_until_ready()


def _error_until_sync(c):
    c.parse("bad", "SELECT * FROM missing_table")
    c.bind("bp", "bad")
    c.execute("bp")
    c.execute("bp")                  # skipped after the error
    c.sync()
    return c.collect_until_ready() + c.raw_query("SELECT 41 + 1")


def _literal_placeholder(c):
    c.parse("s3", "SELECT '$1' AS lit, $1 AS param, $2 AS n")
    c.bind("p3", "s3", params=["it's", None])
    c.execute("p3")
    c.sync()
    return c.collect_until_ready()


EXTENDED = {"select": _extended_select, "row_limit": _row_limit,
            "describe_statement": _describe_statement,
            "error_until_sync": _error_until_sync,
            "literal_placeholder": _literal_placeholder}


@pytest.mark.parametrize("flow", sorted(EXTENDED))
def test_extended_protocol_equals_the_jax_server(servers, flow):
    got = _both(servers, EXTENDED[flow])
    want = got[0]
    if flow == "literal_placeholder":
        # a NULL parameter binds the NULL literal: NULL in the port's row
        # (length -1), 0 in the JAX server's (its NULL literal is a
        # non-nullable 0: ROADMAP section 3)
        null_zero = b"\x00\x00\x00\x010"
        assert any(t == b"D" and p.endswith(null_zero) for t, p in want)
        want = [(t, p[:-len(null_zero)] + b"\xff\xff\xff\xff")
                if t == b"D" and p.endswith(null_zero) else (t, p)
                for t, p in want]
    assert got[1] == want


def test_extended_protocol_rows(servers):
    c = PGClient(*servers[1])
    try:
        msgs = _extended_select(c)
        assert [t for t, _ in msgs[:2]] == [b"1", b"2"]
        assert c.parse_rows(msgs) == (["id", "name"],
                                      [["5", "n5"], ["7", "n7"], ["8", "n8"]])
        msgs = _row_limit(c)
        assert b"s" in [t for t, _ in msgs]
        assert [r[0] for r in c.parse_rows(msgs)[1]] == \
            [str(i) for i in range(10)]
        msgs = _error_until_sync(c)
        errs = [p for t, p in msgs if t == b"E"]
        assert len(errs) == 1 and b"missing_table" in errs[0]
        assert c.parse_rows(msgs)[1] == [["42"]]
        assert c.parse_rows(_literal_placeholder(c))[1][0][:2] == \
            ["$1", "it's"]
    finally:
        c.close()


def _startup_replies(addr, user, password, ssl_probe):
    """Every message of a startup, BackendKeyData's process id left out
    (it is the serving thread's)."""
    sock = socket.create_connection(addr, timeout=10)
    out = []
    try:
        if ssl_probe:
            sock.sendall(struct.pack("!II", 8, 80877103))
            out.append(sock.recv(1))
        params = f"user\x00{user}\x00database\x00default\x00\x00".encode()
        body = struct.pack("!I", 196608) + params
        sock.sendall(struct.pack("!I", len(body) + 4) + body)
        c = PGClient.__new__(PGClient)
        c.sock = sock
        while True:
            tag, payload = c._read()
            if tag == b"R" and payload[:4] == struct.pack("!I", 3):
                c._send(b"p", password.encode() + b"\x00")
            out.append((tag, payload[4:] if tag == b"K" else payload))
            if tag in (b"Z", b"E"):
                return out
    finally:
        sock.close()


@pytest.mark.parametrize("user,password,ssl_probe", [
    ("default", "", True), ("alice", "secret", False),
    ("alice", "wrong", False), ("nobody", "", False)])
def test_startup_and_password_equal_the_jax_server(servers, user, password,
                                                   ssl_probe):
    got = [_startup_replies(a, user, password, ssl_probe) for a in servers]
    assert got[1] == got[0]
    assert got[1][-1][0] == (b"Z" if password != "wrong" and
                             user != "nobody" else b"E")


def test_privilege_enforced(servers):
    c = PGClient(*servers[1], user="alice", password="secret")
    try:
        assert c.query("SELECT count() FROM t")[1] == [["10"]]
        with pytest.raises(RuntimeError, match="privilege|denied|DROP"):
            c.query("DROP TABLE t")
    finally:
        c.close()
