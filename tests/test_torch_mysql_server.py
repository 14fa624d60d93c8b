"""The port's MySQL wire server against the JAX package's, on the CPU:
both serve the same tables, and every reply — a result set's column
definitions, EOFs and rows, an OK, an error packet, NULL cells, raw
strings with tabs and quotes — is the JAX server's packet for packet,
sequence ids included.  The password switch (AuthSwitchRequest to
mysql_clear_password) answers alike, and a wrong password is refused.
After tests/test_mysql_server.py."""

import socket
import struct

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime.mysql_server import serve_mysql as j_serve
from myscaledb_tpu_torch.runtime.mysql_server import (read_packet,
                                                      serve_mysql,
                                                      write_packet)
from tools.wire_clients import MySQLClient

STATEMENTS = [
    "SELECT id, name, v FROM t ORDER BY id LIMIT 3",
    "SELECT count(), sum(id) FROM t",
    "SELECT nullIf(id, 1) FROM t ORDER BY id LIMIT 3",
    "SELECT 'a\\tb', 'q\\'x', nullIf(1, 1)",
    "SELECT id, [id, id + 1] AS a FROM t ORDER BY id LIMIT 2",
    "SELECT * FROM nope",
    "CREATE TABLE made (a Int64) ENGINE = Memory",
]


@pytest.fixture(scope="module")
def servers():
    out = []
    for mod, serve, kw in ((myscaledb_tpu, j_serve, {}),
                           (myscaledb_tpu_torch, serve_mysql,
                            {"device": "cpu"})):
        s = mod.connect(**kw)
        s.create_table("t", {"id": np.arange(10, dtype=np.int64),
                             "name": np.array([f"n{i}" for i in range(10)]),
                             "v": np.arange(10, dtype=np.float64) * 1.5})
        s.sql("CREATE USER bob IDENTIFIED BY 'pw123'")
        s.sql("GRANT SELECT ON t TO bob")
        out.append(serve(s, "127.0.0.1", 0))
    yield [srv.server_address for srv in out]
    for srv in out:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("stmt", range(len(STATEMENTS)))
def test_reply_packets_equal_the_jax_server(servers, stmt):
    got = []
    for addr in servers:
        c = MySQLClient(*addr)
        try:
            got.append(c.raw_query(STATEMENTS[stmt]))
        finally:
            c.close()
    assert got[1] == got[0]


def test_rows_nulls_and_raw_strings(servers):
    c = MySQLClient(*servers[1])
    try:
        assert b"myscaledb" in c.server_version
        assert c.ping()
        names, rows = c.query("SELECT id, name, v FROM t ORDER BY id LIMIT 3")
        assert names == ["id", "name", "v"]
        assert rows == [["0", "n0", "0"], ["1", "n1", "1.5"],
                        ["2", "n2", "3"]]
        assert c.query("SELECT 'a\\tb', 'q\\'x', nullIf(1, 1)")[1] == \
            [["a\tb", "q'x", None]]
        with pytest.raises(RuntimeError, match="nope"):
            c.query("SELECT * FROM nope")
        assert c.query("SELECT 1 + 1")[1] == [["2"]]
    finally:
        c.close()


def _handshake_as(addr, user: bytes):
    sock = socket.create_connection(addr, timeout=10)
    seq, _greeting = read_packet(sock)
    resp = (struct.pack("<IIB", 0x0200 | 0x8000, 1 << 24, 33) +
            b"\x00" * 23 + user + b"\x00" + b"\x00")
    write_packet(sock, seq + 1, resp)
    return sock, read_packet(sock)


@pytest.mark.parametrize("password,ok", [(b"pw123", True), (b"nope", False)])
def test_password_switch_equals_the_jax_server(servers, password, ok):
    replies = []
    for addr in servers:
        sock, switch = _handshake_as(addr, b"bob")
        try:
            write_packet(sock, switch[0] + 1, password + b"\x00")
            reply = [switch, read_packet(sock)]
            if ok:           # a count: columns, EOF, one row, EOF
                write_packet(sock, 0, b"\x03SELECT count() FROM t")
                reply += [read_packet(sock) for _ in range(5)]
            replies.append(reply)
        finally:
            sock.close()
    assert replies[1] == replies[0]
    assert replies[1][0][1][0] == 0xFE and \
        b"mysql_clear_password" in replies[1][0][1]
    assert replies[1][1][1][0] == (0x00 if ok else 0xFF)


def test_client_runs_as_its_user(servers):
    c = MySQLClient(*servers[1], user="bob", password="pw123")
    try:
        assert c.query("SELECT count() FROM t")[1] == [["10"]]
        with pytest.raises(RuntimeError, match="(?i)denied|privilege"):
            c.query("DROP TABLE t")
    finally:
        c.close()
    with pytest.raises(RuntimeError):
        MySQLClient(*servers[1], user="bob", password="wrong")
