"""The port's native TCP server against the JAX package's, on the CPU: the
same framing and JSON header, so each package's TcpClient reads the other
package's server, and both servers send the same values for the same
statements (ids, sums, strings through the dictionary, NULL validity,
vectors).  The connection survives an exception (TCPHandler keeps
serving).  After tests/test_tcp_server.py."""

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime import tcp_server as JT
from myscaledb_tpu_torch.runtime import tcp_server as PT

STATEMENTS = [
    "SELECT id, v FROM t ORDER BY id LIMIT 5",
    "SELECT name FROM t ORDER BY id LIMIT 7",
    "SELECT sum(v), count() FROM t",
    "SELECT v, count() AS c FROM t GROUP BY v ORDER BY v",
    "SELECT id, nullIf(v, 3) AS n FROM t ORDER BY id LIMIT 9",
    "SELECT id, emb FROM t ORDER BY id LIMIT 3",
    "SELECT id, distance(emb, [0.5, -0.5, 0.25]) AS d FROM t "
    "ORDER BY d LIMIT 4",
]


@pytest.fixture(scope="module")
def servers():
    rng = np.random.default_rng(0)
    n = 100
    data = {"id": np.arange(n, dtype=np.int64),
            "v": rng.integers(0, 50, n).astype(np.int64),
            "name": rng.choice(["x", "y", "z"], n),
            "emb": rng.standard_normal((n, 3)).astype(np.float32)}
    out = []
    for mod, serve, kw in ((myscaledb_tpu, JT.serve_tcp, {}),
                           (myscaledb_tpu_torch, PT.serve_tcp,
                            {"device": "cpu"})):
        s = mod.connect(**kw)
        s.create_table("t", data)
        out.append(serve(s, port=0))
    yield [srv.server_address[1] for srv in out]
    for srv in out:
        srv.shutdown()
        srv.server_close()


def _values(cols):
    return {k: ([None if x is None else x for x in a] if isinstance(a, list)
                else np.asarray(a).tolist(),
                None if v is None else np.asarray(v).tolist())
            for k, (a, v) in cols.items()}


@pytest.mark.parametrize("stmt", range(len(STATEMENTS)))
@pytest.mark.parametrize("client", ["jax", "port"])
def test_clients_read_both_servers_equally(servers, stmt, client):
    cls = JT.TcpClient if client == "jax" else PT.TcpClient
    got = []
    for port in servers:
        c = cls(port=port, timeout=10)
        try:
            assert c.server_info["server"] == "myscaledb_tpu"
            assert c.ping()
            got.append(c.query(STATEMENTS[stmt]))
        finally:
            c.close()
    (n0, c0), (n1, c1) = got
    assert n1 == n0 > 0
    assert _values(c1) == _values(c0)


def test_block_bytes_equal_the_jax_server(servers):
    """The port's Data packet is the JAX server's, byte for byte, for a
    statement whose columns have the same physical types in both."""
    import socket
    import json
    payloads = []
    for port in servers:
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            PT._send_packet(sock, PT.HELLO, json.dumps({"client": "t"}).encode())
            PT._recv_packet(sock)
            PT._send_packet(sock, PT.QUERY, json.dumps(
                {"query": "SELECT id, name, v FROM t ORDER BY id LIMIT 6"}
            ).encode())
            payloads.append([PT._recv_packet(sock), PT._recv_packet(sock)])
        finally:
            sock.close()
    assert payloads[1] == payloads[0]
    assert [p[0] for p in payloads[1]] == [PT.DATA, PT.END_OF_STREAM]


def test_errors_keep_the_connection(servers):
    for cls in (JT.TcpClient, PT.TcpClient):
        c = cls(port=servers[1], timeout=10)
        try:
            with pytest.raises(RuntimeError, match="nonsense_column"):
                c.query("SELECT nonsense_column FROM t")
            n, cols = c.query("SELECT count() FROM t")
            assert n == 1 and int(cols["count()"][0][0]) == 100
        finally:
            c.close()
