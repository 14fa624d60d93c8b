"""Native TCP protocol server + client: the port of
myscaledb_tpu/runtime/tcp_server.py, with the same framing and the same
JSON header, so each package's client reads the other's server.

Reference analog: the native TCP protocol (src/Core/Protocol.h:67 — client
Hello/Query/Cancel/Ping, server Hello/Data/Exception/Progress/EndOfStream)
with blocks serialized columnar by NativeWriter (src/Formats/NativeWriter.h:20)
and handled per connection by TCPHandler::runImpl (src/Server/TCPHandler.cpp:159).

Framing: 1-byte packet type + 4-byte big-endian length + payload.  Data
packets carry COLUMNAR blocks (names, dtypes, then raw little-endian
column buffers — the NativeWriter idea without the 142-format machinery);
hello/query/exception packets are small JSON.  A String column travels as
its dictionary ids with the whole dictionary in the header.  One thread per
connection; statements run through ``Session.sql_as`` under the session's
execution lock, as the session's own user (the protocol carries none).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading

import numpy as np

from myscaledb_tpu_torch.runtime.wire import WireServer, recv_exact

PROTO_VERSION = 1

# packet types (client->server and server->client share the id space,
# like Protocol.h's two enums)
HELLO = 0
QUERY = 1
PING = 2
DATA = 3
EXCEPTION = 4
END_OF_STREAM = 5
PONG = 6


def _packet(ptype: int, payload: bytes) -> bytes:
    return struct.pack(">BI", ptype, len(payload)) + payload


def _send_packet(sock, ptype: int, payload: bytes) -> None:
    sock.sendall(_packet(ptype, payload))


def _recv_packet(sock):
    hdr = recv_exact(sock, 5)
    ptype, ln = struct.unpack(">BI", hdr)
    return ptype, recv_exact(sock, ln)


def encode_block(table) -> bytes:
    """Columnar block: JSON header (names, dtypes, n_rows, per-column byte
    lengths) + concatenated raw column buffers.  Each column leaves the
    device once (``Column.to_numpy``, the logical dtype); strings travel
    as their dictionary ids + the dictionary (NativeWriter's
    LowCardinality idea)."""
    names = [n for n in table.column_names if not n.startswith("__")]
    header = {"n_rows": table.n_rows, "columns": []}
    bufs = []
    for n in names:
        c = table[n]
        data = c.to_numpy()
        col = {"name": n, "dtype": str(data.dtype),
               "shape": list(data.shape)}
        if c.dictionary is not None:
            col["dictionary"] = list(c.dictionary.values)
        if c.valid is not None:
            valid = c.valid.cpu().numpy() if hasattr(c.valid, "cpu") \
                else np.asarray(c.valid)
            # a projected constant's validity is one scalar
            valid = np.broadcast_to(valid, (table.n_rows,))
            vbuf = valid.astype(np.uint8).tobytes()
            col["valid_len"] = len(vbuf)
            bufs.append(vbuf)
        raw = np.ascontiguousarray(data).tobytes()
        col["len"] = len(raw)
        bufs.append(raw)
        header["columns"].append(col)
    hj = json.dumps(header).encode()
    return struct.pack(">I", len(hj)) + hj + b"".join(bufs)


def decode_block(payload: bytes):
    (hlen,) = struct.unpack(">I", payload[:4])
    header = json.loads(payload[4:4 + hlen])
    off = 4 + hlen
    cols = {}
    for col in header["columns"]:
        valid = None
        if "valid_len" in col:
            valid = np.frombuffer(payload[off:off + col["valid_len"]],
                                  dtype=np.uint8).astype(bool)
            off += col["valid_len"]
        raw = payload[off:off + col["len"]]
        off += col["len"]
        arr = np.frombuffer(raw, dtype=np.dtype(col["dtype"])
                            ).reshape(col["shape"])
        if "dictionary" in col:
            vals = col["dictionary"]
            arr = [None if (valid is not None and not valid[i]) or
                   arr[i] < 0 else vals[arr[i]] for i in range(len(arr))]
        cols[col["name"]] = (arr, valid)
    return header["n_rows"], cols


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        session = self.server.engine_session
        try:
            ptype, payload = _recv_packet(sock)
            if ptype != HELLO:
                _send_packet(sock, EXCEPTION,
                             json.dumps({"error": "expected Hello"}).encode())
                return
            _send_packet(sock, HELLO, json.dumps(
                {"server": "myscaledb_tpu", "version": PROTO_VERSION}
            ).encode())
            while True:
                ptype, payload = _recv_packet(sock)
                if ptype == PING:
                    _send_packet(sock, PONG, b"")
                    continue
                if ptype != QUERY:
                    break
                req = json.loads(payload)
                try:
                    block = encode_block(session.sql_as(None, req["query"]))
                except Exception as e:                    # noqa: BLE001
                    _send_packet(sock, EXCEPTION, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode())
                    continue
                sock.sendall(_packet(DATA, block) +
                             _packet(END_OF_STREAM, b""))
        except (ConnectionError, OSError):
            pass


class TcpServer(WireServer):
    def __init__(self, session, host: str = "127.0.0.1", port: int = 9000):
        super().__init__((host, port), _Handler)
        self.engine_session = session


def serve_tcp(session, host: str = "127.0.0.1", port: int = 9000
              ) -> TcpServer:
    srv = TcpServer(session, host, port)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class TcpClient:
    """Native-protocol client (the `Connection` analog, src/Client/Connection.h)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9000,
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        _send_packet(self.sock, HELLO, json.dumps(
            {"client": "myscaledb_tpu-client",
             "version": PROTO_VERSION}).encode())
        ptype, payload = _recv_packet(self.sock)
        if ptype != HELLO:
            raise ConnectionError("bad server hello")
        self.server_info = json.loads(payload)

    def ping(self) -> bool:
        _send_packet(self.sock, PING, b"")
        ptype, _ = _recv_packet(self.sock)
        return ptype == PONG

    def query(self, sql: str):
        """Run a query; returns (n_rows, {name: (array, valid)})."""
        _send_packet(self.sock, QUERY, json.dumps({"query": sql}).encode())
        blocks = []
        n_rows = 0
        while True:
            ptype, payload = _recv_packet(self.sock)
            if ptype == DATA:
                nr, cols = decode_block(payload)
                n_rows += nr
                blocks.append(cols)
            elif ptype == END_OF_STREAM:
                break
            elif ptype == EXCEPTION:
                raise RuntimeError(json.loads(payload)["error"])
            else:
                raise ConnectionError(f"unexpected packet {ptype}")
        cols = blocks[0] if blocks else {}
        return n_rows, cols

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
