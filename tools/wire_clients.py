"""Small clients of the MySQL, PostgreSQL and gRPC wire protocols, enough
to drive the port's runtime/mysql_server.py, pg_server.py and
grpc_server.py from the tests and from chip_smoke.py (imported as
``tools.wire_clients`` from the repo root): a protocol-41 text client
with the cleartext password switch, a v3 client with the simple and the
extended protocol, and one unary gRPC call over raw HTTP/2 frames.  Each keeps the
raw packets it read, so two servers' replies can be compared byte for
byte.  Every socket has a timeout."""

from __future__ import annotations

import socket
import struct

from myscaledb_tpu_torch.runtime import grpc_server as G
from myscaledb_tpu_torch.runtime.mysql_server import read_packet, write_packet

TIMEOUT_S = 10.0


def _lenenc(data: bytes, pos: int) -> tuple[int, int]:
    first = data[pos]
    if first < 251:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9


class MySQLClient:
    """HandshakeResponse41 as ``user``; a password is sent in clear after
    the server's AuthSwitchRequest to mysql_clear_password."""

    def __init__(self, host, port, user="default", password=None,
                 timeout=TIMEOUT_S):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        seq, greeting = read_packet(self.sock)
        if greeting[0] != 10:                          # HandshakeV10
            raise ConnectionError("not a HandshakeV10 greeting")
        self.server_version = greeting[1:greeting.index(b"\x00", 1)]
        resp = (struct.pack("<IIB", 0x0200 | 0x8000, 1 << 24, 33) +
                b"\x00" * 23 + user.encode() + b"\x00" + b"\x00")
        write_packet(self.sock, seq + 1, resp)
        seq, reply = read_packet(self.sock)
        if reply[0] == 0xFE:                           # AuthSwitchRequest
            write_packet(self.sock, seq + 1,
                         (password or "").encode() + b"\x00")
            seq, reply = read_packet(self.sock)
        if reply[0] != 0x00:
            raise RuntimeError(reply[9:].decode("utf-8", "replace"))

    def raw_query(self, sql: str) -> list:
        """Every packet of the reply, (sequence id, payload) in order."""
        write_packet(self.sock, 0, b"\x03" + sql.encode())
        packets = [read_packet(self.sock)]
        first = packets[0][1]
        if first[0] in (0x00, 0xFF):
            return packets
        eofs = 0
        while eofs < 2:                 # after the columns, after the rows
            packets.append(read_packet(self.sock))
            pkt = packets[-1][1]
            if pkt[0] == 0xFE and len(pkt) < 9:
                eofs += 1
        return packets

    def query(self, sql: str):
        """(names, rows) of a result set, None for an OK; an error packet
        raises RuntimeError."""
        packets = [p for _s, p in self.raw_query(sql)]
        first = packets[0]
        if first[0] == 0xFF:
            raise RuntimeError(first[9:].decode("utf-8", "replace"))
        if first[0] == 0x00:
            return None
        ncols, _ = _lenenc(first, 0)
        names = []
        for coldef in packets[1:1 + ncols]:
            pos, vals = 0, []
            for _f in range(6):                       # six lenenc strings
                ln, pos = _lenenc(coldef, pos)
                vals.append(coldef[pos:pos + ln])
                pos += ln
            names.append(vals[4].decode())
        rows = []
        for pkt in packets[2 + ncols:-1]:
            row, pos = [], 0
            while pos < len(pkt):
                if pkt[pos] == 0xFB:                  # NULL
                    row.append(None)
                    pos += 1
                    continue
                ln, pos = _lenenc(pkt, pos)
                row.append(pkt[pos:pos + ln].decode())
                pos += ln
            rows.append(row)
        return names, rows

    def ping(self) -> bool:
        write_packet(self.sock, 0, b"\x0e")
        return read_packet(self.sock)[1][0] == 0x00

    def close(self):
        try:
            write_packet(self.sock, 0, b"\x01")
        finally:
            self.sock.close()


class PGClient:
    """StartupMessage as ``user`` (after an SSLRequest with
    ``ssl_probe``), a cleartext password when asked; the simple query
    protocol, and the extended one's messages sent one by one."""

    def __init__(self, host, port, user="default", password=None,
                 ssl_probe=False, timeout=TIMEOUT_S):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        if ssl_probe:
            self.sock.sendall(struct.pack("!II", 8, 80877103))
            if self.sock.recv(1) != b"N":
                raise ConnectionError("SSLRequest not refused")
        params = f"user\x00{user}\x00database\x00default\x00\x00".encode()
        body = struct.pack("!I", 196608) + params
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        self.params = {}
        while True:
            tag, payload = self._read()
            if tag == b"R":
                (code,) = struct.unpack("!I", payload[:4])
                if code == 3:                          # cleartext password
                    pw = (password or "").encode() + b"\x00"
                    self._send(b"p", pw)
                elif code != 0:
                    raise RuntimeError(f"unsupported auth {code}")
            elif tag == b"S":
                k, v = payload.split(b"\x00")[:2]
                self.params[k.decode()] = v.decode()
            elif tag == b"E":
                raise RuntimeError(payload.decode("utf-8", "replace"))
            elif tag == b"Z":
                return

    def _exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            c = self.sock.recv(n - len(buf))
            if not c:
                raise ConnectionError("closed")
            buf += c
        return bytes(buf)

    def _read(self):
        tag = self._exact(1)
        (length,) = struct.unpack("!I", self._exact(4))
        return tag, self._exact(length - 4)

    def _send(self, tag: bytes, payload: bytes):
        self.sock.sendall(tag + struct.pack("!I", len(payload) + 4) + payload)

    def collect_until_ready(self) -> list:
        """Every message up to ReadyForQuery, as (tag, payload)."""
        out = []
        while True:
            out.append(self._read())
            if out[-1][0] == b"Z":
                return out

    def raw_query(self, sql: str) -> list:
        self._send(b"Q", sql.encode() + b"\x00")
        return self.collect_until_ready()

    def query(self, sql: str):
        """(names, rows); an ErrorResponse raises RuntimeError."""
        msgs = self.raw_query(sql)
        errs = [p for t, p in msgs if t == b"E"]
        if errs:
            raise RuntimeError(errs[0].decode("utf-8", "replace"))
        return self.parse_rows(msgs)

    @staticmethod
    def parse_rows(msgs):
        names, rows = [], []
        for tag, payload in msgs:
            if tag == b"T":
                (n,) = struct.unpack("!H", payload[:2])
                pos = 2
                for _ in range(n):
                    end = payload.index(b"\x00", pos)
                    names.append(payload[pos:end].decode())
                    pos = end + 1 + 18
            elif tag == b"D":
                (n,) = struct.unpack("!H", payload[:2])
                pos = 2
                row = []
                for _ in range(n):
                    (ln,) = struct.unpack("!i", payload[pos:pos + 4])
                    pos += 4
                    if ln < 0:
                        row.append(None)
                    else:
                        row.append(payload[pos:pos + ln].decode())
                        pos += ln
                rows.append(row)
        return names, rows

    # -- extended protocol --------------------------------------------------

    def parse(self, name, sql, oids=()):
        self._send(b"P", name.encode() + b"\x00" + sql.encode() + b"\x00" +
                   struct.pack("!H", len(oids)) +
                   b"".join(struct.pack("!I", o) for o in oids))

    def bind(self, portal, stmt, params=()):
        body = portal.encode() + b"\x00" + stmt.encode() + b"\x00"
        body += struct.pack("!H", 0)                     # param fmts: text
        body += struct.pack("!H", len(params))
        for v in params:
            if v is None:
                body += struct.pack("!i", -1)
            else:
                raw = str(v).encode()
                body += struct.pack("!I", len(raw)) + raw
        body += struct.pack("!H", 0)                     # result fmts: text
        self._send(b"B", body)

    def describe(self, kind, name):
        self._send(b"D", kind.encode() + name.encode() + b"\x00")

    def execute(self, portal, max_rows=0):
        self._send(b"E", portal.encode() + b"\x00" +
                   struct.pack("!i", max_rows))

    def sync(self):
        self._send(b"S", b"")

    def close(self):
        try:
            self._send(b"X", b"")
        finally:
            self.sock.close()


def query_info(query="", **kw) -> bytes:
    """A clickhouse_grpc.proto QueryInfo."""
    msg = G.enc_str(1, query)
    msg += G.enc_str(2, kw.get("query_id", ""))
    msg += G.enc_str(5, kw.get("input_data", b""))
    msg += G.enc_str(7, kw.get("output_format", ""))
    msg += G.enc_str(9, kw.get("user_name", ""))
    msg += G.enc_str(10, kw.get("password", ""))
    if kw.get("send_output_columns"):
        msg += G.enc_varint_field(24, 1)
    return msg


def grpc_call(port, msgs, extra_headers=(), host="127.0.0.1",
              timeout=TIMEOUT_S):
    """One unary call of ExecuteQuery on stream 1.  Returns (the Result
    messages' raw bytes, response headers, trailers)."""
    s = socket.create_connection((host, port), timeout=timeout)
    try:
        s.sendall(G.PREFACE + G._frame(G.F_SETTINGS, 0, 0, b""))
        hdrs = G.hpack_encode(
            [(":method", "POST"), (":scheme", "http"),
             (":path", "/clickhouse.grpc.ClickHouse/ExecuteQuery"),
             (":authority", "localhost"),
             ("content-type", "application/grpc"), ("te", "trailers")]
            + list(extra_headers))
        s.sendall(G._frame(G.F_HEADERS, G.FLAG_END_HEADERS, 1, hdrs))
        body = b"".join(G.grpc_frame(m) for m in msgs)
        s.sendall(G._frame(G.F_DATA, G.FLAG_END_STREAM, 1, body))
        dec = G.HpackDecoder()
        headers, trailers, data = None, None, b""
        while True:
            ftype, flags, sid, payload = G._read_frame(s)
            if ftype == G.F_SETTINGS:
                if not flags & G.FLAG_ACK:
                    s.sendall(G._frame(G.F_SETTINGS, G.FLAG_ACK, 0, b""))
                continue
            if ftype == G.F_GOAWAY:
                raise ConnectionError(f"GOAWAY {payload[4:8].hex()}: "
                                      f"{payload[8:].decode()}")
            if sid != 1:
                continue
            if ftype == G.F_HEADERS:
                decoded = dict(dec.decode(payload))
                if headers is None:
                    headers = decoded
                else:
                    trailers = decoded
            elif ftype == G.F_DATA:
                data += payload
            if flags & G.FLAG_END_STREAM:
                break
        return ([m for _c, m in G.grpc_frames(data)], headers or {},
                trailers or {})
    finally:
        s.close()
