"""MySQL wire-protocol server: the port of
myscaledb_tpu/runtime/mysql_server.py — any MySQL client can query the
engine.

Reference analog: src/Server/MySQLHandler.cpp + src/Core/MySQL/ — ClickHouse
speaks MySQL protocol on port 9004 so mysql-client/BI tools connect
unchanged.  This implements the text protocol subset those clients use:

  HandshakeV10 greeting -> HandshakeResponse41 (parsed: capabilities,
  username, auth response, database) -> authentication -> command phase:
  COM_QUERY (text resultset), COM_PING / COM_INIT_DB (OK), COM_QUIT.

Authentication mirrors MySQLHandler::authenticate: users without a password
connect directly; users WITH a password get an AuthSwitchRequest to
``mysql_clear_password`` (the reference does the same for its SHA-256
double-hash credential store, src/Server/MySQLHandler.cpp:authenticate —
the scramble of mysql_native_password cannot be verified against a SHA-256
hash).  Credentials are checked by runtime/access.py exactly like the HTTP
server, and every query runs as the authenticated user through
``Session.sql_as``, under the session's execution lock.

Every value is sent as a text column (MYSQL_TYPE_VAR_STRING) with lenenc
framing of the RAW cell value (no TSV escaping — lenenc needs none), the
exact behavior of the reference's text-protocol path for untyped clients.
Packets are split/reassembled at the protocol's 0xFFFFFF payload limit.
"""

from __future__ import annotations

import socketserver
import struct
import threading

from myscaledb_tpu_torch.runtime.formats import ch_cells
from myscaledb_tpu_torch.runtime.wire import WireServer, recv_exact

CAP_PROTOCOL_41 = 0x00000200
CAP_SECURE_CONNECTION = 0x00008000
CAP_PLUGIN_AUTH = 0x00080000
CAP_CONNECT_WITH_DB = 0x00000008
CAP_PLUGIN_AUTH_LENENC = 0x00200000
SERVER_CAPS = (CAP_PROTOCOL_41 | CAP_SECURE_CONNECTION | CAP_PLUGIN_AUTH |
               CAP_CONNECT_WITH_DB)

COM_QUIT, COM_INIT_DB, COM_QUERY, COM_PING = 0x01, 0x02, 0x03, 0x0E

MAX_PACKET = 0xFFFFFF


def _lenenc(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def _lenenc_str(s: bytes) -> bytes:
    return _lenenc(len(s)) + s


def read_packet(sock) -> tuple[int, bytes]:
    """Read one logical packet, reassembling 16 MiB wire splits: a payload
    of exactly 0xFFFFFF is always followed by a continuation packet."""
    payload = b""
    while True:
        head = recv_exact(sock, 4)
        length = head[0] | (head[1] << 8) | (head[2] << 16)
        seq = head[3]
        payload += recv_exact(sock, length)
        if length < MAX_PACKET:
            return seq, payload


def pack_packet(seq: int, payload: bytes) -> tuple[bytes, int]:
    """One logical packet's wire bytes, split at the 0xFFFFFF limit (a
    payload that is an exact multiple ends with an empty terminator packet
    per the protocol), and the next sequence id."""
    out = bytearray()
    pos = 0
    while True:
        chunk = payload[pos:pos + MAX_PACKET]
        out += struct.pack("<I", len(chunk))[:3] + bytes([seq & 0xFF]) + chunk
        seq += 1
        pos += len(chunk)
        if len(chunk) < MAX_PACKET:
            return bytes(out), seq


def write_packet(sock, seq: int, payload: bytes) -> int:
    """Write one logical packet; returns the next sequence id."""
    data, seq = pack_packet(seq, payload)
    sock.sendall(data)
    return seq


def _ok_packet(affected: int = 0) -> bytes:
    return (b"\x00" + _lenenc(affected) + _lenenc(0) +
            struct.pack("<HH", 0x0002, 0))          # autocommit, no warnings

def _err_packet(msg: str, code: int = 1105) -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#HY000" +
            msg.encode()[:500])


def _eof_packet() -> bytes:
    return b"\xfe" + struct.pack("<HH", 0, 0x0002)


def _column_def(name: str) -> bytes:
    # catalog, schema, table, org_table, name, org_name all lenenc
    b = (_lenenc_str(b"def") + _lenenc_str(b"") + _lenenc_str(b"") +
         _lenenc_str(b"") + _lenenc_str(name.encode()) +
         _lenenc_str(name.encode()))
    # fixed tail: charset utf8 (33), column length, type VAR_STRING (253),
    # flags, decimals, filler
    b += bytes([0x0c]) + struct.pack("<HIBHBH", 33, 1 << 16, 253, 0, 0, 0)
    return b


def _parse_handshake_response(payload: bytes) -> tuple[int, str, bytes, str]:
    """Parse HandshakeResponse41 -> (client_caps, user, auth_resp, db)."""
    caps = struct.unpack_from("<I", payload, 0)[0]
    if not caps & CAP_PROTOCOL_41:
        raise ValueError("pre-4.1 clients not supported")
    pos = 4 + 4 + 1 + 23                        # caps, max packet, charset, 0s
    end = payload.index(b"\x00", pos)
    user = payload[pos:end].decode("utf-8", "replace")
    pos = end + 1
    if caps & CAP_PLUGIN_AUTH_LENENC:
        alen = payload[pos]
        pos += 1
        if alen == 0xFC:
            alen = struct.unpack_from("<H", payload, pos)[0]
            pos += 2
        auth = payload[pos:pos + alen]
        pos += alen
    elif caps & CAP_SECURE_CONNECTION:
        alen = payload[pos]
        pos += 1
        auth = payload[pos:pos + alen]
        pos += alen
    else:
        end = payload.index(b"\x00", pos)
        auth = payload[pos:end]
        pos = end + 1
    db = ""
    if caps & CAP_CONNECT_WITH_DB and pos < len(payload):
        end = payload.find(b"\x00", pos)
        if end < 0:
            end = len(payload)
        db = payload[pos:end].decode("utf-8", "replace")
    return caps, user, auth, db


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        session = self.server.engine_session
        # HandshakeV10 greeting
        greeting = (bytes([10]) + b"8.0.0-myscaledb-tpu\x00" +
                    struct.pack("<I", threading.get_ident() & 0xFFFFFFFF) +
                    b"12345678\x00" +
                    struct.pack("<H", SERVER_CAPS & 0xFFFF) +
                    bytes([33]) + struct.pack("<H", 0x0002) +
                    struct.pack("<H", SERVER_CAPS >> 16) +
                    bytes([21]) + b"\x00" * 10 +
                    b"123456789012\x00" + b"mysql_native_password\x00")
        seq = write_packet(sock, 0, greeting)
        try:
            seq, resp = read_packet(sock)        # HandshakeResponse41
            _caps, user, _auth, _db = _parse_handshake_response(resp)
        except (ConnectionError, ValueError, IndexError):
            return
        access = session.access
        known = access.users.get(user)
        try:
            if known is not None and known.password_hash is not None:
                # the native scramble cannot be checked against our SHA-256
                # store: switch the client to cleartext (MySQLHandler.cpp
                # does the same for SHA-256 users).
                seq = write_packet(sock, seq + 1,
                                   b"\xfe" + b"mysql_clear_password\x00")
                seq, auth2 = read_packet(sock)
                password = auth2.rstrip(b"\x00").decode("utf-8", "replace")
                auth_user = access.authenticate(user, password)
            else:
                auth_user = access.authenticate(user or "default", None)
        except Exception as e:                          # noqa: BLE001
            try:
                write_packet(sock, seq + 1, _err_packet(
                    f"Access denied for user {user!r}: {e}", 1045))
            except OSError:
                pass
            return
        seq = write_packet(sock, seq + 1, _ok_packet())
        try:
            self._commands(sock, session, auth_user)
        except (ConnectionError, OSError):
            pass      # the client went away, mid-result too

    @staticmethod
    def _commands(sock, session, auth_user):
        while True:
            _seq, payload = read_packet(sock)
            if not payload:
                return
            cmd = payload[0]
            if cmd == COM_QUIT:
                return
            if cmd in (COM_PING, COM_INIT_DB):
                write_packet(sock, 1, _ok_packet())
                continue
            if cmd != COM_QUERY:
                write_packet(sock, 1, _err_packet(
                    f"unsupported command {cmd:#x}", 1047))
                continue
            sql = payload[1:].decode("utf-8", "replace").strip().rstrip(";")
            try:
                result = session.sql_as(auth_user, sql)
            except Exception as e:                    # noqa: BLE001
                write_packet(sock, 1, _err_packet(str(e)))
                continue
            names = [c for c in result.column_names
                     if not c.startswith("__")]
            if not names:
                write_packet(sock, 1, _ok_packet())
                continue
            # the whole result set in one send
            rows = ch_cells(result.select(names))
            payloads = [_lenenc(len(names))]
            payloads += [_column_def(nm) for nm in names]
            payloads.append(_eof_packet())
            payloads += [b"".join(
                b"\xfb" if cell is None else _lenenc_str(cell.encode())
                for cell in cells) for cells in rows]
            payloads.append(_eof_packet())
            out, seq = [], 1
            for p in payloads:
                data, seq = pack_packet(seq, p)
                out.append(data)
            sock.sendall(b"".join(out))


def serve_mysql(session, host: str = "127.0.0.1",
                port: int = 9004) -> WireServer:
    srv = WireServer((host, port), _Handler)
    srv.engine_session = session
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
