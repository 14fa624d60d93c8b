"""PostgreSQL wire-protocol server: the port of
myscaledb_tpu/runtime/pg_server.py — psql / any PG driver can query the
engine.

Reference analog: src/Server/PostgreSQLHandler.cpp + src/Core/PostgreSQL/ —
ClickHouse speaks the PG v3 protocol on port 9005.  This implements the
subset interactive clients and drivers use:

  StartupMessage (SSLRequest answered 'N') -> cleartext-password auth when
  the user has one (PostgreSQLHandler does the same) -> simple query
  protocol: 'Q' -> RowDescription / DataRow* / CommandComplete /
  ReadyForQuery; errors as ErrorResponse.

  Extended protocol (what psycopg3 / JDBC prepared statements speak):
  Parse ('P') -> ParseComplete; Bind ('B') substitutes $N text parameters
  into the statement (PostgreSQLHandler.cpp replacePlaceholders does the
  same textual substitution — the engine has no server-side plan cache to
  bind into); Describe ('D') of a portal executes the (side-effect-free)
  SELECT once and caches rows for Execute; Execute ('E') streams DataRows
  honoring the row limit with PortalSuspended; Close/Flush/Sync per spec.
  After an error every message is skipped until Sync, as the protocol
  requires.  Binary (format=1) parameters/results are rejected.

Values travel as length-prefixed raw cells (ch_cells escape=False — PG
framing needs no escaping); NULL is length -1.  Every statement runs as
the authenticated user through ``Session.sql_as``, under the session's
execution lock.
"""

from __future__ import annotations

import re
import socketserver
import struct
import threading

from myscaledb_tpu_torch.runtime.formats import ch_cells
from myscaledb_tpu_torch.runtime.wire import WireServer, recv_exact

SSL_REQUEST = 80877103
CANCEL_REQUEST = 80877102
PROTOCOL_V3 = 196608


class _PGError(Exception):
    """Engine/protocol error carrying a SQLSTATE code."""

    def __init__(self, msg: str, code: str = "XX000"):
        super().__init__(msg)
        self.msg = msg
        self.code = code


def _read_startup(sock) -> tuple[int, dict]:
    (length,) = struct.unpack("!I", recv_exact(sock, 4))
    body = recv_exact(sock, length - 4)
    (code,) = struct.unpack("!I", body[:4])
    params = {}
    if code == PROTOCOL_V3:
        parts = body[4:].split(b"\x00")
        for k, v in zip(parts[::2], parts[1::2]):
            if k:
                params[k.decode()] = v.decode("utf-8", "replace")
    return code, params


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def _read_msg(sock) -> tuple[bytes, bytes]:
    tag = recv_exact(sock, 1)
    (length,) = struct.unpack("!I", recv_exact(sock, 4))
    return tag, recv_exact(sock, length - 4)


def _error(msg: str, code: str = "XX000") -> bytes:
    fields = (b"SERROR\x00" + b"C" + code.encode() + b"\x00" +
              b"M" + msg.encode("utf-8", "replace")[:800] + b"\x00\x00")
    return _msg(b"E", fields)


def _ready() -> bytes:
    return _msg(b"Z", b"I")


def _row_description(names: list) -> bytes:
    body = struct.pack("!H", len(names))
    for nm in names:
        # name, table oid 0, attnum 0, type oid 25 (text), typlen -1,
        # typmod -1, format 0 (text)
        body += (nm.encode("utf-8", "replace") + b"\x00" +
                 struct.pack("!IhIhih", 0, 0, 25, -1, -1, 0))
    return _msg(b"T", body)


def _data_row(cells: list) -> bytes:
    body = struct.pack("!H", len(cells))
    for cell in cells:
        if cell is None:
            body += struct.pack("!i", -1)
        else:
            raw = cell.encode("utf-8", "replace")
            body += struct.pack("!I", len(raw)) + raw
    return _msg(b"D", body)


def _cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("utf-8", "replace"), end + 1


_NUMERIC_RE = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?$")
_PARAM_RE = re.compile(r"\$(\d+)")


def _sql_literal(text: str | None) -> str:
    """Render a text-format parameter value as a SQL literal: NULL for
    null, bare for numerics, quoted (with '' and \\\\ escaping) otherwise —
    the same textual placeholder substitution as the reference
    (src/Core/PostgreSQL/PostgreSQLProtocol.h prepared-statement handling
    routes through the ordinary query path)."""
    if text is None:
        return "NULL"
    if _NUMERIC_RE.match(text):
        return text
    return "'" + text.replace("\\", "\\\\").replace("'", "\\'") + "'"


def _substitute_params(sql: str, values: list) -> str:
    """Replace $1..$N placeholders outside string literals/identifiers."""
    out = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch in "'\"`":
            quote = ch
            out.append(ch)
            i += 1
            while i < n:
                if sql[i] == "\\" and i + 1 < n:
                    out.append(sql[i:i + 2])
                    i += 2
                    continue
                out.append(sql[i])
                if sql[i] == quote:
                    # '' style escape: stay inside the literal
                    if i + 1 < n and sql[i + 1] == quote:
                        out.append(quote)
                        i += 2
                        continue
                    i += 1
                    break
                i += 1
            continue
        if ch == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            idx = int(sql[i + 1:j]) - 1
            if 0 <= idx < len(values):
                out.append(_sql_literal(values[idx]))
                i = j
                continue
        out.append(ch)
        i += 1
    return "".join(out)


class _Portal:
    __slots__ = ("sql", "names", "rows", "cursor", "done")

    def __init__(self, sql: str):
        self.sql = sql
        self.names = None        # None = not executed yet
        self.rows = None
        self.cursor = 0
        self.done = False


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        session = self.server.engine_session
        user = "default"   # referenced by the generic error handler below;
        try:               # a malformed startup packet raises before parse
            code, params = _read_startup(sock)
            if code == SSL_REQUEST:
                sock.sendall(b"N")                  # no TLS; retry plaintext
                code, params = _read_startup(sock)
            if code == CANCEL_REQUEST:
                return
            if code != PROTOCOL_V3:
                sock.sendall(_error(f"unsupported protocol {code:#x}",
                                    "08P01"))
                return
            user = params.get("user", "default")
            access = session.access
            known = access.users.get(user)
            if known is not None and known.password_hash is not None:
                sock.sendall(_msg(b"R", struct.pack("!I", 3)))  # cleartext
                tag, body = _read_msg(sock)
                if tag != b"p":
                    sock.sendall(_error("expected PasswordMessage", "08P01"))
                    return
                password = body.rstrip(b"\x00").decode("utf-8", "replace")
                auth_user = access.authenticate(user, password)
            else:
                auth_user = access.authenticate(user, None)
        except ConnectionError:
            return
        except Exception as e:                        # noqa: BLE001
            try:
                sock.sendall(_error(
                    f"password authentication failed for user "
                    f"\"{user}\": {e}", "28P01"))
            except OSError:
                pass
            return
        sock.sendall(_msg(b"R", struct.pack("!I", 0)))          # AuthOk
        for k, v in (("server_version", "14.0 (myscaledb-tpu)"),
                     ("server_encoding", "UTF8"),
                     ("client_encoding", "UTF8"),
                     ("DateStyle", "ISO")):
            sock.sendall(_msg(b"S", k.encode() + b"\x00" +
                              v.encode() + b"\x00"))
        sock.sendall(_msg(b"K", struct.pack(
            "!II", threading.get_ident() & 0x7FFFFFFF, 0)))
        sock.sendall(_ready())
        self._session = session
        self._auth_user = auth_user
        stmts: dict = {}        # name -> (sql, param_oids)
        portals: dict = {}      # name -> _Portal
        in_error = False        # extended protocol: skip until Sync
        while True:
            try:
                tag, body = _read_msg(sock)
            except (ConnectionError, OSError):
                return
            if tag == b"X":
                return
            if tag == b"S":                              # Sync
                in_error = False
                sock.sendall(_ready())
                continue
            if in_error and tag != b"Q":
                continue
            try:
                if tag == b"Q":
                    self._simple_query(sock, body)
                elif tag == b"P":
                    self._parse(sock, body, stmts)
                elif tag == b"B":
                    self._bind(sock, body, stmts, portals)
                elif tag == b"D":
                    self._describe(sock, body, stmts, portals)
                elif tag == b"E":
                    self._exec_portal(sock, body, portals)
                elif tag == b"C":                        # Close
                    kind, pos = body[:1], 1
                    name, _ = _cstr(body, pos)
                    (stmts if kind == b"S" else portals).pop(name, None)
                    sock.sendall(_msg(b"3", b""))        # CloseComplete
                elif tag == b"H":                        # Flush: we always
                    pass                                 # send eagerly
                else:
                    raise _PGError(
                        f"protocol message {tag!r} not supported", "0A000")
            except _PGError as e:
                sock.sendall(_error(e.msg, e.code))
                if tag == b"Q":
                    sock.sendall(_ready())
                else:
                    in_error = True
            except (ConnectionError, OSError):
                return

    # -- execution helpers --------------------------------------------------

    def _run_sql(self, sql: str):
        """Execute through the engine; (names, rows) — rows None for
        commands.  Raises _PGError on failure."""
        try:
            result = self._session.sql_as(self._auth_user, sql)
        except Exception as e:                            # noqa: BLE001
            raise _PGError(str(e)) from e
        names = [c for c in result.column_names if not c.startswith("__")]
        if not names:
            return [], None
        return names, list(ch_cells(result.select(names)))

    def _simple_query(self, sock, body: bytes) -> None:
        sql = body.rstrip(b"\x00").decode("utf-8", "replace")
        sql = sql.strip().rstrip(";")
        if not sql:
            sock.sendall(_msg(b"I", b""))                 # EmptyQueryResponse
            sock.sendall(_ready())
            return
        names, rows = self._run_sql(sql)
        if not names:
            sock.sendall(_msg(b"C", b"OK\x00"))
            sock.sendall(_ready())
            return
        out = [_row_description(names)]
        out += [_data_row(cells) for cells in rows]
        out.append(_msg(b"C", f"SELECT {len(rows)}\x00".encode()))
        out.append(_ready())
        sock.sendall(b"".join(out))

    def _parse(self, sock, body: bytes, stmts: dict) -> None:
        name, pos = _cstr(body, 0)
        sql, pos = _cstr(body, pos)
        (n_oids,) = struct.unpack_from("!H", body, pos)
        pos += 2
        oids = list(struct.unpack_from(f"!{n_oids}I", body, pos))
        stmts[name] = (sql.strip().rstrip(";"), oids)
        sock.sendall(_msg(b"1", b""))                     # ParseComplete

    def _bind(self, sock, body: bytes, stmts: dict, portals: dict) -> None:
        portal, pos = _cstr(body, 0)
        stmt, pos = _cstr(body, pos)
        if stmt not in stmts:
            raise _PGError(f"unknown prepared statement \"{stmt}\"", "26000")
        (n_fmt,) = struct.unpack_from("!H", body, pos)
        pos += 2
        fmts = struct.unpack_from(f"!{n_fmt}h", body, pos)
        pos += 2 * n_fmt
        if any(f == 1 for f in fmts):
            raise _PGError("binary parameter format not supported", "0A000")
        (n_par,) = struct.unpack_from("!H", body, pos)
        pos += 2
        values = []
        for _ in range(n_par):
            (ln,) = struct.unpack_from("!i", body, pos)
            pos += 4
            if ln < 0:
                values.append(None)
            else:
                values.append(body[pos:pos + ln].decode("utf-8", "replace"))
                pos += ln
        (n_rfmt,) = struct.unpack_from("!H", body, pos)
        pos += 2
        rfmts = struct.unpack_from(f"!{n_rfmt}h", body, pos)
        if any(f == 1 for f in rfmts):
            raise _PGError("binary result format not supported", "0A000")
        sql = _substitute_params(stmts[stmt][0], values)
        portals[portal] = _Portal(sql)
        sock.sendall(_msg(b"2", b""))                     # BindComplete

    def _ensure_executed(self, p: _Portal) -> None:
        if p.names is None:
            p.names, p.rows = self._run_sql(p.sql)

    def _describe(self, sock, body: bytes, stmts: dict,
                  portals: dict) -> None:
        kind, name = body[:1], _cstr(body, 1)[0]
        if kind == b"S":
            if name not in stmts:
                raise _PGError(f"unknown prepared statement \"{name}\"",
                               "26000")
            sql, oids = stmts[name]
            n_params = max(len(oids), self._max_param(sql))
            pd = struct.pack("!H", n_params) + b"".join(
                struct.pack("!I", oids[i] if i < len(oids) and oids[i]
                            else 25) for i in range(n_params))
            sock.sendall(_msg(b"t", pd))                  # ParameterDescription
            names = self._probe_names(sql, n_params)
            sock.sendall(_row_description(names) if names
                         else _msg(b"n", b""))            # NoData
            return
        if name not in portals:
            raise _PGError(f"unknown portal \"{name}\"", "34000")
        p = portals[name]
        self._ensure_executed(p)
        sock.sendall(_row_description(p.names) if p.names
                     else _msg(b"n", b""))

    @staticmethod
    def _max_param(sql: str) -> int:
        return max((int(m) for m in _PARAM_RE.findall(sql)), default=0)

    def _probe_names(self, sql: str, n_params: int) -> list:
        """Result column names for Describe(statement): run the query with
        NULL substituted for each parameter — only for side-effect-free
        statements (a describe must never run an INSERT)."""
        head = sql.lstrip("( \t\n").split(None, 1)
        if not head or head[0].upper() not in (
                "SELECT", "WITH", "VALUES", "SHOW", "EXPLAIN", "DESCRIBE",
                "DESC"):
            return []
        try:
            names, _ = self._run_sql(
                _substitute_params(sql, [None] * n_params))
            return names
        except _PGError:
            return []

    def _exec_portal(self, sock, body: bytes, portals: dict) -> None:
        name, pos = _cstr(body, 0)
        (max_rows,) = struct.unpack_from("!i", body, pos)
        if name not in portals:
            raise _PGError(f"unknown portal \"{name}\"", "34000")
        p = portals[name]
        self._ensure_executed(p)
        if not p.names:
            sock.sendall(_msg(b"C", b"OK\x00"))
            return
        end = len(p.rows) if max_rows <= 0 else min(len(p.rows),
                                                    p.cursor + max_rows)
        out = [_data_row(cells) for cells in p.rows[p.cursor:end]]
        sent = end - p.cursor
        p.cursor = end
        if p.cursor < len(p.rows):
            out.append(_msg(b"s", b""))                   # PortalSuspended
        else:
            out.append(_msg(b"C", f"SELECT {sent}\x00".encode()))
        sock.sendall(b"".join(out))


def serve_pg(session, host: str = "127.0.0.1", port: int = 9005
             ) -> WireServer:
    srv = WireServer((host, port), _Handler)
    srv.engine_session = session
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
