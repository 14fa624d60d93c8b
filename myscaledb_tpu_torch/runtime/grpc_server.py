"""gRPC protocol server: the port of myscaledb_tpu/runtime/grpc_server.py.

Reference analog: src/Server/GRPCServer.cpp — the ClickHouse gRPC service
(src/Server/grpc_protos/clickhouse_grpc.proto): ``ExecuteQuery(QueryInfo)
returns (Result)`` plus the three streaming variants.  The server speaks
the wire protocol itself, with no grpc or h2 package: HTTP/2 framing (RFC
7540), an HPACK decoder (RFC 7541: static and dynamic tables, integer and
string literals, Huffman-coded strings), and hand-rolled protobuf wire
coding for QueryInfo/Result.  One thread per connection; every statement
runs as the authenticated user through ``Session.sql_as``, under the
session's execution lock, which the HTTP, TCP, MySQL and PostgreSQL
servers of the session share.

The decoder keeps the dynamic table as RFC 7541 section 4 sizes it (name
+ value + 32 octets), evicts the oldest entries past the current size
limit, honours dynamic table size updates, and refuses an index past the
entries it holds (an evicted one too: section 2.3.3's decoding error).

Scope gates (documented, tested): routing treats every method as
collect-request / reply-Result, which is correct for ExecuteQuery and
WithStreamInput and a valid single-frame answer for the stream-output
variants; ``input_data`` compression and external tables are not
supported and answer with a Result.exception.
"""

from __future__ import annotations

import socketserver
import struct
import threading
from collections import deque

from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.wire import WireServer, recv_exact
from myscaledb_tpu_torch.sql.format import format_tsv

# ---------------------------------------------------------------------------
# protobuf wire helpers (proto3: varint=0, 64bit=1, len-delimited=2, 32bit=5)
# ---------------------------------------------------------------------------


def _uvarint(buf: bytes, i: int):
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _enc_uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(num: int, wire: int, payload: bytes) -> bytes:
    return _enc_uvarint((num << 3) | wire) + payload


def enc_str(num: int, s) -> bytes:
    b = s if isinstance(s, bytes) else str(s).encode()
    if not b:
        return b""
    return _enc_field(num, 2, _enc_uvarint(len(b)) + b)


def enc_varint_field(num: int, v: int) -> bytes:
    if not v:
        return b""
    return _enc_field(num, 0, _enc_uvarint(v))


def parse_message(buf: bytes) -> dict:
    """Generic proto3 parse: {field_number: [values]} — varints as int,
    len-delimited as bytes (callers decode strings/sub-messages)."""
    out: dict = {}
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _uvarint(buf, i)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _uvarint(buf, i)
        elif wire == 1:
            v = struct.unpack("<q", buf[i:i + 8])[0]
            i += 8
        elif wire == 2:
            ln, i = _uvarint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<i", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"bad wire type {wire}")
        out.setdefault(num, []).append(v)
    return out


def parse_query_info(buf: bytes) -> dict:
    """clickhouse_grpc.proto QueryInfo (field numbers from the .proto)."""
    f = parse_message(buf)

    def s(num, default=""):
        return f[num][-1].decode("utf-8", "replace") if num in f else default

    settings = {}
    for entry in f.get(3, ()):           # map<string,string> settings
        e = parse_message(entry)
        k = e.get(1, [b""])[-1].decode("utf-8", "replace")
        v = e.get(2, [b""])[-1].decode("utf-8", "replace")
        settings[k] = v
    return {
        "query": s(1), "query_id": s(2), "settings": settings,
        "database": s(4),
        "input_data": b"".join(f.get(5, ())),
        "output_format": s(7), "user_name": s(9), "password": s(10),
        "cancel": bool(f.get(15, [0])[-1]),
        "next_query_info": bool(f.get(16, [0])[-1]),
        "input_compression_type": s(20),
        "external_tables": f.get(8, ()),
        "send_output_columns": bool(f.get(24, [0])[-1]),
    }


def encode_result(output: bytes = b"", query_id: str = "",
                  output_format: str = "", columns=(),
                  exception=None) -> bytes:
    """clickhouse_grpc.proto Result: output=1, exception=7, query_id=9,
    output_format=11, output_columns=12 (NameAndType name=1 type=2)."""
    out = bytearray()
    out += enc_str(9, query_id)
    out += enc_str(11, output_format)
    for name, typ in columns:
        sub = enc_str(1, name) + enc_str(2, typ)
        out += _enc_field(12, 2, _enc_uvarint(len(sub)) + sub)
    out += enc_str(1, output)
    if exception is not None:
        code, name, text = exception
        sub = (enc_varint_field(1, code & 0xFFFFFFFF) + enc_str(2, name) +
               enc_str(3, text))
        out += _enc_field(7, 2, _enc_uvarint(len(sub)) + sub)
    return bytes(out)


# ---------------------------------------------------------------------------
# HPACK (RFC 7541): static and dynamic tables, Huffman-coded strings
# ---------------------------------------------------------------------------

_STATIC = [None,
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
    ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""), ("content-location", ""),
    ("content-range", ""), ("content-type", ""), ("cookie", ""), ("date", ""),
    ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", "")]


# Appendix B's Huffman code is canonical: the code length of each symbol
# (0..255, then EOS = 256), one letter each, 'A' = 5 bits, fixes it
_HUFFMAN_LENGTHS = (
    "ISXXXXXXXTZXXZXXXXXXXXZXXXXXXXXXBFFHIBDGFFDGDBBBAAABBBBBBBCDKBHF"
    "IBCCCCCCCCCCCCCCCCCCCCCCDCDIOIJBKABABABBBACCBBBABCBAABCCCCCKGJIX"
    "PRPPRRRSRSSSSSTSTTRSTSSSSQRSRSSTRQPRRSSQSRRTQRSSQQRQSRSSPRRRSRRS"
    "VVPORSRUVVVWWVTUOQVWWVWTQQVVXWWWPTPQRQQSRRUUTTVSVWVVWWWWWXWWWWWV"
    "Z")
HUFFMAN_EOS = 256
ENTRY_OVERHEAD = 32          # RFC 7541 section 4.1


def huffman_codes() -> dict:
    """{(bit length, code): symbol} of the canonical code: codes counted
    up in order of (length, symbol), shifted left where the length grows."""
    lens = [ord(c) - ord("A") + 5 for c in _HUFFMAN_LENGTHS]
    codes = {}
    code, prev = -1, min(lens)
    for sym in sorted(range(len(lens)), key=lambda s: (lens[s], s)):
        code = (code + 1) << (lens[sym] - prev)
        prev = lens[sym]
        codes[(lens[sym], code)] = sym
    return codes


_HUFFMAN = huffman_codes()


def huffman_decode(data: bytes) -> bytes:
    """Decode a Huffman-coded string literal (RFC 7541 section 5.2): EOS
    inside the string, or padding that is longer than 7 bits or not the
    EOS code's leading ones, is a decoding error."""
    out = bytearray()
    code = n = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            sym = _HUFFMAN.get((n, code))
            if sym is None:
                continue
            if sym == HUFFMAN_EOS:
                raise ValueError("HPACK: EOS inside a Huffman string")
            out.append(sym)
            code = n = 0
    if n > 7 or code != (1 << n) - 1:
        raise ValueError("HPACK: bad Huffman padding")
    return bytes(out)


_STATIC_BYTES = [None] + [(n.encode(), v.encode()) for n, v in _STATIC[1:]]


def _text(name: bytes, value: bytes) -> tuple[str, str]:
    return name.decode("utf-8", "replace"), value.decode("utf-8", "replace")


class HpackDecoder:
    """One connection's header decoder.  ``protocol_max`` is the
    SETTINGS_HEADER_TABLE_SIZE this side announced (HTTP/2's default,
    4096); the encoder may lower the table's limit below it with a
    dynamic table size update.  Entries are kept as the octets that were
    sent, so their sizes are the RFC's."""

    def __init__(self, protocol_max: int = 4096):
        self.protocol_max = protocol_max
        self.max_size = protocol_max
        self.size = 0
        self.dynamic: deque = deque()    # (name, value) octets, newest first

    def _entry(self, idx: int) -> tuple[bytes, bytes]:
        if idx < len(_STATIC_BYTES):
            e = _STATIC_BYTES[idx]
            if e is None:
                raise ValueError("HPACK index 0")
            return e
        d = idx - len(_STATIC_BYTES)
        if d >= len(self.dynamic):
            raise ValueError(f"HPACK index {idx} out of range "
                             f"({len(self.dynamic)} dynamic entries)")
        return self.dynamic[d]

    @staticmethod
    def entry_size(name: bytes, value: bytes) -> int:
        return len(name) + len(value) + ENTRY_OVERHEAD

    def _evict(self, limit: int) -> None:
        while self.dynamic and self.size > limit:
            self.size -= self.entry_size(*self.dynamic.pop())

    def _insert(self, name: bytes, value: bytes) -> None:
        """RFC 7541 section 4.4: evict until the entry fits; an entry
        larger than the whole table empties it and is not added."""
        size = self.entry_size(name, value)
        self._evict(self.max_size - size)
        if size <= self.max_size:
            self.dynamic.appendleft((name, value))
            self.size += size

    @staticmethod
    def _int(buf, i, prefix_bits):
        mask = (1 << prefix_bits) - 1
        v = buf[i] & mask
        i += 1
        if v < mask:
            return v, i
        shift = 0
        while True:
            b = buf[i]
            i += 1
            v += (b & 0x7F) << shift
            if not b & 0x80:
                return v, i
            shift += 7

    def _string(self, buf, i) -> tuple[bytes, int]:
        huff = bool(buf[i] & 0x80)
        ln, i = self._int(buf, i, 7)
        if i + ln > len(buf):
            raise ValueError("HPACK: string literal past the block's end")
        raw = bytes(buf[i:i + ln])
        return (huffman_decode(raw) if huff else raw), i + ln

    def _literal(self, buf, i, prefix_bits):
        idx, i = self._int(buf, i, prefix_bits)
        if idx:
            name = self._entry(idx)[0]
        else:
            name, i = self._string(buf, i)
        val, i = self._string(buf, i)
        return name, val, i

    def decode(self, buf: bytes) -> list:
        """Header block -> [(name, value)]."""
        out = []
        i = 0
        n = len(buf)
        while i < n:
            b = buf[i]
            if b & 0x80:                                 # indexed
                idx, i = self._int(buf, i, 7)
                out.append(_text(*self._entry(idx)))
            elif b & 0x40:                               # literal + indexing
                name, val, i = self._literal(buf, i, 6)
                self._insert(name, val)
                out.append(_text(name, val))
            elif b & 0x20:                               # table size update
                if out:
                    raise ValueError("HPACK: table size update after a "
                                     "header field")
                size, i = self._int(buf, i, 5)
                if size > self.protocol_max:
                    raise ValueError(f"HPACK: table size {size} above the "
                                     f"announced {self.protocol_max}")
                self.max_size = size
                self._evict(size)
            else:                                        # literal, no index
                name, val, i = self._literal(buf, i, 4)
                out.append(_text(name, val))
        return out


def hpack_encode(headers) -> bytes:
    """Literal-without-indexing, plain strings (always legal to send)."""
    out = bytearray()
    for name, val in headers:
        out.append(0x00)
        nb = name.encode()
        out.append(len(nb))              # < 127 always here
        out += nb
        vb = val.encode()
        if len(vb) < 127:
            out.append(len(vb))
        else:
            out.append(127)
            rest = len(vb) - 127
            while True:
                b = rest & 0x7F
                rest >>= 7
                out.append(b | 0x80 if rest else b)
                if not rest:
                    break
        out += vb
    return bytes(out)


# ---------------------------------------------------------------------------
# HTTP/2 frames
# ---------------------------------------------------------------------------

F_DATA, F_HEADERS, F_PRIORITY, F_RST, F_SETTINGS, F_PUSH, F_PING, \
    F_GOAWAY, F_WINDOW_UPDATE, F_CONTINUATION = range(10)
PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_ACK = 0x1
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20
COMPRESSION_ERROR = 0x9


def _read_frame(sock):
    hdr = recv_exact(sock, 9)
    ln = int.from_bytes(hdr[:3], "big")
    ftype, flags = hdr[3], hdr[4]
    sid = int.from_bytes(hdr[5:9], "big") & 0x7FFFFFFF
    return ftype, flags, sid, recv_exact(sock, ln) if ln else b""


def _frame(ftype: int, flags: int, sid: int, payload: bytes) -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags]) +
            sid.to_bytes(4, "big") + payload)


def grpc_frames(buf: bytes):
    """Split concatenated gRPC length-prefixed messages."""
    i = 0
    while i + 5 <= len(buf):
        compressed = buf[i]
        ln = int.from_bytes(buf[i + 1:i + 5], "big")
        yield compressed, buf[i + 5:i + 5 + ln]
        i += 5 + ln


def grpc_frame(msg: bytes) -> bytes:
    return b"\x00" + len(msg).to_bytes(4, "big") + msg


class _Stream:
    __slots__ = ("headers", "data", "hdr_buf", "hdr_flags", "ended")

    def __init__(self):
        self.headers = []
        self.data = bytearray()
        self.hdr_buf = bytearray()
        self.hdr_flags = 0
        self.ended = False


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        session = self.server.session
        try:
            if recv_exact(sock, len(PREFACE)) != PREFACE:
                return
            sock.sendall(_frame(F_SETTINGS, 0, 0, b""))
            dec = HpackDecoder()
            streams: dict = {}
            recv_window = 0
            while True:
                ftype, flags, sid, payload = _read_frame(sock)
                if ftype == F_SETTINGS:
                    if not flags & FLAG_ACK:
                        sock.sendall(_frame(F_SETTINGS, FLAG_ACK, 0, b""))
                    continue
                if ftype == F_PING:
                    if not flags & FLAG_ACK:
                        sock.sendall(_frame(F_PING, FLAG_ACK, 0, payload))
                    continue
                if ftype == F_GOAWAY:
                    return
                if ftype in (F_WINDOW_UPDATE, F_PRIORITY, F_RST):
                    continue
                st = streams.setdefault(sid, _Stream())
                if ftype in (F_HEADERS, F_CONTINUATION):
                    body = payload
                    if ftype == F_HEADERS:
                        if flags & FLAG_PADDED:
                            pad = body[0]
                            body = body[1:len(body) - pad]
                        if flags & FLAG_PRIORITY:
                            body = body[5:]
                        st.hdr_flags = flags
                    st.hdr_buf += body
                    if flags & FLAG_END_HEADERS:
                        try:
                            st.headers = dec.decode(bytes(st.hdr_buf))
                        except (ValueError, IndexError) as e:
                            # RFC 7540 section 4.3: a connection error
                            sock.sendall(_frame(F_GOAWAY, 0, 0, struct.pack(
                                ">II", sid, COMPRESSION_ERROR) +
                                str(e).encode()))
                            return
                        st.hdr_buf = bytearray()
                    if (st.hdr_flags & FLAG_END_STREAM) and \
                            (flags & FLAG_END_HEADERS):
                        st.ended = True
                elif ftype == F_DATA:
                    body = payload
                    if flags & FLAG_PADDED:
                        pad = body[0]
                        body = body[1:len(body) - pad]
                    st.data += body
                    recv_window += len(payload)
                    if recv_window > 32768:   # refill conn + stream windows
                        inc = recv_window.to_bytes(4, "big")
                        sock.sendall(_frame(F_WINDOW_UPDATE, 0, 0, inc) +
                                     _frame(F_WINDOW_UPDATE, 0, sid, inc))
                        recv_window = 0
                    if flags & FLAG_END_STREAM:
                        st.ended = True
                if sid and streams.get(sid) is st and st.ended:
                    self._respond(sock, session, sid, st)
                    del streams[sid]
        except (ConnectionError, OSError):
            pass

    def _respond(self, sock, session, sid: int, st: _Stream):
        infos = [parse_query_info(m) for _c, m in grpc_frames(bytes(st.data))]
        if not infos:
            infos = [parse_query_info(b"")]
        first = infos[0]
        qid = first["query_id"]
        fmt = first["output_format"] or "TabSeparated"
        try:
            user = session.access.authenticate(
                first["user_name"] or "default", first["password"] or None)
            if first["input_compression_type"] not in ("", "none"):
                raise ValueError("input_data compression is not supported")
            if first["external_tables"]:
                raise ValueError("external tables are not supported")
            sql = first["query"]
            input_data = b"".join(i["input_data"] for i in infos)
            if input_data and sql.strip().upper().startswith("INSERT"):
                # input_data is the INSERT body: compose the inline-data
                # form INSERT ... FORMAT fmt\n<rows> (GRPCServer.cpp feeds
                # input_data into the insert pipeline the same way)
                if " FORMAT " not in sql.upper():
                    sql = sql.rstrip() + " FORMAT TabSeparated"
                sql = sql.rstrip() + "\n" + \
                    input_data.decode("utf-8", "replace")
            result = session.sql_as(user, sql)
            if result is not None and getattr(result, "n_rows", None) \
                    is not None:
                body = format_tsv(result)
                output = (body + "\n" if body else "").encode()
                cols = [(f.name, str(f).split(" ", 1)[1])
                        for f in result.schema()
                        if not f.name.startswith("__")] \
                    if first["send_output_columns"] else []
            else:
                output, cols = b"", []
            msg = encode_result(output, qid, fmt, cols)
        except Exception as e:                           # noqa: BLE001
            M.increment("GRPCFailedQuery")
            msg = encode_result(b"", qid, fmt, (),
                                exception=(53, type(e).__name__,
                                           f"DB::Exception: {e}"))
        hdrs = hpack_encode([(":status", "200"),
                             ("content-type", "application/grpc")])
        trailers = hpack_encode([("grpc-status", "0"),
                                 ("grpc-message", "")])
        sock.sendall(
            _frame(F_HEADERS, FLAG_END_HEADERS, sid, hdrs) +
            _frame(F_DATA, 0, sid, grpc_frame(msg)) +
            _frame(F_HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM, sid,
                   trailers))


class GrpcServer(WireServer):
    def __init__(self, addr, session):
        self.session = session
        super().__init__(addr, _Handler)


def serve_grpc(session, host: str = "127.0.0.1", port: int = 9100
               ) -> GrpcServer:
    """Start the gRPC server on a daemon thread."""
    srv = GrpcServer((host, port), session)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
