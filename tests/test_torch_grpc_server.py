"""The port's gRPC server against the JAX package's, on the CPU, and the
port's HPACK decoder against RFC 7541.

Both servers answer the same calls (a SELECT, output columns, an INSERT
through input_data, an error in Result.exception, a refused user) with the
same Result bytes and trailers.  The port's decoder replays RFC 7541
Appendix C.5 (three responses, a 256-octet table) with the RFC's headers
and table sizes 222, 222 and 215 octets, and refuses an index into an
evicted entry (section 2.3.3); the JAX decoder, which never evicts, keeps
all eight entries and answers that index from a stale one (ROADMAP
section 3).  Appendix C.6 (the same responses Huffman-coded) decodes too,
and Huffman strings round-trip over every octet value.  After
tests/test_grpc_server.py."""

import socket

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.runtime.grpc_server import HpackDecoder as JaxDecoder
from myscaledb_tpu.runtime.grpc_server import serve_grpc as j_serve
from myscaledb_tpu_torch.runtime import grpc_server as G
from tools.wire_clients import grpc_call, query_info

C5 = ["4803333032580770726976617465611d4d6f6e2c203231204f637420323031332032"
      "303a31333a323120474d546e1768747470733a2f2f7777772e6578616d706c652e63"
      "6f6d",
      "4803333037c1c0bf",
      "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d54c0"
      "5a04677a697077386" "66f6f3d4153444a4b48514b425a584f5157454f5049554158"
      "5157454f49553b206d61782d6167653d333630303b2076657273696f6e3d31"]
C6 = ["488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d1b"
      "ff6e919d29ad171863c78f0b97c8e9ae82ae43d3",
      "4883640effc1c0bf"]
DATE1 = "Mon, 21 Oct 2013 20:13:21 GMT"
LOC = "https://www.example.com"
C5_HEADERS = [
    [(":status", "302"), ("cache-control", "private"), ("date", DATE1),
     ("location", LOC)],
    [(":status", "307"), ("cache-control", "private"), ("date", DATE1),
     ("location", LOC)],
    [(":status", "200"), ("cache-control", "private"),
     ("date", "Mon, 21 Oct 2013 20:13:22 GMT"), ("location", LOC),
     ("content-encoding", "gzip"),
     ("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; "
                    "version=1")]]


def test_rfc7541_c5_sizes_and_eviction():
    dec = G.HpackDecoder()
    # the RFC's encoder announced a 256-octet table first
    assert dec.decode(bytes([0x3F, 0xE1, 0x01])) == []
    assert dec.max_size == 256
    jdec = JaxDecoder()
    for block, want, size in zip(C5, C5_HEADERS, (222, 222, 215)):
        assert dec.decode(bytes.fromhex(block)) == want
        assert dec.size == size == sum(dec.entry_size(*e)
                                       for e in dec.dynamic)
        assert jdec.decode(bytes.fromhex(block)) == want
    assert [(n.decode(), v.decode()) for n, v in dec.dynamic] == [
        C5_HEADERS[2][5], C5_HEADERS[2][4], C5_HEADERS[2][2]]
    # index 65 was evicted: a decoding error in the port; the JAX table
    # kept all 8 entries and answers it from an evicted one
    assert len(jdec.dynamic) == 8
    assert jdec.decode(bytes([0x80 | 65])) == [C5_HEADERS[1][0]]
    with pytest.raises(ValueError, match="out of range"):
        dec.decode(bytes([0x80 | 65]))
    assert dec.decode(bytes([0x80 | 64])) == [C5_HEADERS[2][2]]


def test_rfc7541_c6_huffman():
    dec = G.HpackDecoder(256)
    dec.max_size = 256
    for block, want in zip(C6, C5_HEADERS):
        assert dec.decode(bytes.fromhex(block)) == want
        assert dec.size == 222


def test_table_size_updates():
    dec = G.HpackDecoder()
    dec.decode(bytes.fromhex(C5[0]))
    assert dec.size == 222
    assert dec.decode(bytes([0x20])) == []           # size 0 empties it
    assert dec.size == 0 and not dec.dynamic
    with pytest.raises(ValueError, match="out of range"):
        dec.decode(bytes([0x80 | 62]))
    with pytest.raises(ValueError, match="above the announced"):
        dec.decode(bytes([0x3F, 0xE2, 0x1F]))        # 4097
    with pytest.raises(ValueError, match="after a header field"):
        dec.decode(bytes([0x82, 0x20]))
    # an entry larger than the table empties it and is not added
    dec = G.HpackDecoder(64)
    dec.decode(bytes([0x40, 1]) + b"a" + bytes([1]) + b"b")
    assert dec.size == 34
    dec.decode(bytes([0x40, 1]) + b"a" + bytes([40]) + b"x" * 40)
    assert dec.size == 0 and not dec.dynamic


def _huffman_encode(raw: bytes) -> bytes:
    code_of = {s: (c, n) for (n, c), s in G._HUFFMAN.items()}
    bits, nbits = 0, 0
    for b in raw:
        c, n = code_of[b]
        bits, nbits = (bits << n) | c, nbits + n
    pad = -nbits % 8
    bits, nbits = (bits << pad) | ((1 << pad) - 1), nbits + pad
    return bits.to_bytes(nbits // 8, "big")


def test_huffman_round_trip_and_errors():
    raw = bytes(range(256)) * 2 + b"www.example.com"
    assert G.huffman_decode(_huffman_encode(raw)) == raw
    assert _huffman_encode(b"www.example.com").hex() == \
        "f1e3c2e5f23a6ba0ab90f4ff"
    with pytest.raises(ValueError, match="padding"):
        G.huffman_decode(_huffman_encode(b"a") + b"\xff")   # 8+ bits
    with pytest.raises(ValueError, match="padding"):
        G.huffman_decode(b"\x00")                           # '0', then 0s


@pytest.fixture(scope="module")
def ports():
    out = []
    for mod, serve, kw in ((myscaledb_tpu, j_serve, {}),
                           (myscaledb_tpu_torch, G.serve_grpc,
                            {"device": "cpu"})):
        s = mod.connect(**kw)
        s.sql("CREATE TABLE gt (a Int32, b String) ENGINE = Memory")
        s.sql("INSERT INTO gt VALUES (1, 'x'), (2, 'y')")
        s.create_table("v", {"id": np.arange(50, dtype=np.int64),
                             "e": np.random.default_rng(0).standard_normal(
                                 (50, 4)).astype(np.float32)})
        srv = serve(s, port=0)
        out.append(srv[0] if isinstance(srv, tuple) else srv)
    yield [srv.server_address[1] for srv in out]
    for srv in out:
        srv.shutdown()
        srv.server_close()


CALLS = [
    [query_info("SELECT 1+2")],
    [query_info("SELECT a, b FROM gt ORDER BY a", send_output_columns=True,
                query_id="q7")],
    [query_info("SELECT id, distance(e, [0.1, 0.2, 0.3, 0.4]) AS d FROM v "
                "ORDER BY d LIMIT 3", output_format="TabSeparated")],
    [query_info("SELECT no_such_col FROM gt")],
    [query_info("SELECT 1", user_name="nosuchuser", password="nope")],
    [query_info("INSERT INTO gt", input_data=b"7\tseven\n8\teight\n"),
     query_info("", input_data=b"9\tnine\n")],
    [query_info("SELECT count(), max(a) FROM gt")],
]


@pytest.mark.parametrize("call", range(len(CALLS)))
def test_results_equal_the_jax_server(ports, call):
    got = [grpc_call(p, CALLS[call]) for p in ports]
    assert got[1] == got[0]
    results, headers, trailers = got[1]
    assert headers[":status"] == "200" and trailers["grpc-status"] == "0"
    assert len(results) == 1


def test_result_fields(ports):
    (r,), _h, _t = grpc_call(ports[1], [query_info(
        "SELECT a, b FROM gt WHERE a < 3 ORDER BY a",
        send_output_columns=True)])
    msg = G.parse_message(r)
    assert msg[1][-1] == b"1\tx\n2\ty\n"
    cols = [G.parse_message(c) for c in msg[12]]
    assert [c[1][-1] for c in cols] == [b"a", b"b"]
    assert cols[0][2][-1] == b"Int32"
    (r,), _h, _t = grpc_call(ports[1], [query_info("SELECT nope FROM gt")])
    assert b"DB::Exception" in G.parse_message(
        G.parse_message(r)[7][-1])[3][-1]


def test_huffman_indexed_request_headers(ports):
    """A client that Huffman-codes its headers and indexes them (as grpc
    libraries do) is answered; an index past its table ends the connection
    with GOAWAY(COMPRESSION_ERROR)."""
    ua = _huffman_encode(b"grpc-python/1.76.0 grpc-c/51.0.0 (linux)")
    hdr = bytes([0x40 | 58, 0x80 | len(ua)]) + ua + bytes([0x80 | 62])
    (r,), _h, _t = grpc_call(ports[1], [query_info("SELECT 42")],
                             extra_headers=())
    assert G.parse_message(r)[1][-1] == b"42\n"
    for extra, ok in ((hdr, True), (bytes([0x80 | 70]), False)):
        s = socket.create_connection(("127.0.0.1", ports[1]), timeout=10)
        try:
            s.sendall(G.PREFACE + G._frame(G.F_SETTINGS, 0, 0, b""))
            block = G.hpack_encode([(":method", "POST"),
                                    (":path", "/x")]) + extra
            s.sendall(G._frame(G.F_HEADERS, G.FLAG_END_HEADERS, 1, block))
            s.sendall(G._frame(G.F_DATA, G.FLAG_END_STREAM, 1,
                               G.grpc_frame(query_info("SELECT 42"))))
            seen = []
            while True:
                ftype, flags, sid, payload = G._read_frame(s)
                seen.append(ftype)
                if ftype == G.F_GOAWAY:
                    assert payload[4:8] == bytes([0, 0, 0, 9])
                    break
                if ftype == G.F_HEADERS and flags & G.FLAG_END_STREAM:
                    break
            assert (G.F_DATA in seen) == ok and (G.F_GOAWAY in seen) != ok
        finally:
            s.close()
