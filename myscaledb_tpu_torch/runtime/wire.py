"""What the TCP, MySQL, PostgreSQL and gRPC servers share: a threading
TCP server whose connections send without Nagle's delay (each reply goes
out in one ``sendall``, so nothing waits on the peer's delayed ACK), and
an exact read from a socket."""

from __future__ import annotations

import socket
import socketserver


class WireServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def get_request(self):
        sock, addr = super().get_request()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock, addr


def recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)
