"""Blocking request/response client (the reference Network::Client,
node/client.hpp:24-190): connect (TLS optional), write framed request, read
framed response. Supports keep-alive connection reuse.

The port's copy of cofhe_tpu/node/client.py.
"""

from __future__ import annotations

import socket
import ssl
import threading

from .wire import Request, Response, ServiceType


def make_client_ssl_context(verify_file: str | None = None) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if verify_file:
        ctx.load_verify_locations(verify_file)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_REQUIRED
    else:
        # reference uses verify_none (client.hpp:30-36)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


_DEFAULT_TIMEOUT = float(__import__("os").environ.get("COFHE_RPC_TIMEOUT",
                                                      "120"))


class Client:
    def __init__(self, host: str, port: int, ssl_context: ssl.SSLContext | None = None,
                 keep_alive: bool = True, timeout: float = _DEFAULT_TIMEOUT):
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self.keep_alive = keep_alive
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def _connect(self):
        raw = socket.create_connection((self.host, self.port), timeout=self.timeout)
        raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.ssl_context is not None:
            raw = self.ssl_context.wrap_socket(raw, server_hostname=self.host)
        self._sock = raw

    def _recv_exactly(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            chunk = self._sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionError("connection closed mid-response")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _recv_line(self) -> bytes:
        out = bytearray()
        while True:
            ch = self._sock.recv(1)
            if not ch:
                raise ConnectionError("connection closed mid-header")
            if ch == b"\n":
                return bytes(out)
            out += ch

    def run(self, request: Request) -> Response:
        """Send one request, wait for the response (client.hpp:49-61)."""
        with self._lock:
            attempts = 2 if self.keep_alive else 1
            for attempt in range(attempts):
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(request.to_bytes())
                    header = self._recv_line()
                    ver, service, status, size = Response.parse_header(header)
                    data = self._recv_exactly(size)
                    resp = Response(service, status, data, ver)
                    if not self.keep_alive:
                        self.close()
                    return resp
                except (ConnectionError, OSError, ssl.SSLError):
                    self.close()
                    if attempt == attempts - 1:
                        raise
            raise ConnectionError("unreachable")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def is_connected(self) -> bool:
        return self._sock is not None
