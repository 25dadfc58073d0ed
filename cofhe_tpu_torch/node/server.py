"""Async TLS server: the reference's boost::asio Server/Session
(node/server.hpp:30-229) re-done on asyncio.

Same loop shape: accept -> (TLS handshake) -> read_until('\n') header ->
read exactly `size` body bytes -> dispatch handler -> write response.
TLS uses a self-signed cert like the reference (server.pem / server_key.pem,
verify disabled — server.hpp:163-168); plaintext TCP is also supported for
in-process tests.

The port's copy of cofhe_tpu/node/server.py.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import ssl
import threading
from typing import Callable

from ..utils import trace
from .wire import Request, Response, ServiceType, Status

log = logging.getLogger("cofhe_tpu_torch.node")


def make_server_ssl_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


def generate_self_signed_cert(cert_path: str, key_path: str, cn: str = "localhost") -> None:
    """openssl-based self-signed cert generation (reference
    scripts/start_network.sh:3-5 does the same via the CLI)."""
    import subprocess

    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key_path,
         "-out", cert_path, "-days", "365", "-nodes", "-subj", f"/CN={cn}"],
        check=True, capture_output=True)


class Server:
    """Request/response server. `handler(request: Request) -> Response` runs
    in a thread pool (crypto work is CPU/GPU heavy), in a copy of the
    serving task's context. While tracing is on (utils/trace.py) each
    request is a `node.request` span from its body read to its response
    written, with the node's `role` and the service; the handler's spans
    are its children."""

    def __init__(self, host: str, port: int, handler: Callable[[Request], Response],
                 ssl_context: ssl.SSLContext | None = None, role: str = ""):
        self.host = host
        self.port = port
        self.handler = handler
        self.ssl_context = ssl_context
        self.role = role
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    header = await reader.readuntil(b"\n")
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                ver, service, size = Request.parse_header(header[:-1])
                body = await reader.readexactly(size)
                req = Request(service, body, ver)
                loop = asyncio.get_running_loop()
                with trace.span("node.request") as sp:
                    if sp:
                        sp.attrs.update(role=self.role, service=service.name)
                    try:
                        resp = await loop.run_in_executor(
                            None, contextvars.copy_context().run, self.handler, req)
                    except Exception as e:  # handler errors -> ERROR response
                        log.exception("handler error from %s", peer)
                        resp = Response(service, Status.ERROR, str(e).encode(), ver)
                    writer.write(resp.to_bytes())
                    await writer.drain()
        except Exception:
            log.exception("session error from %s", peer)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _serve(self):
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, ssl=self.ssl_context)
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def run_in_thread(self) -> None:
        """Start the server on a dedicated event-loop thread (the reference
        runs 8 io threads per server, server.hpp:185-197; asyncio multiplexes
        on one loop and offloads handlers to the executor)."""
        def runner():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._serve())
            except asyncio.CancelledError:
                pass
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=runner, daemon=True, name=f"cofhe-server-{self.port}")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("server failed to start")

    def run_forever(self) -> None:
        asyncio.run(self._serve())

    def stop(self) -> None:
        """Idempotent: stopping an already-stopped server (e.g. one killed
        mid-test to exercise elastic recovery) is a no-op."""
        if self._loop and self._server and not self._loop.is_closed():
            def _stop():
                self._server.close()
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()
            try:
                self._loop.call_soon_threadsafe(_stop)
            except RuntimeError:
                pass  # loop closed between the check and the call
        if self._thread:
            self._thread.join(timeout=5)
