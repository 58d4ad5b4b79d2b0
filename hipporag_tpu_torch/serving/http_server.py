"""Stdlib HTTP front-end for :class:`RetrievalService`.

``http.server.ThreadingHTTPServer`` so it runs in any deployment image —
each connection gets a handler thread, the handler blocks on the service
Future, and the micro-batcher does the real concurrency work of merging
those threads into device batches. Routing/validation/status mapping
live in :mod:`.routes` (shared with the native C++ front-end in
:mod:`.native_http`); see that module for the endpoint contract.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..utils.logging import get_logger
from .routes import body_limit, dispatch, solution_to_json  # noqa: F401 — re-export
from .service import RetrievalService

logger = get_logger(__name__)

__all__ = ["solution_to_json", "make_server", "serve_forever"]


class _Handler(BaseHTTPRequestHandler):
    # set by make_server()
    service: RetrievalService = None  # type: ignore[assignment]
    request_timeout_s: Optional[float] = None

    # silence the default stderr-per-request log; route to our logger
    def log_message(self, fmt: str, *args: Any) -> None:  # noqa: A003
        logger.debug("http %s", fmt % args)

    def _send(self, code: int, payload, head_only: bool = False) -> None:
        # a str payload is pre-rendered text (Prometheus /metrics);
        # everything else on this server speaks JSON
        if isinstance(payload, str):
            body = payload.encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            body = json.dumps(payload).encode("utf-8")
            ctype = "application/json"
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if not head_only:
            self.wfile.write(body)

    def _dispatch(self, body: bytes) -> None:
        code, payload = dispatch(
            self.service, self.command, self.path, body, self.request_timeout_s
        )
        self._send(code, payload)

    def do_GET(self) -> None:  # noqa: N802 — stdlib naming
        self._dispatch(b"")

    def do_HEAD(self) -> None:  # noqa: N802 — stdlib naming
        # HTTP/1.1: HEAD responses carry headers only. Run the GET-shaped
        # dispatch to get the real status + Content-Length, then suppress
        # the body so keep-alive clients/proxy health probes stay in sync.
        # A HEAD request may itself declare a body (unusual but legal) —
        # drain it, or its bytes are parsed as the next request line.
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._send(400, {"error": "invalid Content-Length"})
            return
        if length > body_limit(self.path):
            self._send(413, {"error": "body too large"})
            return
        if length > 0:
            self.rfile.read(length)
        code, payload = dispatch(
            self.service, "GET", self.path, b"", self.request_timeout_s
        )
        self._send(code, payload, head_only=True)

    def do_POST(self) -> None:  # noqa: N802 — stdlib naming
        # Body-size guard BEFORE buffering (dispatch re-checks length):
        # a /retrieve must not make the handler read a 64 MiB body.
        # 413 matches the native front-end's header-parse-time rejection.
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._send(400, {"error": "invalid Content-Length"})
            return
        if length > body_limit(self.path):
            self._send(413, {"error": "body too large"})
            return
        body = self.rfile.read(length) if length > 0 else b""
        self._dispatch(body)

    # Other methods go through the same body-draining path and dispatch,
    # for the same JSON 405 the native front-end returns (instead of
    # stdlib's HTML 501 page). dispatch keys on self.command.
    do_PUT = do_POST  # noqa: N815 — stdlib naming
    do_DELETE = do_POST  # noqa: N815
    do_PATCH = do_POST  # noqa: N815


def make_server(
    service: RetrievalService,
    host: str = "127.0.0.1",
    port: int = 8734,
    request_timeout_s: Optional[float] = 120.0,
) -> ThreadingHTTPServer:
    """Build (but don't start) the threaded HTTP server. ``port=0`` picks
    a free port — read it back from ``server.server_address[1]``."""
    handler = type(
        "BoundHandler",
        (_Handler,),
        {"service": service, "request_timeout_s": request_timeout_s},
    )
    # request_queue_size is the LISTEN BACKLOG and stdlib defaults it to
    # 5 — a 16-client closed-loop burst can already get connection
    # resets. It's read during server_bind, so it must be a class
    # attribute before construction.
    server_cls = type(
        "BoundServer", (ThreadingHTTPServer,), {"request_queue_size": 128}
    )
    server = server_cls((host, port), handler)
    # non-daemon handler threads: server_close() then JOINS in-flight
    # handlers, so a graceful shutdown finishes writing every response
    # instead of the interpreter killing handlers mid-write. Stuck
    # handlers are bounded by request_timeout_s on the service futures.
    server.daemon_threads = False
    return server


def serve_forever(
    service: RetrievalService,
    host: str = "127.0.0.1",
    port: int = 8734,
    server: Optional[Any] = None,
) -> None:
    """Blocking entry point used by ``python -m hipporag_tpu_torch --serve``.

    SIGTERM (the orchestrator's stop signal) and Ctrl-C both drain
    gracefully: stop accepting connections, finish queued batches
    (MicroBatcher.close drains), then return. Pass ``server`` to run a
    pre-built front-end (e.g. the native one) under the same signal
    handling; it must expose serve_forever/shutdown/server_close."""
    import signal
    import threading

    if server is None:
        server = make_server(service, host, port)
    addr = server.server_address
    logger.info("serving on http://%s:%d (POST /retrieve, /qa)", addr[0], addr[1])

    def _term(signum, frame):  # pragma: no cover — signal path
        logger.info("signal %d: draining and shutting down", signum)
        # shutdown() blocks until serve_forever returns — call it off
        # the signal frame so the main thread can unwind
        threading.Thread(target=server.shutdown, daemon=True).start()

    prev = None
    try:
        try:
            prev = signal.signal(signal.SIGTERM, _term)
        except ValueError:  # not the main thread — serve without the hook
            pass
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover — interactive shutdown
        pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        server.server_close()
        service.close()
