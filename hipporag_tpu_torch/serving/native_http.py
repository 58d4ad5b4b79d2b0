"""Native (C++ epoll) HTTP front-end for :class:`RetrievalService`.

Drop-in alternative to the stdlib front-end in ``http_server.py`` with
the same server surface (``server_address`` / ``serve_forever`` /
``shutdown`` / ``server_close``) and the same wire contract (both feed
:func:`hipporag_tpu_torch.serving.routes.dispatch`).

Why it exists: at many concurrent clients the stdlib thread-per-connection
server spends the host's cores on Python socket handling and HTTP parsing.
Here all socket I/O and HTTP parsing run on one C++ epoll thread outside
the GIL (``native/http_frontend.cpp``); a pool of Python worker
threads pulls fully parsed requests via ctypes (which releases the GIL
around the blocking dequeue), runs the shared dispatcher — whose real
work is waiting on micro-batcher futures — and pushes JSON responses
back to the loop.

Use :func:`make_native_server`, or ``python -m hipporag_tpu_torch --serve
--serve_frontend native``. Falls back with a clear error if the C++
toolchain is absent (callers can catch and use the stdlib front-end).
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import Optional, Tuple

from ..utils.logging import get_logger
from .native import load as _load_lib
from .routes import MAX_BODY_BYTES, MAX_INDEX_BODY_BYTES, dispatch

logger = get_logger(__name__)

__all__ = ["NativeHTTPServer", "make_native_server"]

_POLL_MS = 250  # worker dequeue timeout; bounds shutdown latency


class NativeHTTPServer:
    """Mirrors the ``ThreadingHTTPServer`` lifecycle used by
    ``serve_forever()`` in ``http_server.py``:

    - construction binds + listens (and starts the C++ event loop, which
      accepts and parses immediately; requests queue until workers start)
    - :meth:`serve_forever` starts the worker pool and blocks
    - :meth:`shutdown` stops accepting, drains in-flight requests, and
      unblocks :meth:`serve_forever`
    - :meth:`server_close` tears the event loop down
    """

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 8734,
        *,
        num_workers: int = 128,
        request_timeout_s: Optional[float] = 120.0,
        backlog: int = 128,
        max_body_bytes: int = MAX_INDEX_BODY_BYTES,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(
                "native HTTP front-end unavailable (C++ toolchain missing?); "
                "use hipporag_tpu_torch.serving.http_server.make_server instead"
            )
        self._lib = lib
        self._service = service
        self._num_workers = int(num_workers)
        self._request_timeout_s = request_timeout_s
        out_port = ctypes.c_int(0)
        err = ctypes.create_string_buffer(256)
        # Per-path body caps are enforced in C++ at header-parse time so a
        # /retrieve can never make the event loop buffer an /index-sized
        # body it would reject anyway (mirrors the stdlib pre-read guard).
        handle = lib.hf_start(
            host.encode(), int(port), int(backlog), int(max_body_bytes),
            int(MAX_BODY_BYTES), b"/index,/delete",
            ctypes.byref(out_port), err, len(err),
        )
        if not handle:
            raise OSError(
                f"native HTTP front-end failed to bind {host}:{port}: "
                f"{err.value.decode(errors='replace')}"
            )
        self._handle = ctypes.c_void_p(handle)
        self._host = host
        self._port = out_port.value
        self._workers: list = []
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._started = False
        self._closed = False

    # ------------------------------------------------------------ surface
    @property
    def server_address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    def serve_forever(self) -> None:
        """Start the worker pool and block until :meth:`shutdown`."""
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if not self._started:
                self._started = True
                for i in range(self._num_workers):
                    t = threading.Thread(
                        target=self._worker, name=f"native-http-{i}", daemon=False
                    )
                    t.start()
                    self._workers.append(t)
        self._done.wait()
        for t in self._workers:
            t.join()

    def shutdown(self) -> None:
        """Stop accepting; workers drain parsed requests then exit.

        Every hf_* call on the handle happens under ``self._lock``, and
        :meth:`server_close` nulls the handle under the same lock before
        freeing it — so a SIGTERM-thread ``shutdown()`` racing the main
        thread's ``server_close()`` can never touch freed memory."""
        with self._lock:
            if self._handle:
                self._lib.hf_stop(self._handle)
        self._done.set()

    def server_close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._handle:
                self._lib.hf_stop(self._handle)
        self._done.set()
        # join OUTSIDE the lock (workers never take it) so a stuck worker
        # can't deadlock a concurrent shutdown() call
        for t in self._workers:
            if t is not threading.current_thread():
                t.join()
        with self._lock:
            handle, self._handle = self._handle, None
        if handle:
            self._lib.hf_destroy(handle)

    def counters(self) -> dict:
        """Event-loop counters (accepted conns, parsed requests, responses
        written, protocol errors answered in C++)."""
        vals = [ctypes.c_uint64(0) for _ in range(4)]
        with self._lock:
            if self._handle:
                self._lib.hf_counters(
                    self._handle, *[ctypes.byref(v) for v in vals]
                )
        keys = ("accepted", "parsed", "responded", "protocol_errors")
        return dict(zip(keys, (v.value for v in vals)))

    # ------------------------------------------------------------ workers
    def _worker(self) -> None:
        lib = self._lib
        rid = ctypes.c_uint64(0)
        method = ctypes.c_char_p()
        path = ctypes.c_char_p()
        body_ptr = ctypes.c_void_p()
        body_len = ctypes.c_long(0)
        while True:
            handle = self._handle
            if handle is None:
                return
            rc = lib.hf_next(
                handle, _POLL_MS, ctypes.byref(rid), ctypes.byref(method),
                ctypes.byref(path), ctypes.byref(body_ptr), ctypes.byref(body_len),
            )
            if rc < 0:
                return  # stopped and drained
            if rc == 0:
                continue  # timeout — re-check liveness
            # Copy out of C++-owned memory BEFORE responding (hf_respond
            # frees the request record).
            m = (method.value or b"").decode("latin-1")
            p = (path.value or b"").decode("latin-1")
            body = (
                ctypes.string_at(body_ptr, body_len.value)
                if body_len.value > 0
                else b""
            )
            ctype = 0  # application/json
            try:
                # HEAD runs the GET-shaped dispatch for the real status and
                # Content-Length (same as the stdlib front-end's do_HEAD);
                # the C++ loop suppresses the body bytes on the wire.
                status, payload = dispatch(
                    self._service, "GET" if m == "HEAD" else m, p, body,
                    self._request_timeout_s,
                )
                if isinstance(payload, str):  # pre-rendered text (/metrics)
                    wire = payload.encode("utf-8")
                    ctype = 1
                else:
                    wire = json.dumps(payload).encode("utf-8")
            except Exception as exc:  # noqa: BLE001 — keep the worker alive
                logger.exception("native http dispatch failed")
                status = 500
                wire = json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"}
                ).encode("utf-8")
            lib.hf_respond2(handle, rid, status, ctype, wire, len(wire))


def make_native_server(
    service,
    host: str = "127.0.0.1",
    port: int = 8734,
    request_timeout_s: Optional[float] = 120.0,
    num_workers: int = 128,
) -> NativeHTTPServer:
    """Build (but don't start) the native server — the counterpart of
    ``http_server.make_server``. ``port=0`` picks a free port; read it
    back from ``server.server_address[1]``."""
    return NativeHTTPServer(
        service,
        host,
        port,
        num_workers=num_workers,
        request_timeout_s=request_timeout_s,
    )
