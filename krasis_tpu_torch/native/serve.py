"""ctypes bindings for the native C++ HTTP/SSE transport (``serve.cpp``).

The port of ``krasis_tpu/native/serve.py``. The native layer owns all
socket work on an epoll thread; Python worker threads pull parsed requests
and run the same route handlers as the stdlib transport
(``server.handle_request``). Token writes during streaming are buffered
try-sends in C: the generation loop never blocks on a client socket.

The library is built with g++ at first use (``native.build_library``).
``load`` raises when that fails; ``server._make_httpd`` decides what a
failure means for the chosen ``--server-backend``.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import threading
from pathlib import Path
from typing import Callable, Optional

from . import build_library

SRC = Path(__file__).resolve().parent / "serve.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_long, c_char_p = ctypes.c_int, ctypes.c_long, ctypes.c_char_p
    sig = {
        "ks_start": (c_int, [c_char_p, c_int]),
        "ks_port": (c_int, [c_int]),
        "ks_stop": (None, [c_int]),
        "ks_next": (c_long, [c_int, c_int, c_char_p, c_int, c_char_p, c_int,
                             ctypes.POINTER(c_long)]),
        "ks_copy_body": (c_int, [c_int, c_long, c_char_p, c_long]),
        "ks_respond": (c_int, [c_int, c_long, c_int, c_char_p, c_char_p, c_long]),
        "ks_stream_start": (c_int, [c_int, c_long]),
        "ks_stream_send": (c_int, [c_int, c_long, c_char_p, c_long]),
        "ks_stream_end": (c_int, [c_int, c_long]),
        "ks_cancelled": (c_int, [c_int, c_long]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load(build_dir=None) -> ctypes.CDLL:
    """The transport library, built on first use (into `build_dir` when
    given, else the port's build directory); raises if g++ fails."""
    global _lib
    if build_dir is not None:
        return _declare(build_library(SRC, "krasis_serve", FLAGS, build_dir))
    with _lock:
        if _lib is None:
            _lib = _declare(build_library(SRC, "krasis_serve", FLAGS))
        return _lib


class NativeResponseWriter:
    """server.py's writer protocol over the C API."""

    def __init__(self, srv: "NativeHTTPServer", req_id: int):
        self._srv = srv
        self._id = req_id
        self.streaming = False

    def send_json(self, code: int, body: bytes) -> None:
        self._srv._lib.ks_respond(self._srv._h, self._id, code, b"application/json", body,
                                  len(body))

    def sse_start(self) -> None:
        self.streaming = True
        self._srv._lib.ks_stream_start(self._srv._h, self._id)

    def sse_send(self, data: bytes) -> bool:
        return self._srv._lib.ks_stream_send(self._srv._h, self._id, data, len(data)) == 0

    def sse_end(self) -> None:
        self._srv._lib.ks_stream_end(self._srv._h, self._id)

    def cancelled(self) -> bool:
        return bool(self._srv._lib.ks_cancelled(self._srv._h, self._id))


class NativeHTTPServer:
    """Drop-in for ThreadingHTTPServer: the epoll C++ transport and a pool of
    Python workers running `handler(method, path, body, writer)`."""

    def __init__(self, host: str, port: int,
                 handler: Callable[[str, str, bytes, NativeResponseWriter], None],
                 workers: int = 32):
        # workers bound the requests in flight; the headroom keeps /health
        # answerable while a generation holds the engine lock
        self._lib = load()
        self._h = self._lib.ks_start(host.encode(), port)
        if self._h < 0:
            raise OSError(-self._h, f"{os.strerror(-self._h)}: {host}:{port}")
        self.port = self._lib.ks_port(self._h)
        self._handler = handler
        self._stop = threading.Event()
        self._closed = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(workers)]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        method = ctypes.create_string_buffer(16)
        path = ctypes.create_string_buffer(1024)
        blen = ctypes.c_long(0)
        while not self._stop.is_set():
            rid = self._lib.ks_next(self._h, 200, method, 16, path, 1024, ctypes.byref(blen))
            if rid < 0:
                return  # server stopping
            if rid == 0:
                continue
            body = b""
            if blen.value > 0:
                buf = ctypes.create_string_buffer(blen.value)
                if self._lib.ks_copy_body(self._h, rid, buf, blen.value) == 0:
                    body = buf.raw
            w = NativeResponseWriter(self, rid)
            try:
                self._handler(method.value.decode(), path.value.decode(), body, w)
            except Exception as e:  # a handler fault: answer 500, keep serving
                try:
                    if w.streaming:
                        # the SSE stream already started: a status line now
                        # would corrupt its framing, so end the stream
                        w.sse_end()
                    else:
                        w.send_json(500, json.dumps({"error": str(e)}).encode())
                except Exception as inner:   # noqa: BLE001 (the client may be gone)
                    print(f"native server: could not report {e!r}: {inner!r}", file=sys.stderr)

    def shutdown(self) -> None:
        # Join the workers BEFORE ks_stop: they poll ks_next with a 200 ms
        # timeout, and freeing the C server while a worker waits in it (or
        # is inside any ks_* call mid-handler) would be a use-after-free.
        # If a worker is stuck in a long generation past the timeout, leak
        # the C server rather than free it under a live ks_stream_send.
        self._stop.set()
        try:
            for t in self._threads:
                t.join(timeout=5)
            if any(t.is_alive() for t in self._threads):
                print("NativeHTTPServer.shutdown: worker still in a handler; leaking the "
                      "native server to stay memory-safe", file=sys.stderr)
                return
            self._lib.ks_stop(self._h)
        finally:
            self._closed.set()

    def serve_forever(self) -> None:
        # the transport runs on its own threads; park until shutdown has
        # stopped them (an interpreter that exits under a live C++ event
        # loop thread aborts)
        while not self._closed.wait(0.5):
            pass
