"""ctypes binding for the native HTTP front-end (``http_frontend.cpp``).

Builds the shared library on first use with ``make`` (the ``Makefile`` in
this directory) into ``build/http_frontend/``, named by a hash of its
sources (``utils/native_build``), and returns ``None`` if that fails, so
callers can fall back to the stdlib front-end.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from ...utils import native_build
from ...utils.logging import get_logger

logger = get_logger(__name__)

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("http_frontend.cpp", "Makefile")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library lives, keyed by a hash of its sources."""
    return native_build.library_path(_THIS_DIR, _SOURCES, "http_frontend")


def _build(out: str) -> None:
    native_build.make_library(_THIS_DIR, out)


def load() -> Optional[ctypes.CDLL]:
    """Build (if missing) and load the front-end library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not os.path.exists(out):
            try:
                _build(out)
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                logger.warning("native http front-end build failed (%s) %s", e,
                               detail.decode(errors="replace")[-2000:])
                return None
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            logger.warning("native http front-end load failed (%s)", e)
            return None

        lib.hf_start.restype = ctypes.c_void_p
        lib.hf_start.argtypes = [
            ctypes.c_char_p,  # host
            ctypes.c_int,  # port
            ctypes.c_int,  # backlog
            ctypes.c_long,  # max_body (large paths)
            ctypes.c_long,  # max_small_body (every other path)
            ctypes.c_char_p,  # comma-separated large-body paths
            ctypes.POINTER(ctypes.c_int),  # out: bound port
            ctypes.c_char_p,  # out: error buffer
            ctypes.c_int,  # error buffer len
        ]
        lib.hf_next.restype = ctypes.c_int
        lib.hf_next.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.hf_respond2.restype = ctypes.c_int
        lib.hf_respond2.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int,  # status
            ctypes.c_int,  # ctype: 0 json, 1 text/plain
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.hf_stop.restype = None
        lib.hf_stop.argtypes = [ctypes.c_void_p]
        lib.hf_destroy.restype = None
        lib.hf_destroy.argtypes = [ctypes.c_void_p]
        lib.hf_counters.restype = None
        lib.hf_counters.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint64)] * 4
        _lib = lib
        return _lib
