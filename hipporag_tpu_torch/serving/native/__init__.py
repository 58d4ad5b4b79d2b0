"""ctypes binding for the native HTTP front-end (``http_frontend.cpp``).

Builds the shared library on first use with ``make`` (the ``Makefile`` in
this directory) and returns ``None`` if that fails, so callers can fall
back to the stdlib front-end. The library goes to ``build/http_frontend/``
at the repository root (an installed package: the user's cache), never
into the source tree; its file name carries a hash of the source and the
Makefile, so an edited source builds a new one. Each builder writes its own
temporary file and renames it into place, so concurrent builders never
load a partly written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from ...utils.logging import get_logger

logger = get_logger(__name__)

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("http_frontend.cpp", "Makefile")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(_THIS_DIR)))
    if os.path.exists(os.path.join(root, "pyproject.toml")):  # a checkout
        return os.path.join(root, "build", "http_frontend")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "hipporag_tpu_torch", "http_frontend")


def library_path() -> str:
    """Where the library lives, keyed by a hash of its sources."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_THIS_DIR, name), "rb") as fh:
            digest.update(name.encode() + b"\0" + fh.read())
    return os.path.join(_build_dir(), f"libhttp_frontend-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-s", f"OUT={tmp}", tmp],
            cwd=_THIS_DIR, check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


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
