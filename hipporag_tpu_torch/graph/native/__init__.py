"""ctypes binding for the native graph core (``graph_core.cpp``).

The port's copy of the JAX package's C++ graph core: ``coo_compile``
(symmetrize + dedup-accumulate + dst-major sort), ``ppr_serial`` (the exact
float64 serial PPR, the prpack equivalent) and ``ell_pack`` (bucketed-ELL
packing). The library is built with ``make`` on first use into
``build/graph_core/``, named by a hash of its sources
(``utils/native_build``).

There is no hidden fallback: when the library does not build or load,
``native_available()`` is False and every function returns None, so a
caller names the solver it used instead (``evaluation/twiki.exact_rank_check``).
The port's builder and ``ops/pagerank.ell_from_coo`` keep their NumPy
paths, which the tests hold array for array to this library's results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from ...utils import native_build
from ...utils.logging import get_logger

logger = get_logger(__name__)

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("graph_core.cpp", "Makefile")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None


def library_path() -> str:
    """Where the library lives, keyed by a hash of its sources."""
    return native_build.library_path(_THIS_DIR, _SOURCES, "graph_core")


def _build(out: str) -> None:
    native_build.make_library(_THIS_DIR, out)


def _load() -> Optional[ctypes.CDLL]:
    """Build (if missing) and load the library once; None on failure, with
    the reason in ``build_error``."""
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        try:
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.SubprocessError) as e:
            detail = (getattr(e, "stderr", b"") or b"").decode(errors="replace")[-2000:]
            build_error = f"{e} {detail}".strip()
            logger.warning("native graph core unavailable: %s", build_error)
            return None

        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        ptr = ctypes.c_void_p
        lib.coo_compile.restype = ctypes.c_int64
        lib.coo_compile.argtypes = [
            i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int, ptr, ptr, ptr, ptr,
        ]
        lib.ppr_serial.restype = ctypes.c_int32
        lib.ppr_serial.argtypes = [
            i32p, i32p, f32p, ctypes.c_int64, f64p, ctypes.c_int32,
            f64p, ctypes.c_double, ctypes.c_int32, ctypes.c_double, f64p,
        ]
        lib.ell_pack.restype = ctypes.c_int32
        lib.ell_pack.argtypes = [
            i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.c_int32, ctypes.c_int32,
            ptr, ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int64,
            ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def coo_compile(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    num_nodes: int,
    normalize: bool = False,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Symmetrize + dedup + dst-major sort (+ optional normalization).

    Returns (src, dst, w, strength), or None when the library is absent.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    # each input entry makes at most two directed keys (a->b and b->a)
    cap = 2 * len(src)
    src_out = np.empty(cap, np.int32)
    dst_out = np.empty(cap, np.int32)
    w_out = np.empty(cap, np.float32)
    strength = np.zeros(num_nodes, np.float64)
    n = lib.coo_compile(src, dst, w, len(src), num_nodes, int(normalize),
                        _ptr(src_out), _ptr(dst_out), _ptr(w_out), _ptr(strength))
    return src_out[:n].copy(), dst_out[:n].copy(), w_out[:n].copy(), strength


def ppr_serial(
    src: np.ndarray,
    dst: np.ndarray,
    w_norm: np.ndarray,
    dangling: np.ndarray,
    num_nodes: int,
    reset: np.ndarray,
    damping: float = 0.5,
    max_iters: int = 200,
    tol: float = 1e-12,
) -> Optional[Tuple[np.ndarray, int]]:
    """Exact serial float64 PPR of one reset vector (host verifier).
    Returns (ranks, iterations), or None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(num_nodes, np.float64)
    iters = lib.ppr_serial(
        np.ascontiguousarray(src, np.int32),
        np.ascontiguousarray(dst, np.int32),
        np.ascontiguousarray(w_norm, np.float32),
        len(src),
        np.ascontiguousarray(dangling, np.float64),
        num_nodes,
        np.ascontiguousarray(reset, np.float64),
        damping,
        max_iters,
        tol,
        out,
    )
    return out, int(iters)


def ell_pack(
    src: np.ndarray,
    dst_sorted: np.ndarray,
    w_norm: np.ndarray,
    node_cap: int,
    widths,
    hub_width: int,
    row_multiple: int,
):
    """Bucketed-ELL packing of the real (weight != 0) dst-sorted edges.

    Returns (bucket_idx_list, bucket_wgt_list, hub_idx, hub_wgt, hub_seg,
    n_hub_cap, local_inv) in natural node ids, the arrays
    ``ops/pagerank.ell_from_coo`` builds before its slot remap; None when
    the library is absent or rejects an id.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst_sorted = np.ascontiguousarray(dst_sorted, np.int32)
    w_norm = np.ascontiguousarray(w_norm, np.float32)
    widths_arr = np.ascontiguousarray(widths, np.int32)
    n_widths = len(widths_arr)

    # pass 1: row counts
    bucket_rows = np.zeros(n_widths, np.int64)
    hub_rows = np.zeros(1, np.int64)
    hub_count = np.zeros(1, np.int64)
    if lib.ell_pack(src, dst_sorted, w_norm, len(src), node_cap, widths_arr, n_widths, hub_width,
                    _ptr(bucket_rows), _ptr(hub_rows), _ptr(hub_count),
                    None, 0, 0, None, None, None, None, None, None) != 0:
        return None

    def cap(n):
        return ((n + row_multiple - 1) // row_multiple) * row_multiple if n else 0

    bucket_caps = np.asarray([cap(int(r)) for r in bucket_rows], np.int64)
    hub_row_cap = cap(int(hub_rows[0]))
    n_hub = int(hub_count[0])
    n_hub_cap = ((n_hub + 127) // 128) * 128 if n_hub else 0

    # pass 2: fill zero-initialized buffers
    total_elems = int(sum(c * w for c, w in zip(bucket_caps, widths_arr)))
    idx_flat = np.zeros(total_elems, np.int32)
    wgt_flat = np.zeros(total_elems, np.float32)
    hub_idx = np.zeros((hub_row_cap, hub_width), np.int32)
    hub_wgt = np.zeros((hub_row_cap, hub_width), np.float32)
    hub_seg = np.full(hub_row_cap, n_hub_cap, np.int32)
    local_inv = np.zeros(node_cap, np.int32)
    if lib.ell_pack(src, dst_sorted, w_norm, len(src), node_cap, widths_arr, n_widths, hub_width,
                    _ptr(bucket_rows), _ptr(hub_rows), _ptr(hub_count),
                    _ptr(bucket_caps), hub_row_cap, n_hub_cap,
                    _ptr(idx_flat), _ptr(wgt_flat), _ptr(hub_idx), _ptr(hub_wgt),
                    _ptr(hub_seg), _ptr(local_inv)) != 0:
        return None

    bucket_idx, bucket_wgt = [], []
    off = 0
    for c, w in zip(bucket_caps, widths_arr):
        n_el = int(c) * int(w)
        bucket_idx.append(idx_flat[off:off + n_el].reshape(int(c), int(w)))
        bucket_wgt.append(wgt_flat[off:off + n_el].reshape(int(c), int(w)))
        off += n_el
    return bucket_idx, bucket_wgt, hub_idx, hub_wgt, hub_seg, n_hub_cap, local_inv
