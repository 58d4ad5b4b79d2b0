"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into its own shared library at first use,
and loaded with ctypes. A library's file name carries a hash of the flags
and of every source it may be built from (the ``.cu`` and all
``csrc/*.cuh``), so a change to any of them builds a new one. Nothing is
linked beyond the CUDA runtime: a kernel that needs a driver function (TMA's
``cuTensorMapEncodeTiled``) reaches it through the runtime's driver entry
point (``cudaGetDriverEntryPoint``), not ``-lcuda``. From a checkout the
libraries go to ``build/torch_kernels/`` at the repository root; an installed package
builds into the user's cache (``$XDG_CACHE_HOME`` or ``~/.cache``) under
``hipporag_tpu_torch/kernels``. Nothing is built or imported when this
module is imported: the CPU installation has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")


def _build_dir() -> str:
    root = os.path.dirname(_PKG_DIR)
    if os.path.exists(os.path.join(root, "pyproject.toml")):  # a checkout
        return os.path.join(root, "build", "torch_kernels")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "hipporag_tpu_torch", "kernels")


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per kernel source: (seconds the nvcc build took, compiler output incl. ptxas -v)
build_info: dict[str, tuple[float, str]] = {}


class LaunchCounter:
    """Launch count of one kernel; wrappers call ``add`` once per launch.

    The orchestrator launches from worker threads, so the count is kept
    under a lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def add(self) -> None:
        with self._lock:
            self._count += 1

    def reset(self) -> None:
        with self._lock:
            self._count = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources(name: str) -> list[str]:
    """The files ``csrc/<name>.cu`` may be built from: itself and every header."""
    return [os.path.join(CSRC_DIR, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by a hash of
    the nvcc flags and the contents of its sources."""
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``; builds it on first use.

    Thread-safe: concurrent first calls build once. A library whose flags
    or sources changed is rebuilt.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        out = library_path(name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            start = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}{proc.stdout}")
            os.replace(tmp, out)
            build_info[name] = (time.perf_counter() - start, proc.stderr + proc.stdout)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib
