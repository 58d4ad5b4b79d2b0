"""Build the port's ctypes libraries (C++ sources with a ``Makefile``).

A library goes to ``build/<name>/`` at the repository root (an installed
package: the user's cache), never into the source tree. Its file name
carries a hash of its sources, so an edited source builds a new one. Each
builder writes its own temporary file and renames it into place, so
concurrent builders never load a partly written library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_dir(name: str) -> str:
    if os.path.exists(os.path.join(_ROOT, "pyproject.toml")):  # a checkout
        return os.path.join(_ROOT, "build", name)
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "hipporag_tpu_torch", name)


def library_path(src_dir: str, sources, name: str) -> str:
    """Where ``lib<name>`` lives, keyed by a hash of ``sources`` in ``src_dir``."""
    digest = hashlib.sha256()
    for source in sources:
        with open(os.path.join(src_dir, source), "rb") as fh:
            digest.update(source.encode() + b"\0" + fh.read())
    return os.path.join(build_dir(name), f"lib{name}-{digest.hexdigest()[:16]}.so")


def make_library(src_dir: str, out: str) -> None:
    """Run the ``Makefile`` in ``src_dir`` with ``OUT`` set; raises
    ``OSError`` or ``subprocess.SubprocessError`` when the build fails."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-s", f"OUT={tmp}", tmp],
            cwd=src_dir, check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
