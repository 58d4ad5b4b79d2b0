"""Full float32 products around the port's device work.

The JAX package sets ``Precision.HIGHEST`` on each float32 product, so a host
application's precision setting cannot change its scores. torch instead
reads process-wide flags: under ``torch.set_float32_matmul_precision("high")``
or ``torch.backends.cuda.matmul.allow_tf32 = True`` cuBLAS and cuDNN round
float32 operands to TF32 (a 10-bit mantissa). :func:`full_f32` pins those
flags to full float32 for the length of a block and gives the caller's
values back after it, also when the block raises.

The flags are process-wide, so overlapping blocks on several threads share
one pin: the first to enter saves the caller's values and sets them, the
last to leave restores them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_depth = 0
_saved = None


def _snapshot():
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller mixed torch's legacy and new flag APIs
        precision = None
    return precision, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _apply(precision, matmul_tf32: bool, cudnn_tf32: bool) -> None:
    if precision is not None:
        torch.set_float32_matmul_precision(precision)
    # a legacy write that changes nothing would still mark the state as mixed
    if torch.backends.cuda.matmul.allow_tf32 != matmul_tf32:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    if torch.backends.cudnn.allow_tf32 != cudnn_tf32:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


@contextlib.contextmanager
def full_f32():
    """Run the block with TF32 off in cuBLAS and cuDNN and the float32
    matmul precision at ``"highest"``; restore the caller's flags after."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = _snapshot()
            _apply("highest", False, False)
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _apply(*_saved)
                _saved = None
