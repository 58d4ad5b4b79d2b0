"""Peaks of one NVIDIA H100 SXM and the least work of each retrieval stage.

Every count comes from the inputs' shapes (and, for PageRank, from the
iterations the plain reference needs), never from which kernel ran, so a
kernel that replaces another reads the same work. A stage's least time is
the larger of its FLOPs over the peak of its precision and its bytes over
the memory bandwidth; each input byte is counted read once and each output
byte written once.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit. The
configurations state float32 with TF32 off; their products are counted
against the TF32 peak, which no exact float32 implementation can beat.
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
F32 = 4
I64 = 8


def least_s(flops: float, nbytes: float, precision: str = "tf32") -> float:
    return max(flops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


def dense_scores(b: int, n: int, d: int):
    """Scores of b queries against n keys of width d: (flops, bytes)."""
    return 2.0 * b * n * d, F32 * (n * d + b * d + b * n)


def k1_pass_a(b: int, n: int, d: int, tile: int = 128):
    """The fused scan: keys and queries read once, each tile's max and min
    of every query written."""
    return 2.0 * b * n * d, F32 * (n * d + b * d + 2 * b * math.ceil(n / tile))


def fact_topk(b: int, n: int, d: int, k: int):
    """Normalized top-k over n facts, fused: keys and queries read once,
    k values and indices written."""
    return 2.0 * b * n * d, F32 * (n * d + b * d) + (F32 + I64) * b * k


def topk(b: int, n: int, k: int):
    """Top-k of a [b, n] float32 matrix."""
    return 0.0, F32 * b * n + (F32 + I64) * b * k


def seeds(b: int, nodes: int, passages: int):
    """Reset vectors: the [b, passages] dense scores read, [b, nodes] written."""
    return 0.0, F32 * b * (passages + nodes)


def ppr(entries: int, nodes: int, b: int, iterations: int):
    """Power iterations: per iteration each graph entry (index and weight)
    and each column of p read once, p_next written once."""
    per_iter_bytes = (F32 + F32) * entries + 2 * F32 * nodes * b
    return 2.0 * entries * b * iterations, per_iter_bytes * iterations


def passage_scores(b: int, passages: int):
    """PageRank mass at the passage nodes and the dense fallback read, the
    scores written."""
    return float(b * passages), 3 * F32 * b * passages

