"""Batched dense scoring (PyTorch port of ``hipporag_tpu/ops/scoring.py``).

Query-by-key similarity matrices in float32 at full precision, row-wise
min-max normalization over the valid columns, and top-k with the tie order
of ``lax.top_k`` (the lower index first). ``fact_topk`` routes to the
streamed fused kernel (``ops/fused_topk.py``) on CUDA, with the reference's
bf16 query rounding where the reference would not have taken its kernel.
"""

from __future__ import annotations

import torch

# padded query-batch sizes below a bucket, as in the JAX package: a bounded
# [B, N] score matrix and a handful of shapes whatever the query count
_SUB_BUCKETS = (8, 32, 128, 512)


def topk_lower_index(x: torch.Tensor, k: int):
    """Per-row top-k (values, indices) along the last axis, ties to the lower index.

    ``torch.topk`` promises no order among equal values; a stable descending
    sort keeps equal values in index order, which is what ``lax.top_k``
    returns and what ``link_top_k`` and the document ranking rely on.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def min_max_normalize(scores: torch.Tensor, axis: int = -1,
                      where: torch.Tensor | None = None) -> torch.Tensor:
    """Min-max scaling to [0, 1] along ``axis`` (rows by default); constant
    rows map to all-ones.

    ``where`` optionally masks out padded columns (they return 0).
    """
    if where is not None:
        lo = torch.where(where, scores, torch.inf).amin(axis, keepdim=True)
        hi = torch.where(where, scores, -torch.inf).amax(axis, keepdim=True)
    else:
        lo = scores.amin(axis, keepdim=True)
        hi = scores.amax(axis, keepdim=True)
    rng = hi - lo
    out = torch.where(
        rng == 0, torch.ones_like(scores), (scores - lo) / torch.where(rng == 0, 1.0, rng)
    )
    if where is not None:
        out = torch.where(where, out, 0.0)
    return out


def batched_scores(
    queries: torch.Tensor, keys: torch.Tensor, compute_dtype: str = "float32"
) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] float32 similarity scores.

    ``compute_dtype="bfloat16"`` rounds both operands to bfloat16 and
    accumulates in float32, as the reference's bf16 dot with a float32
    result type does. The float32 product runs in full float32: the port
    never enables TF32.
    """
    if compute_dtype == "bfloat16":
        queries = queries.to(torch.bfloat16)
        keys = keys.to(torch.bfloat16)
    elif compute_dtype != "float32":
        raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
    return queries.float() @ keys.float().T


def _valid_columns(n: int, valid_n, device) -> torch.Tensor:
    return (torch.arange(n, device=device) < int(valid_n))[None, :]


def batched_normalized_scores(
    queries: torch.Tensor, keys: torch.Tensor, valid_n, compute_dtype: str = "float32"
) -> torch.Tensor:
    """Scores + per-row min-max normalization over the first ``valid_n`` keys
    (keys beyond it are padding and score 0)."""
    raw = batched_scores(queries, keys, compute_dtype)
    return min_max_normalize(raw, where=_valid_columns(raw.shape[1], valid_n, raw.device))


def batched_topk(scores: torch.Tensor, k: int):
    """Per-row top-k (values, indices) of a [B, N] score matrix."""
    return topk_lower_index(scores, k)


def score_and_topk(
    queries: torch.Tensor, keys: torch.Tensor, valid_n, k: int, compute_dtype: str = "float32"
):
    """Normalized scoring + top-k: (scores [B, N], values [B, k], indices [B, k])."""
    scores = batched_normalized_scores(queries, keys, valid_n, compute_dtype)
    values, indices = topk_lower_index(scores, k)
    return scores, values, indices


def sub_buckets(bucket: int, multiple: int = 1) -> list:
    """Padded batch sizes for slices of up to ``bucket`` queries, the last
    being the slice size; each is rounded up to a multiple of ``multiple``
    (a mesh's dp axis, which splits every batch evenly)."""
    bucket = max(1, bucket)
    sizes = [b for b in _SUB_BUCKETS if b < bucket] + [bucket]
    return [-(-b // multiple) * multiple for b in sizes]


def fused_topk_route(device) -> bool:
    """Routing decision for :func:`fact_topk`: True -> the fused CUDA kernel.
    Every CUDA call takes the kernel; the CPU takes the plain matmul + top-k."""
    return torch.device(device).type == "cuda"


# The [B, N] float32 score size above which the JAX package's ``fact_topk``
# takes its Pallas kernel on a TPU (its ``_PALLAS_SCORE_BYTES``, chosen there
# for speed on v5e). The port's routing does not use it: here it is the size
# where the reference's bf16 numerics change. At or below it the reference's
# XLA path rounds the queries to bfloat16 with the keys; above it the kernel
# keeps float32 queries.
BF16_QUERY_ROUNDING_SCORE_BYTES = 3 << 30


def rounds_bf16_queries(b: int, n: int, compute_dtype: str) -> bool:
    """Whether the default route of :func:`fact_topk` rounds the queries to
    bfloat16 before the fused kernel, as the reference's XLA path does for
    a [B, N] score matrix of at most ``BF16_QUERY_ROUNDING_SCORE_BYTES``."""
    return compute_dtype == "bfloat16" and b * n * 4 <= BF16_QUERY_ROUNDING_SCORE_BYTES


def fact_topk(
    queries: torch.Tensor,
    keys: torch.Tensor,
    valid_n,
    k: int,
    compute_dtype: str = "float32",
    use_pallas: bool | None = None,
):
    """Top-k normalized fact scores: (norm_vals [B, k], idx [B, k]).

    ``use_pallas`` (the JAX package's name) chooses the path: ``None``
    routes by :func:`fused_topk_route`, ``True`` takes the fused kernel and
    ``False`` pins the plain path. Padded/absent keys yield norm value 0.

    The plain path rounds the queries to bfloat16 along with the keys under
    ``compute_dtype="bfloat16"`` (:func:`batched_scores`), as the reference's
    XLA path does. The fused path takes float32 queries against the keys
    as they are resident (float32, or bfloat16 under bf16 compute), as the
    reference's Pallas kernel does, with one exception that keeps the
    reference's numbers: on the default route (``use_pallas=None``), where
    the reference would have taken its XLA path (:func:`rounds_bf16_queries`),
    bf16 compute rounds the queries (and any float32 keys) to bfloat16
    before the kernel. The kernel then
    forms the exact bf16 x bf16 products that XLA path does.
    """
    routed = use_pallas is None
    if routed:
        use_pallas = fused_topk_route(queries.device)
    if use_pallas:
        from .fused_topk import fused_score_topk

        if routed and rounds_bf16_queries(queries.shape[0], keys.shape[0], compute_dtype):
            queries = queries.to(torch.bfloat16).float()
            keys = keys.to(torch.bfloat16)
        norm, _raw, idx = fused_score_topk(queries, keys, valid_n, k)
        return norm, idx
    _scores, values, indices = score_and_topk(queries, keys, valid_n, k, compute_dtype)
    return values, indices
