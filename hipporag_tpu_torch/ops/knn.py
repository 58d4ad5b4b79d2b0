"""Streaming cosine kNN for synonymy edges (port of ``hipporag_tpu/ops/knn.py``).

Keys are scored in chunks while a running [B, k] top-k is merged per
chunk, so the [Nq, Nk] score matrix never exists at once. Only the
above-threshold pairs leave the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .scoring import topk_lower_index


def _streaming_topk(
    queries: torch.Tensor,  # [B, D]
    keys: torch.Tensor,  # [Nk, D]
    valid_k: int,
    k: int,
    key_chunk: int,
):
    """Per-query (scores [B, k], indices [B, k]) of the top-k keys among the
    first ``valid_k``; ties go to the lower key index."""
    nk = keys.shape[0]
    k = min(k, nk)
    b = queries.shape[0]
    vals = torch.full((b, k), -torch.inf, dtype=torch.float32, device=queries.device)
    idxs = torch.zeros((b, k), dtype=torch.int64, device=queries.device)
    for start in range(0, nk, key_chunk):
        chunk = keys[start:start + key_chunk]
        scores = queries @ chunk.T  # [B, C], float32
        col = torch.arange(start, start + chunk.shape[0], device=queries.device)
        scores = torch.where(col < valid_k, scores, -torch.inf)
        # running entries (earlier, lower indices) first, so ties keep them
        cat_vals = torch.cat([vals, scores], dim=1)
        cat_idx = torch.cat([idxs, col[None, :].expand(b, -1)], dim=1)
        vals, merge = topk_lower_index(cat_vals, k)
        idxs = torch.gather(cat_idx, 1, merge)
    return vals, idxs


def retrieve_knn_pairs(
    query_vecs: np.ndarray,
    key_vecs: np.ndarray,
    num_keys: int,
    k: int,
    sim_threshold: float,
    query_batch_size: int = 1000,
    key_batch_size: int = 10000,
    device="cuda",
):
    """Above-threshold kNN pairs: (rows int64, cols int64, scores float32) numpy.

    For each query row its top-``k`` keys by dot product (ties to the lower
    index), kept where the score >= ``sim_threshold``; pairs come out in
    row-major order, each row's in descending score.
    """
    queries = torch.as_tensor(np.ascontiguousarray(query_vecs, dtype=np.float32), device=device)
    keys = (
        queries
        if query_vecs is key_vecs
        else torch.as_tensor(np.ascontiguousarray(key_vecs, dtype=np.float32), device=device)
    )
    k = min(k, num_keys)
    rows_out, cols_out, scores_out = [], [], []
    for start in range(0, queries.shape[0], query_batch_size):
        vals, idxs = _streaming_topk(
            queries[start:start + query_batch_size], keys, num_keys, k, key_batch_size
        )
        r, j = torch.nonzero(vals >= sim_threshold, as_tuple=True)
        rows_out.append((r + start).cpu().numpy())
        cols_out.append(idxs[r, j].cpu().numpy())
        scores_out.append(vals[r, j].cpu().numpy())
    if not rows_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32)
    return (
        np.concatenate(rows_out).astype(np.int64),
        np.concatenate(cols_out).astype(np.int64),
        np.concatenate(scores_out).astype(np.float32),
    )
