"""Host-side PPR seed construction (port's copy of ``hipporag_tpu/parallel/seeds.py``).

The host twin of the seeds, used by the quality harnesses' independent
NumPy retrieval (``evaluation/twiki.py``). Mirrors the device-side math in
models/retrieval.graph_search_batch
(reference HippoRAG.py:1583-1644): each selected fact contributes
score / |chunks containing endpoint| to both endpoint phrases, per-phrase
weights average over contributions, only the top link_top_k phrases keep
weight, and min-max-normalized DPR scores seed the passage nodes with
passage_node_weight. Runs in numpy — the arrays are [B, K]-small except
the final scatter into the reset matrix.
"""

from __future__ import annotations

import numpy as np


def build_reset_vectors(
    sel_scores: np.ndarray,  # [B, K] normalized scores of selected facts
    top_idx: np.ndarray,  # [B, K] fact rows
    top_mask: np.ndarray,  # [B, K] 1.0 = real selected fact
    dpr_scores: np.ndarray,  # [B, P] raw passage scores (real passages only)
    fact_subj: np.ndarray,  # [F_cap] endpoint node ids
    fact_obj: np.ndarray,
    passage_node_ids: np.ndarray,  # [P] node ids of real passages
    node_chunk_counts: np.ndarray,  # [N_cap]
    num_nodes: int,
    n_total: int,  # reset width (>= N_cap; sharded node space)
    link_top_k: int,
    passage_node_weight: float = 0.05,
):
    """Returns (reset [B, n_total] f32, dpr_norm [B, P] f32, has_facts [B] bool)."""
    b, k = top_idx.shape
    p = passage_node_ids.shape[0]
    reset = np.zeros((b, n_total), dtype=np.float32)
    dpr_norm = np.zeros((b, p), dtype=np.float32)
    has_facts = np.zeros(b, dtype=bool)

    for i in range(b):
        dq = dpr_scores[i]
        rng = dq.max() - dq.min() if p else 0.0
        dpr_norm[i] = 1.0 if rng == 0 else (dq - dq.min()) / rng

        wsum: dict[int, float] = {}
        occ: dict[int, int] = {}
        for j in range(k):
            if top_mask[i, j] == 0:
                continue
            has_facts[i] = True
            score = float(sel_scores[i, j])
            for node in (int(fact_subj[top_idx[i, j]]), int(fact_obj[top_idx[i, j]])):
                if node >= num_nodes:
                    continue
                wsum[node] = wsum.get(node, 0.0) + score / max(
                    float(node_chunk_counts[node]), 1.0
                )
                occ[node] = occ.get(node, 0) + 1
        if wsum:
            phrases = sorted(
                ((w / occ[n], n) for n, w in wsum.items()),
                key=lambda t: (-t[0], t[1]),
            )[:link_top_k]
            for weight, node in phrases:
                if weight > 0:
                    reset[i, node] = weight
        reset[i, passage_node_ids] += dpr_norm[i] * passage_node_weight
    return reset, dpr_norm, has_facts
