"""Batched graph retrieval (port of ``hipporag_tpu/models/retrieval.py``).

The whole query batch advances together on [B, ...] tensors: seed
construction, batched PPR over the bucketed-ELL or the COO operator
(dispatched on the graph's type), and the final [B, P] passage scores. Score semantics are the reference's:

- each selected fact contributes ``fact_score / |chunks containing endpoint|``
  to both endpoint phrases; per-phrase weights average over contributions;
- only the ``link_top_k`` highest phrases keep weight (ties to the lower
  node index);
- passage seeds are min-max-normalized DPR scores x passage_node_weight;
- queries with no surviving facts fall back to pure DPR ranking.

Seed weights are summed in a fixed order (no scatter-add), so the result
does not depend on the order a device applies colliding updates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.pagerank import COOGraph, ELLGraph, batched_ppr, batched_ppr_ell
from ..ops.scoring import min_max_normalize, topk_lower_index


class RetrievalIndex(NamedTuple):
    """Device-resident retrieval state (all padded to stable capacities).

    fact_* tensors are aligned with the fact-embedding matrix rows; node ids
    refer to the padded graph. Invalid/padded entries carry node id N_pad-1.
    """

    graph: ELLGraph | COOGraph
    fact_subj_node: torch.Tensor  # [F_pad] int32
    fact_obj_node: torch.Tensor  # [F_pad] int32
    node_chunk_counts: torch.Tensor  # [N_pad] float32 (>=0; divisor clamped to 1)
    passage_node_ids: torch.Tensor  # [P_pad] int32
    num_facts: int
    num_passages: int


def _phrase_seed_weights(
    sel_scores: torch.Tensor,  # [B, K]
    top_fact_idx: torch.Tensor,  # [B, K]
    top_fact_mask: torch.Tensor,  # [B, K]
    fact_subj_node: torch.Tensor,  # [F_cap]
    fact_obj_node: torch.Tensor,  # [F_cap]
    node_chunk_counts: torch.Tensor,  # [N_cap]
    num_nodes: int,
    link_top_k: int,
) -> torch.Tensor:
    """Phrase half of the seeds: kept phrase weights [B, N_cap].

    Each selected fact contributes score / |chunks containing endpoint| to
    both endpoints; a phrase's weight is the mean of its contributions, and
    only the top-``link_top_k`` phrases keep weight. The contributions to
    one phrase are added in endpoint order (subjects, then objects), the
    order the reference's scatter-add applies them on the CPU, and the
    per-phrase totals are written with a plain scatter.
    """
    b = top_fact_idx.shape[0]
    n_cap = node_chunk_counts.shape[0]
    idx = top_fact_idx.long()
    endpoints = torch.cat([fact_subj_node[idx], fact_obj_node[idx]], dim=1).long()  # [B, 2K]
    ep_scores = torch.cat([sel_scores, sel_scores], dim=1)
    ep_mask = torch.cat([top_fact_mask, top_fact_mask], dim=1)
    # also mask endpoints that point at the padding node
    ep_valid = ep_mask * (endpoints < num_nodes)

    divisor = torch.clamp_min(node_chunk_counts[endpoints], 1.0)
    contrib = ep_scores / divisor * ep_valid

    # masked endpoints go to the padding slot, which never holds a real node
    pad_slot = n_cap - 1
    safe = torch.where(ep_valid > 0, endpoints, pad_slot)

    same = safe[:, :, None] == safe[:, None, :]  # [B, 2K, 2K]
    weight_sum = torch.zeros_like(contrib)
    occurs = torch.zeros_like(contrib)
    for j in range(safe.shape[1]):
        weight_sum = weight_sum + torch.where(same[:, :, j], contrib[:, j:j + 1], 0.0)
        occurs = occurs + torch.where(same[:, :, j], ep_valid[:, j:j + 1], 0.0)
    per_endpoint = torch.where(occurs > 0, weight_sum / torch.clamp_min(occurs, 1.0), 0.0)

    phrase_weights = torch.zeros(b, n_cap, dtype=torch.float32, device=contrib.device)
    phrase_weights.scatter_(1, safe, per_endpoint)
    phrase_weights[:, pad_slot] = 0.0

    # keep only the top-`link_top_k` phrases per query
    top_vals, top_idx = topk_lower_index(phrase_weights, link_top_k)
    return torch.zeros_like(phrase_weights).scatter_(
        1, top_idx, torch.where(top_vals > 0, top_vals, 0.0)
    )


def seed_reset_batch(
    index: RetrievalIndex,
    sel_scores: torch.Tensor,
    top_fact_idx: torch.Tensor,
    top_fact_mask: torch.Tensor,
    dpr_scores: torch.Tensor,
    link_top_k: int,
    passage_node_weight: float,
):
    """PPR reset vectors [B, N_pad] (phrase + passage seeds), with the
    normalized DPR scores [B, P_pad] and the valid-passage mask [1, P_pad]."""
    b = top_fact_idx.shape[0]
    p_pad = index.passage_node_ids.shape[0]
    kept = _phrase_seed_weights(
        sel_scores, top_fact_idx, top_fact_mask,
        index.fact_subj_node, index.fact_obj_node, index.node_chunk_counts,
        int(index.graph.num_nodes), link_top_k,
    )
    # passage seeds from dense retrieval; real passages have distinct nodes
    # and padded ones all carry 0 into the padding slot, so a plain scatter
    p_valid = (torch.arange(p_pad, device=dpr_scores.device) < index.num_passages)[None, :]
    dpr_norm = min_max_normalize(dpr_scores, where=p_valid)
    pids = index.passage_node_ids.long()[None, :].expand(b, -1)
    passage_weights = torch.zeros_like(kept).scatter_(
        1, pids, dpr_norm * passage_node_weight * p_valid
    )
    return kept + passage_weights, dpr_norm, p_valid


def graph_search_batch(
    index: RetrievalIndex,
    sel_scores: torch.Tensor,  # [B, K] normalized scores of the selected facts
    top_fact_idx: torch.Tensor,  # [B, K] post-rerank fact rows (any value where mask=0)
    top_fact_mask: torch.Tensor,  # [B, K] float32 1.0 = real selected fact
    dpr_scores: torch.Tensor,  # [B, P_pad] raw passage similarity scores
    link_top_k: int = 5,
    passage_node_weight: float = 0.05,
    damping: float = 0.5,
    ppr_max_iters: int = 64,
    ppr_tol: float = 1.0e-8,
    ppr_dtype: str = "float32",
    ppr_edge_chunks: int = 1,
    return_iters: bool = False,
):
    """Return [B, P_pad] final document scores (padded cols = -inf).

    ``ppr_edge_chunks`` streams the COO operator's edge list in that many
    slices (the ELL operator ignores it). With ``return_iters=True``
    returns ``(scores, iters)``, ``iters`` being the per-query PPR
    iteration counts.
    """
    reset, dpr_norm, p_valid = seed_reset_batch(
        index, sel_scores, top_fact_idx, top_fact_mask, dpr_scores,
        link_top_k, passage_node_weight,
    )
    if isinstance(index.graph, ELLGraph):
        ppr, iters = batched_ppr_ell(
            index.graph, reset, damping=damping, max_iters=ppr_max_iters,
            tol=ppr_tol, compute_dtype=ppr_dtype, return_iters=True,
        )
    else:
        ppr, iters = batched_ppr(
            index.graph, reset, damping=damping, max_iters=ppr_max_iters,
            tol=ppr_tol, compute_dtype=ppr_dtype, edge_chunks=ppr_edge_chunks,
            return_iters=True,
        )
    ppr_doc_scores = ppr[:, index.passage_node_ids.long()]  # [B, P_pad]

    # DPR fallback for queries whose fact set is empty after reranking
    has_facts = top_fact_mask.sum(1, keepdim=True) > 0
    doc_scores = torch.where(has_facts, ppr_doc_scores, dpr_norm)
    doc_scores = torch.where(p_valid, doc_scores, -torch.inf)
    if return_iters:
        return doc_scores, iters
    return doc_scores


def rank_documents_topk(doc_scores: torch.Tensor, k: int):
    """Top-k of [B, P] scores -> (idx [B, k], vals [B, k]), ties to the lower
    index. Padded columns carry -inf and surface as -inf values."""
    vals, idx = topk_lower_index(doc_scores, min(k, doc_scores.shape[1]))
    return idx, vals


def rank_documents(doc_scores: torch.Tensor):
    """Descending order of [B, P] scores -> (sorted_idx, sorted_scores); a
    stable sort, so ties go to the lower index."""
    vals, order = torch.sort(doc_scores, dim=1, descending=True, stable=True)
    return order, vals


def build_reset_batch(
    sel_scores: torch.Tensor,  # [B, K]
    top_fact_idx: torch.Tensor,  # [B, K]
    top_fact_mask: torch.Tensor,  # [B, K]
    dpr_norm: torch.Tensor,  # [B, P] already min-max normalized over real passages
    fact_subj_node: torch.Tensor,  # [F_cap]
    fact_obj_node: torch.Tensor,  # [F_cap]
    node_chunk_counts: torch.Tensor,  # [N_cap]
    passage_node_ids: torch.Tensor,  # [P] real (distinct) passage node ids
    num_nodes: int,
    n_total: int,
    link_top_k: int = 5,
    passage_node_weight: float = 0.05,
) -> torch.Tensor:
    """The seed half of ``graph_search_batch`` as a [B, n_total] reset
    matrix: zero-padded (or cut) from N_cap to ``n_total`` columns, the
    width of a node space laid out for several devices.
    ``parallel/seeds.build_reset_vectors`` is its host twin."""
    b = top_fact_idx.shape[0]
    n_cap = node_chunk_counts.shape[0]
    kept = _phrase_seed_weights(
        sel_scores, top_fact_idx, top_fact_mask, fact_subj_node, fact_obj_node,
        node_chunk_counts, int(num_nodes), link_top_k,
    )
    pids = passage_node_ids.long()[None, :].expand(b, -1)
    reset = kept + torch.zeros_like(kept).scatter_(1, pids, dpr_norm * passage_node_weight)
    if n_total > n_cap:
        reset = torch.nn.functional.pad(reset, (0, n_total - n_cap))
    return reset[:, :n_total]
