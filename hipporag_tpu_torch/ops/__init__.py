"""Device ops of the PyTorch port: scoring, fused top-k, kNN, PageRank."""

from .fused_topk import fused_score_topk
from .knn import retrieve_knn, streaming_topk_scores
from .pagerank import (
    COOGraph,
    ELLGraph,
    batched_ppr,
    batched_ppr_ell,
    ell_from_coo,
    ppr_numpy_reference,
)
from .scoring import (
    batched_normalized_scores,
    batched_scores,
    batched_topk,
    fact_topk,
    min_max_normalize,
    score_and_topk,
)

__all__ = [
    "COOGraph",
    "ELLGraph",
    "batched_normalized_scores",
    "batched_ppr",
    "batched_ppr_ell",
    "batched_scores",
    "batched_topk",
    "ell_from_coo",
    "fact_topk",
    "fused_score_topk",
    "min_max_normalize",
    "ppr_numpy_reference",
    "retrieve_knn",
    "score_and_topk",
    "streaming_topk_scores",
]
