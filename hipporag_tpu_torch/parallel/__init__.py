"""Multi-device layer of the port: meshes, placements, collectives, the
sharded scorers and PPR solvers, and the host seed twin."""

from .mesh import CORPUS_AXIS, DP_AXIS, batch_sharded, corpus_sharded, make_hybrid_mesh, make_mesh, replicated
from .seeds import build_reset_vectors
from .sharded import (
    ShardedELLGraph,
    ShardedGraph,
    make_sharded_norm_scores,
    make_sharded_ppr,
    make_sharded_ppr_ell,
    make_sharded_score_topk,
    put_sharded_ell,
    put_sharded_graph,
    shard_graph,
    shard_graph_ell,
    sharded_ell_counters,
    sharded_ell_hbm_estimate,
)

__all__ = [
    "CORPUS_AXIS",
    "DP_AXIS",
    "ShardedELLGraph",
    "ShardedGraph",
    "batch_sharded",
    "build_reset_vectors",
    "corpus_sharded",
    "make_hybrid_mesh",
    "make_mesh",
    "make_sharded_norm_scores",
    "make_sharded_ppr",
    "make_sharded_ppr_ell",
    "make_sharded_score_topk",
    "put_sharded_ell",
    "put_sharded_graph",
    "replicated",
    "shard_graph",
    "shard_graph_ell",
    "sharded_ell_counters",
    "sharded_ell_hbm_estimate",
]
