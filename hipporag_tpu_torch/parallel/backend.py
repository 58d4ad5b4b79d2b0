"""The retrieval back end on a ("dp", "corpus") mesh.

``HippoRAG`` drives it through the interface of its single-device back end
(``hipporag.DeviceBackend``): the fact and passage embedding matrices are
corpus-sharded, fact scoring merges per-shard top-ks, the seeds are built
on the mesh's first device and PageRank runs the sharded halo-exchange ELL
solver. The ranking is the JAX package's sharded one: PageRank scores of
the real passages, and min-max-normalized DPR scores for questions that
keep no fact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.retrieval import build_reset_batch
from ..utils.logging import get_logger
from ..utils.timing import span
from .mesh import corpus_sharded, make_mesh, mesh_devices_for
from .sharded import (
    make_sharded_norm_scores,
    make_sharded_ppr_ell,
    make_sharded_score_topk,
    put_sharded_ell,
    shard_graph_ell,
)

logger = get_logger(__name__)


class ShardedBackend:
    """Corpus-sharded embeddings and graph over a mesh of ``cfg.mesh_shape``.

    The mesh and its scorers and solver are built once per mesh and
    configuration: ``previous``, the back end this one replaces, hands them
    on when they match, so a re-index or a delete re-shards only the data.
    Batches are padded to a multiple of ``dp``.
    """

    def __init__(self, cfg, device, mesh_devices, coo, fact_embeddings, passage_embeddings,
                 fact_subj, fact_obj, node_chunk_counts, passage_node_ids,
                 num_facts: int, num_passages: int, num_nodes: int, previous=None):
        self.cfg = cfg
        n_mesh = int(np.prod(cfg.mesh_shape))
        devices = mesh_devices_for(n_mesh, device, mesh_devices)
        self._key = (tuple(cfg.mesh_shape), tuple(str(d) for d in devices), cfg.linking_top_k,
                     cfg.compute_dtype, cfg.ppr_max_iters, cfg.damping, cfg.ppr_tol)
        if isinstance(previous, ShardedBackend) and previous._key == self._key:
            self.mesh, self._score, self._norm_scores, self._ppr = (
                previous.mesh, previous._score, previous._norm_scores, previous._ppr)
        else:
            self.mesh = make_mesh(cfg.mesh_shape, devices=devices)
            self._score = make_sharded_score_topk(self.mesh, k=cfg.linking_top_k,
                                                  compute_dtype=cfg.compute_dtype)
            self._norm_scores = make_sharded_norm_scores(self.mesh, compute_dtype=cfg.compute_dtype)
            self._ppr = make_sharded_ppr_ell(self.mesh, max_iters=cfg.ppr_max_iters, damping=cfg.damping,
                                             tol=cfg.ppr_tol)
        self.dp = self.mesh.dp
        corpus = self.mesh.corpus
        self.home = self.mesh.devices[0, 0]

        def shard_rows(mat):
            rows = -(-mat.shape[0] // corpus) * corpus
            if rows != mat.shape[0]:
                mat = np.pad(mat, ((0, rows - mat.shape[0]), (0, 0)))
            return corpus_sharded(self.mesh).place(mat)

        self.fact_emb = shard_rows(fact_embeddings)
        self.passage_emb = shard_rows(passage_embeddings)
        graph = shard_graph_ell(coo, num_shards=corpus)
        self.n_total = corpus * graph.shard_nodes
        self.graph = put_sharded_ell(self.mesh, graph)
        self.fact_subj, self.fact_obj, self.node_chunk_counts, passage_nodes = (
            torch.from_numpy(a).to(self.home) for a in (fact_subj, fact_obj, node_chunk_counts, passage_node_ids))
        self.real_pids = passage_nodes[:num_passages].long()
        self.num_facts, self.num_passages, self.num_nodes = num_facts, num_passages, num_nodes
        logger.info("Sharded retrieval backend: mesh %sx%s over %d devices",
                    self.mesh.dp, corpus, self.mesh.size)

    def _to_home(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows).to(self.home)

    def fact_candidates(self, qf: np.ndarray):
        """Top ``linking_top_k`` normalized fact scores and rows of the
        staged questions, on the host: (values [b, k], indices [b, k])."""
        _, vals, idx = self._score(self._to_home(qf), self.fact_emb, self.num_facts)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def passage_scores(self, qp: np.ndarray) -> torch.Tensor:
        """The staged passage rows on the home device; their scores are
        taken with the seeds (:meth:`doc_scores`)."""
        return self._to_home(qp)

    def dense_scores(self, qp: np.ndarray) -> torch.Tensor:
        """Min-max-normalized [b, P] scores of the staged rows (``b`` a
        multiple of dp; columns past the real passages are padding, 0)."""
        return self._norm_scores(self._to_home(qp), self.passage_emb, self.num_passages)

    def doc_scores(self, qp, sel_scores, top_idx, top_mask, search: bool) -> torch.Tensor:
        """[b, P] document scores of a bucket on the home device, P being
        the real passages: the PageRank score of each passage node, or the
        normalized DPR score for a question with no kept fact or when
        ``search`` is False. Opens ``retrieve/seeds`` and, when searching,
        ``retrieve/ppr``."""
        cfg = self.cfg
        with span("retrieve/seeds"):
            dpr_norm = self._norm_scores(qp, self.passage_emb, self.num_passages)[:, :self.num_passages]
            if not search:
                return dpr_norm
            mask = self._to_home(top_mask)
            reset = build_reset_batch(
                self._to_home(sel_scores), self._to_home(top_idx), mask, dpr_norm,
                self.fact_subj, self.fact_obj, self.node_chunk_counts, self.real_pids, self.num_nodes,
                n_total=self.n_total, link_top_k=cfg.linking_top_k,
                passage_node_weight=cfg.passage_node_weight,
            )
        with span("retrieve/ppr"):
            ranks = self._ppr(self.graph, reset)
        return torch.where(mask.sum(1, keepdim=True) > 0, ranks[:, self.real_pids], dpr_norm)
