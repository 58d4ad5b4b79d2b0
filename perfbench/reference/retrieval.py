"""HippoRAG 2's online retrieval, plainly, in float64.

For a question with query vector q (unit rows):

- fact scores q . f over every fact, min-max normalized over the facts;
  the recognition filter keeps the top ``linking_top_k`` (the benchmark's
  filter keeps every candidate it is shown);
- each kept fact adds score / max(1, passages naming the entity) to both of
  its entities; an entity's weight is the mean of what it received, and
  only the ``linking_top_k`` heaviest entities keep theirs;
- every passage node gets its min-max normalized dense score q . p times
  ``passage_node_weight``;
- the reset is that vector L1-normalized, and Personalized PageRank with
  damping d solves p = (1 - d) r + d (p T + (p . dangling) r);
- passages rank by their PageRank mass; the dense baseline ranks them by
  the normalized dense score.
"""

from __future__ import annotations

import copy
import itertools
import json

import numpy as np
import torch

from .graph import Graph


def min_max(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(1, keepdim=True)
    rng = x.amax(1, keepdim=True) - lo
    return torch.where(rng == 0, torch.ones_like(x), (x - lo) / torch.where(rng == 0, 1.0, rng))


class Reference:
    """``dtype`` is float64 for the reference; the control computes the same
    in float32 (with TF32 products where the caller enables them)."""

    def __init__(self, openie_rows, settings: dict, vectors, device, dtype=torch.float64):
        self.settings = settings
        self.device = torch.device(device)
        self.dtype = dtype
        self.graph = Graph(openie_rows, vectors, settings["synonymy_edge_sim_threshold"],
                           settings["synonymy_edge_max_neighbors"], self.device)
        g = self.graph
        self.fact_vec = vectors([json.dumps(list(f)) for f in g.facts]).to(self.device, dtype)
        self.passage_vec = vectors(g.passages).to(self.device, dtype)
        self.passage_of = {text: i for i, text in enumerate(g.passages)}
        self.chunk_count = torch.from_numpy(np.maximum(g.chunk_count, 1.0)).to(self.device, dtype)

    def as_dtype(self, dtype) -> "Reference":
        """The same reference computing in ``dtype`` (the graph is shared)."""
        other = copy.copy(self)
        other.dtype = dtype
        other.fact_vec, other.passage_vec, other.chunk_count = (
            t.to(dtype) for t in (self.fact_vec, self.passage_vec, self.chunk_count))
        return other

    # -------------------------------------------------------------- scores
    def fact_scores(self, q: torch.Tensor) -> torch.Tensor:
        """[B, F] normalized fact scores of float64 query rows."""
        return min_max(q @ self.fact_vec.T)

    def dense_scores(self, q: torch.Tensor) -> torch.Tensor:
        """[B, P] normalized dense passage scores."""
        return min_max(q @ self.passage_vec.T)

    # --------------------------------------------------------------- seeds
    def fact_choices(self, fact_norm_row: torch.Tensor, tol: float = 1e-5, most: int = 16):
        """The fact sets the ``linking_top_k`` cut may keep: one, unless
        normalized scores tie at the cut within ``tol``."""
        k = self.settings["linking_top_k"]
        vals, idx = torch.topk(fact_norm_row, min(k + 32, fact_norm_row.shape[0]))
        vals, idx = vals.tolist(), idx.tolist()
        if len(idx) <= k:
            return [idx]
        cut = vals[k - 1]
        sure = [f for v, f in zip(vals, idx) if v > cut + tol]
        tied = [f for v, f in zip(vals, idx) if abs(v - cut) <= tol]
        combos = itertools.islice(itertools.combinations(tied, k - len(sure)), most)
        return [sure + list(c) for c in combos]

    def entity_weights(self, fact_ids, fact_norm_row: torch.Tensor) -> dict:
        """Entity -> mean contribution of the kept facts ``fact_ids``."""
        got: dict = {}
        for f in fact_ids:
            s = float(fact_norm_row[f])
            for e in (int(self.graph.fact_subj[f]), int(self.graph.fact_obj[f])):
                got.setdefault(e, []).append(s / float(self.chunk_count[e]))
        return {e: sum(v) / len(v) for e, v in got.items()}

    def seed_choices(self, weights: dict, rel_tol: float = 1e-6, most: int = 16):
        """The entity sets the ``linking_top_k`` cut may keep: one, unless
        weights tie at the cut within ``rel_tol`` of the largest."""
        k = self.settings["linking_top_k"]
        ranked = sorted(((w, e) for e, w in weights.items() if w > 0), key=lambda x: (-x[0], x[1]))
        if len(ranked) <= k:
            return [dict((e, w) for w, e in ranked)]
        cut = ranked[k - 1][0]
        eps = rel_tol * ranked[0][0]
        sure = [(w, e) for w, e in ranked if w > cut + eps]
        tied = [(w, e) for w, e in ranked if abs(w - cut) <= eps]
        combos = itertools.islice(itertools.combinations(tied, k - len(sure)), most)
        return [dict((e, w) for w, e in sure + list(c)) for c in combos]

    def reset(self, entity_weights: dict, dense_norm_row: torch.Tensor) -> torch.Tensor:
        """[N] reset vector (not yet normalized)."""
        r = torch.zeros(self.graph.num_nodes, dtype=self.dtype, device=self.device)
        r[torch.from_numpy(self.graph.passage_nodes).to(self.device)] = (
            dense_norm_row * self.settings["passage_node_weight"])
        for e, w in entity_weights.items():
            r[e] += w
        return r

    # ----------------------------------------------------------------- PPR
    def ppr(self, resets: torch.Tensor, tol: float = 1e-13, max_iters: int = 200, flipped: bool = False):
        """PageRank of [B, N] resets: (p [B, N], iterations run). Stops once
        no entry moves by more than ``tol`` in an iteration. ``flipped``
        walks the graph with its near-threshold synonymy decisions flipped."""
        g = self.graph
        t_t, dangling = (g.t_flipped, g.dangling_flipped) if flipped else (g.t_transposed, g.dangling)
        t_t, dangling = t_t.to(self.dtype), dangling.to(self.dtype)
        d = self.settings["damping"]
        r = resets.clamp_min(0)
        r = r / r.sum(1, keepdim=True)
        r_t = r.T.contiguous()
        p = r_t
        it = 0
        while it < max_iters:
            dm = (p * dangling[:, None]).sum(0, keepdim=True)
            nxt = (1 - d) * r_t + d * (t_t @ p + dm * r_t)
            it += 1
            moved = float((nxt - p).abs().max())
            p = nxt
            if moved <= tol:
                break
        return p.T, it

    def passage_scores(self, p: torch.Tensor) -> torch.Tensor:
        return p[:, torch.from_numpy(self.graph.passage_nodes).to(self.device)]
