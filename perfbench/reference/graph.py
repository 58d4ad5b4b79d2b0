"""The knowledge graph of HippoRAG 2, rebuilt from OpenIE rows.

Semantics (HippoRAG 2, arXiv:2502.14802, and its reference code):

- phrases are lowercased, with every character other than a letter, a digit
  or a space replaced by a space, then stripped; a passage's triples are
  de-duplicated before that;
- the entity nodes are the subjects and objects of the triples; the facts
  are the distinct processed triples in passage order;
- every occurrence of a triple adds 1 to the entries (s, o) and (o, s);
- a passage links to each entity of its triples with weight 1;
- an entity with more than two alphanumeric characters links to its nearest
  entities by cosine, in descending order, while the score is at least the
  threshold and at most ``max_neighbors + 1`` are kept; the score replaces
  the entry's weight;
- each directed entry (a, b, w), a != b, adds w to A[a, b] and A[b, a]; the
  random walk moves along rows of A normalized by their sums.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_NON_ALNUM = re.compile(r"[^A-Za-z0-9 ]")
_ALNUM = re.compile(r"[^A-Za-z0-9]")


def process(text: str) -> str:
    return _NON_ALNUM.sub(" ", str(text).lower()).strip()


class Graph:
    """Nodes: entities (sorted), then passages (in order).

    ``vectors(texts) -> [n, D] float32 tensor`` gives the entity vectors
    the synonymy edges are computed from.
    """

    def __init__(self, openie_rows, vectors, sim_threshold: float, max_neighbors: int, device):
        chunk_triples = []
        for row in openie_rows:
            seen = {}
            for t in row["extracted_triples"]:
                if len(t) == 3:
                    seen.setdefault(tuple(str(x) for x in t), None)
            chunk_triples.append([tuple(process(x) for x in t) for t in seen])
        self.passages = [row["passage"] for row in openie_rows]
        ents_per_chunk = [{e for t in ts for e in (t[0], t[2])} for ts in chunk_triples]
        self.entities = sorted(set().union(*ents_per_chunk))
        ent_id = {e: i for i, e in enumerate(self.entities)}
        n_ent = len(self.entities)
        self.num_nodes = n_ent + len(self.passages)
        self.passage_nodes = np.arange(n_ent, self.num_nodes)

        self.facts, fact_id = [], {}
        for ts in chunk_triples:
            for t in ts:
                if t not in fact_id:
                    fact_id[t] = len(self.facts)
                    self.facts.append(t)
        self.fact_id = fact_id
        self.fact_subj = np.array([ent_id[t[0]] for t in self.facts], np.int64)
        self.fact_obj = np.array([ent_id[t[2]] for t in self.facts], np.int64)
        self.chunk_count = np.zeros(n_ent, np.float64)
        for ents in ents_per_chunk:
            for e in ents:
                self.chunk_count[ent_id[e]] += 1

        weights: dict = {}
        for ts in chunk_triples:
            for s, _p, o in ts:
                a, b = ent_id[s], ent_id[o]
                weights[(a, b)] = weights.get((a, b), 0.0) + 1.0
                weights[(b, a)] = weights.get((b, a), 0.0) + 1.0
        for c, ents in enumerate(ents_per_chunk):
            for e in ents:
                weights[(n_ent + c, ent_id[e])] = 1.0
        synonymy, near = self._synonymy(vectors, sim_threshold, max_neighbors, device)
        self.num_synonymy = sum(1 for v in synonymy.values() if v >= sim_threshold)
        self.near_threshold = len(near)
        base = dict(weights)
        base.update((k, v) for k, v in synonymy.items() if v >= sim_threshold)
        self.t_transposed, self.dangling, self.num_entries = self._walk(base, device)
        # scores within 1e-6 of the threshold may be decided the other way
        # in float32: the graph with each of those decisions flipped
        self.t_flipped = None
        if near:
            flipped = dict(weights)
            flipped.update((k, v) for k, v in synonymy.items() if (v >= sim_threshold) != (k in near))
            self.t_flipped, self.dangling_flipped, _ = self._walk(flipped, device)

    def _walk(self, weights: dict, device):
        """(T^T as CSR, dangling mask, entries) of the symmetrized walk."""
        keys = np.array([k for k in weights if k[0] != k[1]], np.int64).reshape(-1, 2)
        w = np.array([weights[tuple(k)] for k in keys], np.float64)
        idx = torch.from_numpy(np.stack([np.concatenate([keys[:, 0], keys[:, 1]]),
                                         np.concatenate([keys[:, 1], keys[:, 0]])]))
        adj = torch.sparse_coo_tensor(idx, torch.from_numpy(np.concatenate([w, w])),
                                      (self.num_nodes, self.num_nodes)).coalesce()
        strength = torch.zeros(self.num_nodes, dtype=torch.float64).index_add_(0, adj.indices()[0], adj.values())
        vals = adj.values() / strength[adj.indices()[0]]
        # transposed, so that (p T)^T = T^T p^T is one sparse product
        t_t = torch.sparse_coo_tensor(adj.indices().flip(0), vals, adj.shape).coalesce().to_sparse_csr()
        return t_t.to(device), (strength == 0).to(torch.float64).to(device), int(adj.values().shape[0])

    def _synonymy(self, vectors, threshold, max_neighbors, device, block=2048):
        """The synonymy entries {(a, b): score} the rule keeps, with every
        score within 1e-6 below the threshold beside them, and the set of
        entries within 1e-6 of the threshold."""
        keep = [i for i, e in enumerate(self.entities) if len(_ALNUM.sub("", e)) > 2]
        entries, near = {}, set()
        if not keep:
            return entries, near
        vec = vectors(self.entities).to(device, torch.float64)
        for start in range(0, len(keep), block):
            rows = torch.tensor(keep[start:start + block], device=device)
            scores = vec[rows] @ vec.T
            scores[torch.arange(len(rows), device=device), rows] = -np.inf
            cand = (scores >= threshold - 1e-6).nonzero().cpu().numpy()
            vals = scores[cand[:, 0], cand[:, 1]].cpu().numpy()
            order = np.lexsort((cand[:, 1], -vals, cand[:, 0]))
            kept_of: dict = {}
            for (r, c), v in zip(cand[order], vals[order]):
                a = keep[start + r]
                if v >= threshold:
                    if kept_of.get(a, 0) > max_neighbors:
                        continue
                    kept_of[a] = kept_of.get(a, 0) + 1
                entries[(a, int(c))] = float(v)
                if abs(v - threshold) < 1e-6:
                    near.add((a, int(c)))
        return entries, near
