"""Host-side knowledge-graph builder (PyTorch port's copy).

Same class, state and pickle format as ``hipporag_tpu.graph.builder``,
which cannot be imported without JAX (``hipporag_tpu/graph/__init__.py``
pulls in the JAX PageRank ops). The only change is ``symmetric_coo``: one
vectorized NumPy path that reproduces the native C++ ``coo_compile``
arithmetic exactly (float32 weights accumulated in float64, input order),
instead of a ctypes call into the JAX package's native library.

Replaces the igraph C-core graph object (reference: HippoRAG.py:210-241,
867-1020, 1146-1230) with a plain, picklable edge-dictionary representation
that compiles to padded device arrays (graph/csr.py).

Weight semantics (kept bit-compatible with the reference's effective
random-walk weights):

- **Fact edges** (add_fact_edges, ref HippoRAG.py:867-913): for every triple
  in a *new* chunk, both directed stats entries (subj→obj and obj→subj) get
  +1. The reference then materializes each entry as its own undirected
  igraph edge — two parallel edges of weight w — which a weighted random
  walk sees as total weight 2w. We store the directed entries and
  symmetrize at device-compile time, which yields the same walk.
- **Passage edges** (ref HippoRAG.py:915-957): chunk→entity weight 1.0 for
  new chunks.
- **Synonymy edges** (ref HippoRAG.py:959-1020): cosine score above
  threshold, ≤ ``synonymy_edge_max_neighbors`` kept, only for phrases with
  ≥ 3 alphanumeric chars. Unlike the reference — which re-appends *all*
  synonymy edges as parallel duplicates on every incremental ``index()``
  call — edges here are keyed by (src, dst), so re-indexing is idempotent.

Deletion removes vertices and every incident edge, mirroring
``graph.delete_vertices`` (ref HippoRAG.py:408).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, Iterable, List, Set, Tuple

from ..utils.logging import get_logger
from ..utils.misc import compute_mdhash_id

logger = get_logger(__name__)

_ALNUM = re.compile(r"[^A-Za-z0-9]")


class GraphBuilder:
    """Accumulates nodes and weighted edges; persists to a single pickle."""

    def __init__(self):
        # node name (hash id) -> dense index, insertion-ordered
        self.node_to_idx: Dict[str, int] = {}
        self.node_names: List[str] = []
        # directed stats entries: (src_name, dst_name) -> weight
        self.edge_weights: Dict[Tuple[str, str], float] = {}
        # (src_name, dst_name) -> 'fact' | 'passage' | 'synonymy'; tracked at
        # insertion time so category stats stay exact even when duplicate
        # facts merge into one edge (ref get_graph_info, HippoRAG.py:1232-1285,
        # derives them by subtraction — wrong under merges)
        self.edge_category: Dict[Tuple[str, str], str] = {}
        # entity node name -> set of chunk ids referencing it (refcounts for
        # deletion, ref state_utils.py:4-11)
        self.ent_node_to_chunk_ids: Dict[str, Set[str]] = {}
        # chunk node names already wired into the graph
        self.indexed_chunk_ids: Set[str] = set()

    # ------------------------------------------------------------------
    # Node management
    # ------------------------------------------------------------------
    def ensure_node(self, name: str) -> int:
        idx = self.node_to_idx.get(name)
        if idx is None:
            idx = len(self.node_names)
            self.node_to_idx[name] = idx
            self.node_names.append(name)
        return idx

    def __contains__(self, name: str) -> bool:
        return name in self.node_to_idx

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_edges(self) -> int:
        return len(self.edge_weights)

    # ------------------------------------------------------------------
    # Edge construction (index path)
    # ------------------------------------------------------------------
    def add_fact_edges(self, chunk_ids: List[str], chunk_triples: List[List[Tuple]]):
        """+1 (both directions) per triple occurrence in chunks not yet indexed."""
        for chunk_key, triples in zip(chunk_ids, chunk_triples):
            entities_in_chunk: Set[str] = set()
            is_new_chunk = chunk_key not in self.indexed_chunk_ids
            for triple in triples:
                triple = tuple(triple)
                subj_key = compute_mdhash_id(str(triple[0]), prefix="entity-")
                obj_key = compute_mdhash_id(str(triple[2]), prefix="entity-")
                entities_in_chunk.add(subj_key)
                entities_in_chunk.add(obj_key)
                if is_new_chunk:
                    self.edge_weights[(subj_key, obj_key)] = (
                        self.edge_weights.get((subj_key, obj_key), 0.0) + 1.0
                    )
                    self.edge_weights[(obj_key, subj_key)] = (
                        self.edge_weights.get((obj_key, subj_key), 0.0) + 1.0
                    )
                    self.edge_category[(subj_key, obj_key)] = "fact"
                    self.edge_category[(obj_key, subj_key)] = "fact"
            for node in entities_in_chunk:
                self.ent_node_to_chunk_ids.setdefault(node, set()).add(chunk_key)

    def add_passage_edges(
        self, chunk_ids: List[str], chunk_triple_entities: List[List[str]]
    ) -> int:
        """chunk→entity weight-1 edges for chunks not yet indexed."""
        num_new_chunks = 0
        for chunk_key, entities in zip(chunk_ids, chunk_triple_entities):
            if chunk_key in self.indexed_chunk_ids:
                continue
            for entity in entities:
                entity_key = compute_mdhash_id(str(entity), prefix="entity-")
                self.edge_weights[(chunk_key, entity_key)] = 1.0
                self.edge_category[(chunk_key, entity_key)] = "passage"
            num_new_chunks += 1
        return num_new_chunks

    def add_synonymy_edges(
        self,
        entity_keys: List[str],
        entity_contents: Dict[str, str],
        knn_indices,  # [Nq, K] int array into entity_keys
        knn_scores,  # [Nq, K] float array
        sim_threshold: float,
        max_neighbors: int = 100,
    ) -> int:
        """Add cosine-similarity edges from kNN results (ref HippoRAG.py:996-1018).

        Keeps up to ``max_neighbors + 1`` neighbors per node: the break
        condition is ``kept > max_neighbors`` AFTER adding, deliberately
        reproducing the reference's own off-by-one (``num_nns > 100``,
        HippoRAG.py:1007) so edge sets stay bit-identical at any setting.
        """
        num_added = 0
        for qi, node_key in enumerate(entity_keys):
            content = entity_contents.get(node_key, "")
            if len(_ALNUM.sub("", content)) <= 2:
                continue
            kept = 0
            for nn_idx, score in zip(knn_indices[qi], knn_scores[qi]):
                score = float(score)
                if score < sim_threshold or kept > max_neighbors:
                    break
                nn_key = entity_keys[int(nn_idx)]
                if nn_key == node_key:
                    continue
                if not entity_contents.get(nn_key, ""):
                    continue
                self.edge_weights[(node_key, nn_key)] = score
                # a fact edge between the same pair keeps its category: the
                # synonymy score only overwrites the weight (matching the
                # reference's node_to_node_stats assignment)
                self.edge_category.setdefault((node_key, nn_key), "synonymy")
                kept += 1
                num_added += 1
        return num_added

    def mark_chunks_indexed(self, chunk_ids: Iterable[str]):
        self.indexed_chunk_ids.update(chunk_ids)

    def register_nodes(self, names: Iterable[str]):
        for name in names:
            self.ensure_node(name)

    # ------------------------------------------------------------------
    # Deletion (ref HippoRAG.py:337-411)
    # ------------------------------------------------------------------
    def remove_chunk_refs(
        self, chunk_ids: Set[str], triples_by_chunk: Dict[str, List[Tuple]]
    ) -> Tuple[Set[str], Set[str]]:
        """Decrement entity refcounts for deleted chunks.

        Returns (entities_with_no_remaining_chunks, chunk_ids) for vertex
        removal. Mirrors remove_sources_from_mapping (state_utils.py:4-11).
        """
        orphaned: Set[str] = set()
        for chunk_id in chunk_ids:
            for triple in triples_by_chunk.get(chunk_id, []):
                for phrase in (triple[0], triple[2]):
                    key = compute_mdhash_id(str(phrase), prefix="entity-")
                    refs = self.ent_node_to_chunk_ids.get(key)
                    if refs is None:
                        continue
                    refs.discard(chunk_id)
                    if not refs:
                        orphaned.add(key)
                        del self.ent_node_to_chunk_ids[key]
        return orphaned, chunk_ids

    def delete_vertices(self, names: Set[str]):
        """Remove nodes and all incident edges; reindex densely."""
        if not names:
            return
        keep = [n for n in self.node_names if n not in names]
        self.node_names = keep
        self.node_to_idx = {n: i for i, n in enumerate(keep)}
        self.edge_weights = {
            (a, b): w
            for (a, b), w in self.edge_weights.items()
            if a not in names and b not in names
        }
        self.edge_category = {
            k: c for k, c in self.edge_category.items() if k in self.edge_weights
        }
        self.indexed_chunk_ids -= names

    # ------------------------------------------------------------------
    # Compile to arrays
    # ------------------------------------------------------------------
    def symmetric_coo(self):
        """Symmetrized (src, dst, weight) int/float numpy arrays.

        Every directed stats entry (a, b, w) contributes w to both A[a,b]
        and A[b,a] (see module docstring for why this equals the reference's
        parallel undirected igraph edges). Entries whose endpoints are not
        registered nodes are skipped (ref add_new_edges validity check,
        HippoRAG.py:1213-1221). Self-loops are dropped (HippoRAG.py:1201).
        """
        import numpy as np

        empty = (
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.int32),
            np.zeros(0, dtype=np.float32),
        )
        if not self.edge_weights:
            return empty

        # Extract raw directed entries with resolvable endpoints.
        raw_src, raw_dst, raw_w = [], [], []
        for (a, b), w in self.edge_weights.items():
            ia = self.node_to_idx.get(a)
            ib = self.node_to_idx.get(b)
            if ia is None or ib is None or ia == ib:
                continue
            raw_src.append(ia)
            raw_dst.append(ib)
            raw_w.append(w)
        if not raw_src:
            return empty

        # Symmetrize + dedup-accumulate + (dst, src) sort with the native
        # coo_compile arithmetic: each entry's weight is rounded to float32
        # first, then the (b, a) and (a, b) keys accumulate it in float64 in
        # input order (bincount sums in array order), cast back to float32.
        a = np.asarray(raw_src, np.int64)
        b = np.asarray(raw_dst, np.int64)
        w64 = np.asarray(raw_w, np.float32).astype(np.float64)
        keys = np.stack([(b << 32) | a, (a << 32) | b], axis=1).reshape(-1)
        uniq, inverse = np.unique(keys, return_inverse=True)
        sums = np.bincount(inverse, weights=np.repeat(w64, 2), minlength=len(uniq))
        src = (uniq & 0xFFFFFFFF).astype(np.int32)
        dst = (uniq >> 32).astype(np.int32)
        return src, dst, sums.astype(np.float32)

    def edge_category_counts(self) -> Dict[str, int]:
        """Exact directed-entry counts per category, from insertion-time tags."""
        counts = {"fact": 0, "passage": 0, "synonymy": 0}
        for key in self.edge_weights:
            counts[self.edge_category.get(key, "synonymy")] += 1
        return counts

    @property
    def needs_category_backfill(self) -> bool:
        """True when any edge lacks an insertion-time category tag.

        Covers both a fully legacy (pre-tag) state AND a legacy state that
        was loaded and then incrementally indexed — the new edges carry
        tags, but the pre-existing ones still don't, and each untagged
        edge would be misreported as synonymy by edge_category_counts."""
        if not self.edge_weights:
            return False
        if len(self.edge_category) >= len(self.edge_weights):
            return False
        return any(key not in self.edge_category for key in self.edge_weights)

    def backfill_edge_categories(self, fact_pairs) -> None:
        """Reconstruct category tags for a legacy (pre-tag) state.

        ``fact_pairs`` is an iterable of (subj_key, obj_key) node-key
        tuples derived from the persisted fact store. Passage edges are
        recognized by the chunk- key prefix; remaining entity-entity edges
        are facts when their pair appears in ``fact_pairs``, else synonymy.
        """
        pairs = set()
        for a, b in fact_pairs:
            pairs.add((a, b))
            pairs.add((b, a))
        for key in self.edge_weights:
            if key in self.edge_category:
                continue
            u, v = key
            if u.startswith("chunk-") or v.startswith("chunk-"):
                self.edge_category[key] = "passage"
            elif key in pairs:
                self.edge_category[key] = "fact"
            else:
                self.edge_category[key] = "synonymy"

    def graph_info(self) -> Dict[str, int]:
        return {
            "num_nodes": self.num_nodes,
            "num_directed_stat_entries": self.num_edges,
            "num_indexed_chunks": len(self.indexed_chunk_ids),
        }

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save(self, path: str):
        state = {
            "node_names": self.node_names,
            "edge_weights": self.edge_weights,
            "edge_category": self.edge_category,
            "ent_node_to_chunk_ids": {k: sorted(v) for k, v in self.ent_node_to_chunk_ids.items()},
            "indexed_chunk_ids": sorted(self.indexed_chunk_ids),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "GraphBuilder":
        builder = cls()
        if not os.path.exists(path):
            return builder
        with open(path, "rb") as f:
            state = pickle.load(f)
        builder.node_names = state["node_names"]
        builder.node_to_idx = {n: i for i, n in enumerate(builder.node_names)}
        builder.edge_weights = state["edge_weights"]
        builder.edge_category = state.get("edge_category", {})
        builder.ent_node_to_chunk_ids = {
            k: set(v) for k, v in state["ent_node_to_chunk_ids"].items()
        }
        builder.indexed_chunk_ids = set(state["indexed_chunk_ids"])
        return builder
