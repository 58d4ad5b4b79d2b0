"""HippoRAG orchestrator on PyTorch (port of ``hipporag_tpu/hipporag.py``).

index -> retrieve -> rag_qa, the same steps in the same order as the JAX
package, with the device work in torch on an explicit ``device``:

- **Indexing**: chunks -> OpenIE (host) -> entity/fact stores -> graph
  builder (host dict) -> synonymy kNN (device) -> padded ELL operator
  (``ppr_format="ell"``) or the padded COO edge list (``"coo"``).
- **Retrieval**: query embeddings (host) -> DPR passage scores -> fact
  scores and normalized top-k candidates (the fused CUDA kernel on a GPU)
  -> recognition-memory LLM filter (host) -> seeds -> batched PPR ->
  top-k documents.
- **Dense retrieval** (``retrieve_dpr``, ``dense_passage_retrieval``):
  min-max-normalized query x passage scores and a top-k on the device.
- **IRCoT** (``retrieve_ircot``, ``answer_with_ircot``): batched rounds of
  ``retrieve`` between reasoning steps.
- **Delete** (``delete``): host-only bookkeeping of stores and graph
  refcounts; the next retrieve rebuilds the device state in either format.
- **Profiling**: with ``profile_log_dir`` set, the device work of each
  ``retrieve`` is traced by ``torch.profiler`` into that directory.
- **QA** through the host-side ``utils/qa_utils``.

The host components (LLMs, stores, OpenIE, prompts, the rerank filter, the
embedders other than ``jax/``) are the port's copies of the JAX package's
JAX-free modules; ``jax/`` embedders run on the port's encoder
(``embedding/encoder.py``) on ``device``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from .config import BaseConfig
from .evaluation import RetrievalRecall
from .llm import get_llm
from .openie import LLMOpenIE
from .preprocessing import get_preprocessor
from .prompts import PromptTemplateManager, get_query_instruction
from .rerank import RecognitionMemoryFilter
from .storage import get_embedding_store
from .utils.logging import get_logger
from .utils.misc import (
    Chunk,
    QuerySolution,
    compute_mdhash_id,
    extract_entity_nodes,
    filter_invalid_triples,
    flatten_facts,
    text_processing,
)
from .utils.qa_utils import finish_rag_qa, reason_step
from .utils.timing import StageTimers, device_profile

from .embedding import get_embedding_model
from .graph import GraphBuilder, compile_device_graph, pick_capacity
from .models.retrieval import RetrievalIndex, graph_search_batch, rank_documents_topk
from .ops.knn import retrieve_knn_pairs
from .ops.pagerank import ell_caps, ell_from_coo
from .ops.scoring import (
    batched_normalized_scores,
    batched_scores,
    dense_topk,
    fact_topk,
    min_max_normalize,
    sub_buckets,
    topk_lower_index,
)

logger = get_logger(__name__)

RETRIEVAL_K_LIST = [1, 2, 5, 10, 20, 30, 50, 100, 150, 200]


def _fan_out(fn, items, max_workers: int = 16):
    """Thread fan-out for network-bound LLM calls; serial for one item."""
    items = list(items)
    if len(items) <= 1:
        return [fn(item) for item in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(fn, items))


def _fact_text(triple: Tuple[str, str, str]) -> str:
    """Canonical stored form of a fact (JSON, as the JAX package stores it)."""
    return json.dumps(list(triple))


def _parse_fact_text(text: str) -> Tuple[str, str, str]:
    return tuple(json.loads(text))


def _check_supported(cfg: BaseConfig) -> None:
    """Refuse configuration this port does not carry yet."""
    if int(np.prod(cfg.mesh_shape)) > 1:
        raise NotImplementedError("mesh_shape > 1 device: multi-GPU retrieval is not ported")


class HippoRAG:
    """Graph-based RAG with batched retrieval on a torch device."""

    def __init__(
        self,
        global_config: Optional[BaseConfig] = None,
        save_dir: Optional[str] = None,
        llm_model_name: Optional[str] = None,
        llm_base_url: Optional[str] = None,
        embedding_model_name: Optional[str] = None,
        embedding_base_url: Optional[str] = None,
        azure_endpoint: Optional[str] = None,
        azure_embedding_endpoint: Optional[str] = None,
        extraction_llm=None,
        qa_llm=None,
        embedding_model=None,
        text_preprocessor=None,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ):
        if global_config is None:
            global_config = BaseConfig()
        overrides = {
            "save_dir": save_dir,
            "llm_name": llm_model_name,
            "llm_base_url": llm_base_url,
            "embedding_model_name": embedding_model_name,
            "embedding_base_url": embedding_base_url,
            "azure_endpoint": azure_endpoint,
            "azure_embedding_endpoint": azure_embedding_endpoint,
        }
        for key, value in {**overrides, **kwargs}.items():
            if value is not None:
                if not hasattr(global_config, key):
                    raise ValueError(f"Unknown config field: {key}")
                setattr(global_config, key, value)
        _check_supported(global_config)
        self.global_config = global_config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")

        # working dir namespaced by model pair, as in the JAX package
        llm_label = self.global_config.llm_name.replace("/", "_")
        emb_label = self.global_config.embedding_model_name.replace("/", "_")
        self.working_dir = os.path.join(self.global_config.save_dir, f"{llm_label}_{emb_label}")
        os.makedirs(self.working_dir, exist_ok=True)

        self.llm = extraction_llm or qa_llm or get_llm(self.global_config)
        self.llm_model = self.llm
        self.extraction_llm = extraction_llm or self.llm
        self.qa_llm = qa_llm or self.llm
        self.embedding_model = embedding_model or get_embedding_model(self.global_config, self.device)
        emb_cache = os.path.join(self.working_dir, "embedding_cache.sqlite")
        if hasattr(self.embedding_model, "attach_cache"):
            self.embedding_model.attach_cache(emb_cache)

        ie_name = self.global_config.information_extraction_model_name
        if ie_name == "openie_vllm_offline":
            from .openie.openie_offline import VLLMOfflineOpenIE

            self.openie = VLLMOfflineOpenIE(self.global_config)
        elif ie_name == "openie_transformers_offline":
            from .openie.openie_offline import TransformersOfflineOpenIE

            self.openie = TransformersOfflineOpenIE(self.global_config)
        else:
            self.openie = LLMOpenIE(self.extraction_llm)
        self.prompt_template_manager = PromptTemplateManager()
        self.rerank_filter = RecognitionMemoryFilter(
            self.llm, self.global_config.rerank_dspy_file_path
        )
        self.preprocessor = text_preprocessor or get_preprocessor(self.global_config)
        self.text_preprocessor = self.preprocessor

        batch = self.global_config.embedding_batch_size
        self.chunk_embedding_store = get_embedding_store(
            self.embedding_model, self.working_dir, batch, "chunk", self.global_config
        )
        self.entity_embedding_store = get_embedding_store(
            self.embedding_model, self.working_dir, batch, "entity", self.global_config
        )
        self.fact_embedding_store = get_embedding_store(
            self.embedding_model, self.working_dir, batch, "fact", self.global_config
        )

        self._graph_path = os.path.join(self.working_dir, "kg_builder.pickle")
        if self.global_config.force_index_from_scratch:
            self.graph = GraphBuilder()
        else:
            self.graph = GraphBuilder.load(self._graph_path)

        self.openie_results_path = os.path.join(self.working_dir, "openie_results.json")
        self._chunk_metadata_path = os.path.join(self.working_dir, "chunk_metadata.json")
        self.chunk_metadata: Dict[str, Dict] = {}
        if os.path.exists(self._chunk_metadata_path):
            with open(self._chunk_metadata_path) as f:
                self.chunk_metadata = json.load(f)

        self.timers = StageTimers()
        self.ready_to_retrieve = False
        self.query_to_embedding: Dict[str, Dict[str, np.ndarray]] = {
            "triple": {},
            "passage": {},
        }
        self._index_state: Optional[RetrievalIndex] = None
        self._capacities: Dict[str, Optional[int]] = {
            "node": None,
            "edge": None,
            "fact": None,
            "passage": None,
        }
        self.all_retrieval_time = 0.0
        self.rerank_time = 0.0
        self.ppr_time = 0.0
        self.embed_time = 0.0
        self.topk_time = 0.0

    # ==================================================================
    # Indexing
    # ==================================================================
    def _preprocess_docs(self, docs: List[Union[str, Chunk]]) -> List[Chunk]:
        return self.preprocessor.preprocess(docs)

    def pre_openie(self, docs: List[Union[str, Chunk]]):
        """Offline two-phase OpenIE checkpoint."""
        chunks = self._preprocess_docs(docs)
        missing = self.chunk_embedding_store.get_missing_string_hash_ids(
            [c.content for c in chunks]
        )
        all_openie_info, keys_to_process = self.load_existing_openie(missing.keys())
        new_rows = {k: missing[k] for k in keys_to_process}
        if new_rows:
            ner_dict, triple_dict = self.openie.batch_openie(new_rows)
            self.merge_openie_results(all_openie_info, new_rows, ner_dict, triple_dict)
        if self.global_config.save_openie:
            self.save_openie_results(all_openie_info)
        raise RuntimeError(
            "Offline OpenIE completed. Run indexing again with openie_mode='online' "
            "to build the graph."
        )

    def index(self, docs: List[Union[str, Chunk]]):
        logger.info("Indexing %d documents", len(docs))
        chunks = self._preprocess_docs(docs)
        chunk_texts = [c.content for c in chunks]

        if self.global_config.openie_mode == "offline":
            self.pre_openie(chunks)

        with self.timers.track("index/embed_chunks"):
            self.chunk_embedding_store.insert_strings(chunk_texts)
        for chunk in chunks:
            chunk_id = self.chunk_embedding_store.get_hash_id(chunk.content)
            metadata = dict(chunk.metadata)
            if chunk.source_id is not None:
                metadata["source_id"] = chunk.source_id
            self.chunk_metadata[chunk_id] = metadata
        self._save_chunk_metadata()

        chunk_to_rows = self.chunk_embedding_store.get_all_id_to_rows()
        all_openie_info, keys_to_process = self.load_existing_openie(chunk_to_rows.keys())
        new_rows = {k: chunk_to_rows[k] for k in keys_to_process}
        if new_rows:
            with self.timers.track("index/openie"):
                ner_dict, triple_dict = self.openie.batch_openie(new_rows)
            self.merge_openie_results(all_openie_info, new_rows, ner_dict, triple_dict)
        if self.global_config.save_openie:
            self.save_openie_results(all_openie_info)

        triples_by_chunk = {
            row["idx"]: filter_invalid_triples(row["extracted_triples"])
            for row in all_openie_info
        }
        chunk_ids = list(chunk_to_rows.keys())
        chunk_triples = [
            [tuple(text_processing(t)) for t in triples_by_chunk.get(cid, [])]
            for cid in chunk_ids
        ]
        entity_nodes, chunk_triple_entities = extract_entity_nodes(chunk_triples)
        facts = flatten_facts(chunk_triples)

        with self.timers.track("index/embed_entities"):
            self.entity_embedding_store.insert_strings(entity_nodes)
        with self.timers.track("index/embed_facts"):
            self.fact_embedding_store.insert_strings([_fact_text(f) for f in facts])

        if self.global_config.skip_graph:
            self.ready_to_retrieve = False
            return

        with self.timers.track("index/graph_build"):
            self.graph.add_fact_edges(chunk_ids, chunk_triples)
            num_new_chunks = self.graph.add_passage_edges(chunk_ids, chunk_triple_entities)
            if num_new_chunks > 0:
                self._add_synonymy_edges()
                # register all store nodes (entities first, passages second)
                self.graph.register_nodes(self.entity_embedding_store.get_all_ids())
                self.graph.register_nodes(chunk_ids)
                self.graph.mark_chunks_indexed(chunk_ids)
                self.graph.save(self._graph_path)
                logger.info("Graph: %s", self.get_graph_info())

        self.ready_to_retrieve = False

    def _add_synonymy_edges(self):
        """Device kNN over entity embeddings -> similarity edges."""
        cfg = self.global_config
        entity_ids = self.entity_embedding_store.get_all_ids()
        if not entity_ids:
            return
        rows = self.entity_embedding_store.get_all_id_to_rows()
        contents = {eid: rows[eid]["content"] for eid in entity_ids}
        embs = self.entity_embedding_store.get_embeddings_matrix(entity_ids)
        # the builder consumes at most max_neighbors edges above the
        # threshold from each descending neighbour list, so a k past
        # max_neighbors + self gives identical edges
        k_needed = min(cfg.synonymy_edge_topk, cfg.synonymy_edge_max_neighbors + 8)
        with self.timers.track("index/synonymy_knn"):
            p_rows, p_cols, p_scores = retrieve_knn_pairs(
                embs,
                embs,
                len(entity_ids),
                k=k_needed,
                sim_threshold=cfg.synonymy_edge_sim_threshold,
                query_batch_size=cfg.synonymy_edge_query_batch_size,
                key_batch_size=cfg.synonymy_edge_key_batch_size,
                device=self.device,
            )
        knn_indices: List[List[int]] = [[] for _ in entity_ids]
        knn_scores: List[List[float]] = [[] for _ in entity_ids]
        for r, c, s in zip(p_rows, p_cols, p_scores):
            knn_indices[r].append(int(c))
            knn_scores[r].append(float(s))
        num = self.graph.add_synonymy_edges(
            entity_ids,
            contents,
            knn_indices,
            knn_scores,
            sim_threshold=cfg.synonymy_edge_sim_threshold,
            max_neighbors=cfg.synonymy_edge_max_neighbors,
        )
        logger.info("Added %d synonymy edges", num)

    # ------------------------------------------------------------------
    # OpenIE results persistence (the JAX package's format)
    # ------------------------------------------------------------------
    def load_existing_openie(
        self, chunk_keys, ignore_force: bool = False
    ) -> Tuple[List[dict], Set[str]]:
        """``ignore_force=True`` reads the persisted results even under
        force_openie_from_scratch (bookkeeping must see what is on disk)."""
        keys_to_process: Set[str] = set()
        if (
            ignore_force or not self.global_config.force_openie_from_scratch
        ) and os.path.isfile(self.openie_results_path):
            with open(self.openie_results_path, encoding="utf-8") as f:
                all_info = json.load(f).get("docs", [])
            for info in all_info:
                info["idx"] = compute_mdhash_id(info["passage"], "chunk-")
            existing = {info["idx"] for info in all_info}
            keys_to_process = {k for k in chunk_keys if k not in existing}
        else:
            all_info = []
            keys_to_process = set(chunk_keys)
        return all_info, keys_to_process

    def merge_openie_results(self, all_openie_info, chunks_to_save, ner_dict, triple_dict):
        for chunk_key, row in chunks_to_save.items():
            ner = ner_dict.get(chunk_key)
            triples = triple_dict.get(chunk_key)
            all_openie_info.append(
                {
                    "idx": chunk_key,
                    "passage": row["content"],
                    "extracted_entities": ner.unique_entities if ner else [],
                    "extracted_triples": triples.triples if triples else [],
                }
            )
        return all_openie_info

    def save_openie_results(self, all_openie_info: List[dict]):
        chars = sum(len(e) for c in all_openie_info for e in c["extracted_entities"])
        words = sum(len(e.split()) for c in all_openie_info for e in c["extracted_entities"])
        n = sum(len(c["extracted_entities"]) for c in all_openie_info)
        payload = {
            "docs": all_openie_info,
            "avg_ent_chars": round(chars / n, 4) if n else 0,
            "avg_ent_words": round(words / n, 4) if n else 0,
        }
        tmp = self.openie_results_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.openie_results_path)

    def _save_chunk_metadata(self):
        tmp = self._chunk_metadata_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chunk_metadata, f)
        os.replace(tmp, self._chunk_metadata_path)

    def get_graph_info(self) -> Dict[str, int]:
        """Graph health stats; category counts come from insertion-time tags."""
        num_phrase = len(set(self.entity_embedding_store.get_all_ids()))
        num_passage = len(set(self.chunk_embedding_store.get_all_ids()))
        num_extracted = len(self.fact_embedding_store.get_all_ids())
        if self.graph.needs_category_backfill:
            fact_ids = self.fact_embedding_store.get_all_ids()
            rows = self.fact_embedding_store.get_rows(fact_ids)
            fact_pairs = []
            for fid in fact_ids:
                triple = _parse_fact_text(rows[fid]["content"])
                fact_pairs.append(
                    (
                        compute_mdhash_id(triple[0], prefix="entity-"),
                        compute_mdhash_id(triple[2], prefix="entity-"),
                    )
                )
            self.graph.backfill_edge_categories(fact_pairs)
        cats = self.graph.edge_category_counts()
        return {
            "num_phrase_nodes": num_phrase,
            "num_passage_nodes": num_passage,
            "num_total_nodes": num_phrase + num_passage,
            "num_extracted_triples": num_extracted,
            "num_fact_edges": cats["fact"],
            "num_triples_with_passage_node": cats["passage"],
            "num_synonymy_triples": cats["synonymy"],
            "num_total_triples": self.graph.num_edges,
        }

    # ==================================================================
    # Deletion
    # ==================================================================
    def delete(self, docs_to_delete: List[str]):
        """Remove documents, as the JAX package does.

        Only entities and facts that no surviving chunk references are
        removed; fact edges shared with surviving chunks keep their full
        accumulated weight (the deleted chunk's +1 included), so the
        post-delete graph depends on the order of operations and is not the
        graph a scratch build of the survivors would give. Deletion is
        host-only bookkeeping (stores and graph refcounts): it does not
        build the device graph, and the next retrieve rebuilds the device
        state with the sticky capacities.
        """
        all_openie_info = self._ensure_host_refcounts()

        current = set(self.chunk_embedding_store.get_all_texts())
        docs_to_delete = [d for d in docs_to_delete if d in current]
        chunk_ids_to_delete = {
            self.chunk_embedding_store.text_to_hash_id[d] for d in docs_to_delete
        }
        if not chunk_ids_to_delete:
            return
        triples_to_delete, remaining = [], []
        triples_by_chunk: Dict[str, List] = {}
        for doc in all_openie_info:
            proc = [
                tuple(text_processing(t))
                for t in filter_invalid_triples(doc["extracted_triples"])
            ]
            triples_by_chunk[doc["idx"]] = proc
            if doc["idx"] in chunk_ids_to_delete:
                triples_to_delete.append(proc)
            else:
                remaining.append(doc)

        affected = set(flatten_facts(triples_to_delete))
        # a triple is unreferenced when no remaining chunk contains it
        still_referenced: Set[Tuple] = set()
        for doc in remaining:
            still_referenced.update(triples_by_chunk.get(doc["idx"], []))
        unreferenced_triples = [t for t in affected if t not in still_referenced]

        orphaned_entities, _ = self.graph.remove_chunk_refs(
            chunk_ids_to_delete,
            {cid: triples_by_chunk.get(cid, []) for cid in chunk_ids_to_delete},
        )

        fact_ids = []
        for t in unreferenced_triples:
            fid = self.fact_embedding_store.text_to_hash_id.get(_fact_text(t))
            if fid:
                fact_ids.append(fid)

        logger.info(
            "Deleting %d chunks, %d facts, %d entities",
            len(chunk_ids_to_delete), len(fact_ids), len(orphaned_entities),
        )

        self.save_openie_results(remaining)
        self.entity_embedding_store.delete(list(orphaned_entities))
        self.fact_embedding_store.delete(fact_ids)
        self.chunk_embedding_store.delete(list(chunk_ids_to_delete))
        for cid in chunk_ids_to_delete:
            self.chunk_metadata.pop(cid, None)
        self._save_chunk_metadata()

        self.graph.delete_vertices(orphaned_entities | chunk_ids_to_delete)
        self.graph.save(self._graph_path)
        self.ready_to_retrieve = False

    # ==================================================================
    # Retrieval preparation
    # ==================================================================
    def _ensure_host_refcounts(self):
        """Rebuild entity->chunk refcounts from the OpenIE JSON when the graph
        state lacks them (host only). Synonymy edges cannot be rebuilt this
        way; a warning says to re-index. Returns the loaded OpenIE info."""
        all_openie_info, _ = self.load_existing_openie([], ignore_force=True)
        has_triples = any(
            filter_invalid_triples(d["extracted_triples"]) for d in all_openie_info
        )
        if all_openie_info and has_triples and not self.graph.ent_node_to_chunk_ids:
            logger.warning(
                "Graph state is missing its refcounts (absent or legacy "
                "kg_builder.pickle); rebuilding fact+passage edges from "
                "openie_results.json. Synonymy edges CANNOT be rebuilt "
                "this way — re-index with force_index_from_scratch=True "
                "to restore them."
            )
            chunk_ids = [d["idx"] for d in all_openie_info]
            chunk_triples = [
                [tuple(text_processing(t)) for t in filter_invalid_triples(d["extracted_triples"])]
                for d in all_openie_info
            ]
            self.graph.add_fact_edges(chunk_ids, chunk_triples)
            _, chunk_triple_entities = extract_entity_nodes(chunk_triples)
            self.graph.add_passage_edges(chunk_ids, chunk_triple_entities)
        return all_openie_info

    def prepare_retrieval_objects(self):
        logger.info("Preparing retrieval objects")
        cfg = self.global_config

        self.entity_node_keys = list(self.entity_embedding_store.get_all_ids())
        self.passage_node_keys = list(self.chunk_embedding_store.get_all_ids())
        self.fact_node_keys = list(self.fact_embedding_store.get_all_ids())

        # self-heal: make sure every store node exists in the graph
        self.graph.register_nodes(self.entity_node_keys)
        self.graph.register_nodes(self.passage_node_keys)

        self._ensure_host_refcounts()

        coo_np, node_cap, edge_cap = compile_device_graph(
            self.graph,
            node_capacity=self._capacities["node"],
            edge_capacity=self._capacities["edge"],
            capacity_factor=cfg.graph_capacity_factor,
        )
        self._capacities["node"], self._capacities["edge"] = node_cap, edge_cap

        graph_dev = coo_np
        if cfg.ppr_format == "ell":
            # ELL row caps: tight on the first build; a re-index first tries
            # the previous caps as minimums and, if the graph outgrew any of
            # them, rebuilds once with graph_capacity_factor headroom (the
            # JAX package's policy, kept so the two layouts stay
            # array-identical)
            def build_ell(min_caps):
                return ell_from_coo(
                    coo_np.src, coo_np.dst, coo_np.w_norm, coo_np.dangling,
                    int(coo_np.num_nodes), node_cap, min_caps=min_caps,
                )

            prev_caps = self._capacities.get("ell")
            graph_dev = build_ell(prev_caps)
            new_caps = ell_caps(graph_dev)
            if prev_caps is not None and new_caps != prev_caps:
                f = cfg.graph_capacity_factor

                def grow(c):
                    return -(-int(np.ceil(c * f)) // 128) * 128 if c else 0

                headroom = {
                    "bucket_rows": tuple(grow(c) for c in new_caps["bucket_rows"]),
                    "hub_rows": grow(new_caps["hub_rows"]),
                    "n_hub_cap": grow(new_caps["n_hub_cap"]),
                }
                graph_dev = build_ell(headroom)
                new_caps = ell_caps(graph_dev)
            self._capacities["ell"] = new_caps

        fact_cap = pick_capacity(
            len(self.fact_node_keys), self._capacities["fact"], cfg.graph_capacity_factor, 128
        )
        passage_cap = pick_capacity(
            len(self.passage_node_keys), self._capacities["passage"], cfg.graph_capacity_factor, 128
        )
        self._capacities["fact"], self._capacities["passage"] = fact_cap, passage_cap

        pad_slot = node_cap - 1

        # the embedding width from any non-empty store (an empty fact store
        # must not fall back to cfg.embedding_dim while passages use the
        # encoder's real width)
        dim = None
        for store, keys in (
            (self.fact_embedding_store, self.fact_node_keys),
            (self.chunk_embedding_store, self.passage_node_keys),
            (self.entity_embedding_store, self.entity_node_keys),
        ):
            if keys:
                mat = store.get_embeddings_matrix(keys[:1])
                if mat.size:
                    dim = mat.shape[1]
                    break
        dim = dim or getattr(self.embedding_model, "embedding_dim", None) or cfg.embedding_dim

        def padded_matrix(store, keys, cap):
            mat = store.get_embeddings_matrix(keys)
            out = np.zeros((cap, dim), dtype=np.float32)
            if mat.size:
                out[: mat.shape[0]] = mat
            return out

        self.fact_embeddings = padded_matrix(self.fact_embedding_store, self.fact_node_keys, fact_cap)
        self.passage_embeddings = padded_matrix(
            self.chunk_embedding_store, self.passage_node_keys, passage_cap
        )

        fact_subj = np.full(fact_cap, pad_slot, dtype=np.int32)
        fact_obj = np.full(fact_cap, pad_slot, dtype=np.int32)
        rows = self.fact_embedding_store.get_rows(self.fact_node_keys)
        self._fact_tuples: List[Tuple[str, str, str]] = []
        for i, fid in enumerate(self.fact_node_keys):
            triple = _parse_fact_text(rows[fid]["content"])
            self._fact_tuples.append(triple)
            si = self.graph.node_to_idx.get(compute_mdhash_id(triple[0], prefix="entity-"))
            oi = self.graph.node_to_idx.get(compute_mdhash_id(triple[2], prefix="entity-"))
            fact_subj[i] = si if si is not None else pad_slot
            fact_obj[i] = oi if oi is not None else pad_slot

        node_chunk_counts = np.zeros(node_cap, dtype=np.float32)
        for ent, chunks in self.graph.ent_node_to_chunk_ids.items():
            idx = self.graph.node_to_idx.get(ent)
            if idx is not None:
                node_chunk_counts[idx] = len(chunks)

        passage_node_ids = np.full(passage_cap, pad_slot, dtype=np.int32)
        for i, pid in enumerate(self.passage_node_keys):
            passage_node_ids[i] = self.graph.node_to_idx[pid]

        dev = self.device
        self._index_state = RetrievalIndex(
            graph=graph_dev.to(dev),
            fact_subj_node=torch.from_numpy(fact_subj).to(dev),
            fact_obj_node=torch.from_numpy(fact_obj).to(dev),
            node_chunk_counts=torch.from_numpy(node_chunk_counts).to(dev),
            passage_node_ids=torch.from_numpy(passage_node_ids).to(dev),
            num_facts=len(self.fact_node_keys),
            num_passages=len(self.passage_node_keys),
        )
        # compute_dtype="bfloat16" keeps the corpus matrices resident in bf16
        emb_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self._fact_emb_dev = torch.from_numpy(self.fact_embeddings).to(dev, emb_dtype)
        self._passage_emb_dev = torch.from_numpy(self.passage_embeddings).to(dev, emb_dtype)
        self.ready_to_retrieve = True

    # ==================================================================
    # Query encoding
    # ==================================================================
    def get_query_embeddings(self, queries: List[str]):
        todo = [
            q
            for q in queries
            if q not in self.query_to_embedding["triple"]
            or q not in self.query_to_embedding["passage"]
        ]
        if not todo:
            return
        fact_embs = self.embedding_model.batch_encode(
            todo, instruction=get_query_instruction("query_to_fact"), norm=True
        )
        passage_embs = self.embedding_model.batch_encode(
            todo, instruction=get_query_instruction("query_to_passage"), norm=True
        )
        if fact_embs.ndim == 1:
            fact_embs, passage_embs = fact_embs[None], passage_embs[None]
        for q, fe, pe in zip(todo, fact_embs, passage_embs):
            self.query_to_embedding["triple"][q] = fe
            self.query_to_embedding["passage"][q] = pe

    # ==================================================================
    # Retrieval (batched)
    # ==================================================================
    def retrieve(
        self,
        queries: List[str],
        num_to_retrieve: Optional[int] = None,
        gold_docs: Optional[List[List[str]]] = None,
    ):
        cfg = self.global_config
        if num_to_retrieve is None:
            num_to_retrieve = cfg.retrieval_top_k
        if not self.ready_to_retrieve:
            self.prepare_retrieval_objects()
        retrieve_start = time.time()

        embed_start = time.time()
        self.get_query_embeddings(queries)
        self.embed_time += time.time() - embed_start

        with device_profile(cfg.profile_log_dir, self.device):
            results = self._retrieve_batches(
                queries, num_to_retrieve, len(self.fact_node_keys),
                len(self.passage_node_keys), cfg.linking_top_k,
            )

        self.all_retrieval_time += time.time() - retrieve_start
        logger.info(
            "Retrieval: total %.2fs, rerank %.2fs, graph-search %.2fs",
            self.all_retrieval_time,
            self.rerank_time,
            self.ppr_time,
        )

        if gold_docs is not None:
            evaluator = RetrievalRecall(self.global_config)
            overall, _ = evaluator.calculate_metric_scores(
                gold_docs, [r.docs for r in results], RETRIEVAL_K_LIST
            )
            logger.info("Retrieval eval: %s", overall)
            return results, overall
        return results

    def _rerank_candidates(
        self, batch_queries, cand_idx, cand_vals, link_top_k, b_pad, num_facts
    ):
        """Recognition-memory filtering, fanned out host-side (LLM-bound).

        Returns the elapsed seconds instead of adding to self.rerank_time:
        with bucket pipelining this runs on worker threads."""
        rerank_start = time.time()
        top_idx = np.zeros((b_pad, link_top_k), dtype=np.int32)
        top_mask = np.zeros((b_pad, link_top_k), dtype=np.float32)
        sel_scores = np.zeros((b_pad, link_top_k), dtype=np.float32)
        batch_top_facts: List[List[Tuple]] = [[] for _ in range(b_pad)]
        if num_facts > 0:
            rerank_inputs = []
            for i, q in enumerate(batch_queries):
                cands = [int(j) for j, v in zip(cand_idx[i], cand_vals[i]) if v > -np.inf]
                items = [self._fact_tuples[j] for j in cands]
                rerank_inputs.append((q, items, cands))

            def _rerank(args):
                q, items, cands = args
                return self.rerank_filter.rerank(q, items, cands, link_top_k)

            reranked = _fan_out(_rerank, rerank_inputs)

            for i, (sorted_idx, sorted_items, _) in enumerate(reranked):
                batch_top_facts[i] = sorted_items
                val_by_row = {int(j): float(v) for j, v in zip(cand_idx[i], cand_vals[i])}
                for k, fact_row in enumerate(sorted_idx[:link_top_k]):
                    top_idx[i, k] = fact_row
                    top_mask[i, k] = 1.0
                    sel_scores[i, k] = val_by_row.get(int(fact_row), 0.0)
        return top_idx, top_mask, sel_scores, batch_top_facts, time.time() - rerank_start

    def _run_bucket_pipeline(self, slices, prep, finish) -> List[QuerySolution]:
        """Run per-bucket (prep -> finish) stages, overlapping when enabled.

        ``prep`` = device fact scoring + host LLM rerank; ``finish`` = device
        graph search + result building. With pipelining, bucket N's rerank
        runs on worker threads while the main thread drives bucket N-1's
        PPR; completion is consumed in submission order, so results equal
        the serial ordering's.
        """
        cfg = self.global_config
        results: List[QuerySolution] = []
        if cfg.pipeline_rerank and len(slices) > 1:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            depth = max(1, cfg.pipeline_depth)
            # at most `depth` outstanding preps: each finished prep holds a
            # live [b_pad, P_pad] device score buffer until finish() runs
            with ThreadPoolExecutor(max_workers=depth) as pool:
                it = iter(slices)
                window: deque = deque()
                for s in it:
                    window.append(pool.submit(prep, s))
                    if len(window) >= depth:
                        break
                while window:
                    fut = window.popleft()
                    prepped = fut.result()
                    nxt = next(it, None)
                    if nxt is not None:
                        window.append(pool.submit(prep, nxt))
                    results.extend(finish(*prepped))
        else:
            for s in slices:
                results.extend(finish(*prep(s)))
        return results

    def _retrieve_batches(
        self, queries, num_to_retrieve, num_facts, num_passages, link_top_k
    ) -> List[QuerySolution]:
        cfg = self.global_config
        dev = self.device
        bucket = max(1, cfg.ppr_batch_size)
        sizes = sub_buckets(bucket)
        slices = [queries[s : s + bucket] for s in range(0, len(queries), bucket)]

        def prep(batch_queries):
            b_real = len(batch_queries)
            b_pad = next(b for b in sizes if b >= b_real)

            qf = np.zeros((b_pad, self.fact_embeddings.shape[1]), dtype=np.float32)
            qp = np.zeros_like(qf)
            for i, q in enumerate(batch_queries):
                qf[i] = self.query_to_embedding["triple"][q]
                qp[i] = self.query_to_embedding["passage"][q]

            topk_start = time.time()
            # DPR passage scores first: no dependency on the kept facts, so
            # the device computes them while the host reranks
            dpr_scores = batched_scores(
                torch.from_numpy(qp).to(dev), self._passage_emb_dev, cfg.compute_dtype
            )
            if num_facts > 0:
                k_cand = min(link_top_k, max(num_facts, 1))
                cand_vals_dev, cand_idx_dev = fact_topk(
                    torch.from_numpy(qf).to(dev),
                    self._fact_emb_dev,
                    num_facts,
                    k_cand,
                    cfg.compute_dtype,
                    use_fused=None if cfg.use_pallas_kernels else False,
                )
                cand_vals = cand_vals_dev.cpu().numpy()
                cand_idx = cand_idx_dev.cpu().numpy()
            else:
                cand_idx = np.zeros((b_pad, 0), dtype=np.int32)
                cand_vals = np.zeros((b_pad, 0), dtype=np.float32)
            topk_s = time.time() - topk_start

            top_idx, top_mask, sel_scores, batch_top_facts, rerank_s = self._rerank_candidates(
                batch_queries, cand_idx, cand_vals, link_top_k, b_pad, num_facts
            )
            return (batch_queries, b_real, dpr_scores, top_idx, top_mask,
                    sel_scores, batch_top_facts, rerank_s, topk_s)

        def finish(batch_queries, b_real, dpr_scores, top_idx, top_mask,
                   sel_scores, batch_top_facts, rerank_s, topk_s):
            self.rerank_time += rerank_s  # accumulated on the main thread
            self.topk_time += topk_s
            ppr_start = time.time()
            # a named range in profiler traces (profile_log_dir): seeds, PPR,
            # document top-k and the copy of the ranking to the host
            with record_function("retrieve/graph_search"):
                if num_facts > 0 and self.graph.num_edges > 0:
                    doc_scores = graph_search_batch(
                        self._index_state,
                        torch.from_numpy(sel_scores).to(dev),
                        torch.from_numpy(top_idx).to(dev),
                        torch.from_numpy(top_mask).to(dev),
                        dpr_scores,
                        link_top_k=link_top_k,
                        passage_node_weight=cfg.passage_node_weight,
                        damping=cfg.damping,
                        ppr_max_iters=cfg.ppr_max_iters,
                        ppr_tol=cfg.ppr_tol,
                        ppr_dtype=cfg.ppr_compute_dtype,
                        ppr_edge_chunks=cfg.ppr_edge_chunks,
                    )
                else:
                    valid = (torch.arange(dpr_scores.shape[1], device=dev) < num_passages)[None, :]
                    doc_scores = torch.where(
                        valid, min_max_normalize(dpr_scores, where=valid), -torch.inf
                    )
                order_dev, sorted_dev = rank_documents_topk(doc_scores, num_to_retrieve)
                order = order_dev.cpu().numpy()
                sorted_scores = sorted_dev.cpu().numpy()
            self.ppr_time += time.time() - ppr_start

            out = []
            for i in range(b_real):
                top_n = [
                    int(j)
                    for j, v in zip(order[i], sorted_scores[i])
                    if j < num_passages and v > -np.inf
                ]
                out.append(
                    self._build_result(
                        batch_queries[i],
                        top_n,
                        sorted_scores[i][: len(top_n)],
                        batch_top_facts[i],
                    )
                )
            return out

        return self._run_bucket_pipeline(slices, prep, finish)

    def _build_result(self, query, doc_indices, doc_scores, graph_seeds) -> QuerySolution:
        keys = [self.passage_node_keys[j] for j in doc_indices]
        docs = [self.chunk_embedding_store.get_row(k)["content"] for k in keys]
        metadata = [dict(self.chunk_metadata.get(k, {})) for k in keys]
        return QuerySolution(
            question=query,
            docs=docs,
            doc_scores=np.asarray(doc_scores, dtype=np.float64),
            doc_metadata=metadata,
            graph_seeds=list(graph_seeds),
        )

    # ==================================================================
    # Dense passage retrieval (no graph search)
    # ==================================================================
    def _dpr_normalized_scores(self, qp: np.ndarray, num_passages: int) -> torch.Tensor:
        """Min-max-normalized [B, P_cap] query x passage scores on the device
        (columns past ``num_passages`` are padding and score 0)."""
        return batched_normalized_scores(
            torch.from_numpy(qp).to(self.device), self._passage_emb_dev, num_passages,
            self.global_config.compute_dtype,
        )

    def dense_passage_retrieval(self, query: str):
        """Pure DPR for one query: (order over all passages, their scores)."""
        if not self.ready_to_retrieve:
            self.prepare_retrieval_objects()
        self.get_query_embeddings([query])
        num_passages = len(self.passage_node_keys)
        qp = self.query_to_embedding["passage"][query][None]
        scores = self._dpr_normalized_scores(qp, num_passages)[0, :num_passages]
        vals, order = topk_lower_index(scores, num_passages)
        return order.cpu().numpy(), vals.cpu().numpy()

    def retrieve_dpr(
        self,
        queries: List[str],
        num_to_retrieve: Optional[int] = None,
        gold_docs: Optional[List[List[str]]] = None,
    ):
        """Dense-only retrieval over the HippoRAG index: one batched
        query x passage product and a top-k on the device per sub-bucket."""
        cfg = self.global_config
        if num_to_retrieve is None:
            num_to_retrieve = cfg.retrieval_top_k
        if not self.ready_to_retrieve:
            self.prepare_retrieval_objects()
        retrieve_start = time.time()

        self.get_query_embeddings(queries)
        num_passages = len(self.passage_node_keys)
        vals, order = dense_topk(
            [self.query_to_embedding["passage"][q] for q in queries], self._passage_emb_dev,
            num_passages, min(num_to_retrieve, num_passages), cfg.ppr_batch_size, cfg.compute_dtype,
        )
        results = [self._build_result(q, order[i], vals[i], []) for i, q in enumerate(queries)]
        self.all_retrieval_time += time.time() - retrieve_start

        if gold_docs is not None:
            evaluator = RetrievalRecall(self.global_config)
            overall, _ = evaluator.calculate_metric_scores(
                gold_docs, [r.docs for r in results], RETRIEVAL_K_LIST
            )
            logger.info("DPR retrieval eval: %s", overall)
            return results, overall
        return results

    # ==================================================================
    # QA
    # ==================================================================
    def qa(self, queries: List[QuerySolution]):
        cfg = self.global_config
        all_messages = []
        for qs in queries:
            passages = qs.docs[: cfg.qa_top_k]
            prompt_user = ""
            for passage in passages:
                prompt_user += f"Wikipedia Title: {passage}\n\n"
            prompt_user += "Question: " + qs.question + "\nThought: "
            name = f"rag_qa_{cfg.dataset}"
            if not self.prompt_template_manager.is_template_name_valid(name):
                name = "rag_qa"
            all_messages.append(
                self.prompt_template_manager.render(name, prompt_user=prompt_user)
            )

        qa_results = self.qa_llm.batch_infer(all_messages, response_format=None)
        responses = [r[0] for r in qa_results]
        metadata = [r[1] for r in qa_results]

        solutions = []
        for qs, response in zip(queries, responses):
            if "Answer:" in response:
                qs.answer = response.split("Answer:")[1].strip()
            else:
                qs.answer = response.strip()
            solutions.append(qs)
        return solutions, responses, metadata

    def rag_qa(
        self,
        queries: Union[List[str], List[QuerySolution]],
        gold_docs: Optional[List[List[str]]] = None,
        gold_answers: Optional[List[List[str]]] = None,
    ):
        overall_retrieval_result = None
        if not isinstance(queries[0], QuerySolution):
            if gold_docs is not None:
                queries, overall_retrieval_result = self.retrieve(queries, gold_docs=gold_docs)
            else:
                queries = self.retrieve(queries)

        solutions, responses, metadata = self.qa(queries)
        return finish_rag_qa(
            self.global_config, solutions, responses, metadata,
            overall_retrieval_result, gold_docs, gold_answers,
        )

    def rag_qa_dpr(
        self,
        queries: Union[List[str], List[QuerySolution]],
        gold_docs: Optional[List[List[str]]] = None,
        gold_answers: Optional[List[List[str]]] = None,
    ):
        """rag_qa over the dense retriever."""
        overall_retrieval_result = None
        if not isinstance(queries[0], QuerySolution):
            if gold_docs is not None:
                queries, overall_retrieval_result = self.retrieve_dpr(queries, gold_docs=gold_docs)
            else:
                queries = self.retrieve_dpr(queries)

        solutions, responses, metadata = self.qa(queries)
        return finish_rag_qa(
            self.global_config, solutions, responses, metadata,
            overall_retrieval_result, gold_docs, gold_answers,
            log_label="DPR QA",
        )

    # ==================================================================
    # IRCoT iterative retrieval
    # ==================================================================
    def retrieve_ircot(
        self,
        queries: List[str],
        max_qa_steps: int,
        num_to_retrieve: Optional[int] = None,
        gold_docs: Optional[List[List[str]]] = None,
    ):
        if max_qa_steps < 1:
            raise ValueError("max_qa_steps must be at least 1.")
        cfg = self.global_config
        if (
            max_qa_steps > 1
            and cfg.dataset is not None
            and not self.prompt_template_manager.is_template_name_valid(f"ircot_{cfg.dataset}")
        ):
            # a multi-step run for a named dataset must not reason with the
            # generic demos; dataset=None takes the generic `ircot` template
            raise ValueError(
                f"No IRCoT template 'ircot_{cfg.dataset}' for dataset "
                f"'{cfg.dataset}'; multi-step IRCoT (max_qa_steps > 1) "
                "requires a dataset-specific template under "
                "hipporag_tpu_torch/prompts/templates/."
            )
        if num_to_retrieve is None:
            num_to_retrieve = cfg.retrieval_top_k

        # each round runs ONE batched retrieve for every still-active query
        # and fans the reasoning LLM calls out across threads; a query's
        # thoughts depend only on its own retrieval history
        n = len(queries)
        steps = self.retrieve(queries, num_to_retrieve=num_to_retrieve)
        merged_scores = [dict(zip(s.docs, s.doc_scores.tolist())) for s in steps]
        merged_meta = [dict(zip(s.docs, s.doc_metadata or [])) for s in steps]
        thoughts: List[List[str]] = [[] for _ in range(n)]
        active = list(range(n))

        for _ in range(1, max_qa_steps):
            if not active:
                break

            def _reason(i):
                ranked = sorted(merged_scores[i], key=merged_scores[i].get, reverse=True)
                return reason_step(
                    cfg.dataset, self.prompt_template_manager, queries[i],
                    ranked[:num_to_retrieve], thoughts[i], self.qa_llm,
                )

            new_thoughts = _fan_out(_reason, active)

            followups = []
            still_active = []
            for i, thought in zip(active, new_thoughts):
                thoughts[i].append(thought)
                if "So the answer is:" not in thought:
                    followups.append(thought)
                    still_active.append(i)
            active = still_active
            if not active:
                break

            steps = self.retrieve(followups, num_to_retrieve=num_to_retrieve)
            for i, step in zip(active, steps):
                for doc, score in zip(step.docs, step.doc_scores.tolist()):
                    merged_scores[i][doc] = max(merged_scores[i].get(doc, float("-inf")), score)
                merged_meta[i].update(dict(zip(step.docs, step.doc_metadata or [])))

        results = []
        for i, query in enumerate(queries):
            ranked_items = sorted(merged_scores[i].items(), key=lambda kv: kv[1], reverse=True)
            results.append(
                QuerySolution(
                    question=query,
                    docs=[d for d, _ in ranked_items],
                    doc_scores=np.asarray([s for _, s in ranked_items]),
                    thoughts=thoughts[i],
                    doc_metadata=[merged_meta[i].get(d, {}) for d, _ in ranked_items],
                )
            )

        if gold_docs is None:
            return results
        evaluator = RetrievalRecall(self.global_config)
        overall, _ = evaluator.calculate_metric_scores(
            gold_docs, [r.docs for r in results], RETRIEVAL_K_LIST
        )
        return results, overall

    def answer_with_ircot(
        self,
        queries: List[str],
        gold_docs=None,
        gold_answers=None,
        max_qa_steps: int = 2,
    ):
        retrieved = self.retrieve_ircot(queries, max_qa_steps=max_qa_steps, gold_docs=gold_docs)
        ircot_retrieval_eval = None
        if gold_docs is not None:
            retrieved, ircot_retrieval_eval = retrieved
        out = self.rag_qa(retrieved, gold_docs=gold_docs, gold_answers=gold_answers)
        if gold_answers is not None and ircot_retrieval_eval is not None:
            # rag_qa got QuerySolutions, so its retrieval-eval slot is None;
            # put in the IRCoT retrieval eval the caller asked for
            solutions, responses, metadata, _, qa_eval = out
            return solutions, responses, metadata, ircot_retrieval_eval, qa_eval
        return out
