"""StandardRAG on PyTorch (port of ``hipporag_tpu/standard_rag.py``).

The dense-retrieval baseline with the HippoRAG API surface: the same
index / delete / retrieve / rag_qa lifecycle, with retrieval as pure dense
passage scoring (no OpenIE, no graph, no PPR): one batched product, a
min-max normalization and a top-k on ``device`` per bucket of queries.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from . import hipporag
from .config import BaseConfig
from .hipporag import build_results, dense_topk, passage_tables, with_recall
from .llm import get_llm
from .preprocessing import get_preprocessor
from .prompts import PromptTemplateManager, get_query_instruction
from .storage import get_embedding_store
from .utils.logging import get_logger
from .utils.misc import Chunk, QuerySolution
from .utils.precision import full_f32
from .utils.qa_utils import finish_rag_qa
from .utils.timing import StageTimers, span

from .embedding import get_embedding_model
from .ops.scoring import batched_normalized_scores, sub_buckets

logger = get_logger(__name__)

RETRIEVAL_K_LIST = hipporag.RETRIEVAL_K_LIST  # the recall cut-offs of with_recall


class StandardRAG:
    def __init__(
        self,
        global_config: Optional[BaseConfig] = None,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ):
        if global_config is None:
            global_config = BaseConfig()
        for key, value in kwargs.items():
            if value is not None:
                if not hasattr(global_config, key):
                    raise ValueError(f"Unknown config field: {key}")
                setattr(global_config, key, value)
        self.global_config = global_config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")

        llm_label = global_config.llm_name.replace("/", "_")
        emb_label = global_config.embedding_model_name.replace("/", "_")
        self.working_dir = os.path.join(global_config.save_dir, f"{llm_label}_{emb_label}")
        os.makedirs(self.working_dir, exist_ok=True)

        self.llm = get_llm(global_config)
        self.qa_llm = self.llm
        self.embedding_model = get_embedding_model(global_config, self.device)
        if hasattr(self.embedding_model, "attach_cache"):
            self.embedding_model.attach_cache(
                os.path.join(self.working_dir, "embedding_cache.sqlite")
            )
        self.prompt_template_manager = PromptTemplateManager()
        self.preprocessor = get_preprocessor(global_config)
        self.chunk_embedding_store = get_embedding_store(
            self.embedding_model,
            self.working_dir,
            global_config.embedding_batch_size,
            "chunk",
            global_config,
        )
        self._chunk_metadata_path = os.path.join(self.working_dir, "chunk_metadata.json")
        self.chunk_metadata: Dict[str, Dict] = {}
        if os.path.exists(self._chunk_metadata_path):
            with open(self._chunk_metadata_path) as f:
                self.chunk_metadata = json.load(f)

        self.timers = StageTimers()
        self.ready_to_retrieve = False
        self.query_to_embedding: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    def index(self, docs: List[Union[str, Chunk]]):
        chunks = self.preprocessor.preprocess(docs)
        with self.timers.track("index/embed_chunks"):
            self.chunk_embedding_store.insert_strings([c.content for c in chunks])
        for chunk in chunks:
            cid = self.chunk_embedding_store.get_hash_id(chunk.content)
            meta = dict(chunk.metadata)
            if chunk.source_id is not None:
                meta["source_id"] = chunk.source_id
            self.chunk_metadata[cid] = meta
        self._save_chunk_metadata()
        self.ready_to_retrieve = False

    def delete(self, docs_to_delete: List[str]):
        current = set(self.chunk_embedding_store.get_all_texts())
        to_delete = [d for d in docs_to_delete if d in current]
        ids = [self.chunk_embedding_store.text_to_hash_id[d] for d in to_delete]
        self.chunk_embedding_store.delete(ids)
        for cid in ids:
            self.chunk_metadata.pop(cid, None)
        self._save_chunk_metadata()
        self.ready_to_retrieve = False

    def _save_chunk_metadata(self):
        tmp = self._chunk_metadata_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chunk_metadata, f)
        os.replace(tmp, self._chunk_metadata_path)

    # ------------------------------------------------------------------
    def prepare_retrieval_objects(self):
        self.passage_node_keys = list(self.chunk_embedding_store.get_all_ids())
        self._passage_contents, self._passage_metadata = passage_tables(
            self.chunk_embedding_store, self.passage_node_keys, self.chunk_metadata
        )
        mat = self.chunk_embedding_store.get_embeddings_matrix(self.passage_node_keys)
        self.passage_embeddings = mat
        self._passage_emb_dev = torch.from_numpy(np.ascontiguousarray(mat, np.float32)).to(self.device)
        self.ready_to_retrieve = True

    def _dense_scores(self, qp: np.ndarray) -> torch.Tensor:
        return batched_normalized_scores(
            torch.from_numpy(qp).to(self.device), self._passage_emb_dev, len(self.passage_node_keys),
            self.global_config.compute_dtype,
        )

    def _dense_topk(self, queries: List[str], k: int):
        """Encodes the questions it has no vector for, then ranks every
        question's top ``k`` passages: host (values [n, k], indices [n, k])."""
        todo = [q for q in queries if q not in self.query_to_embedding]
        if todo:
            embs = self.embedding_model.batch_encode(
                todo, instruction=get_query_instruction("query_to_passage"), norm=True
            )
            if embs.ndim == 1:
                embs = embs[None]
            for q, e in zip(todo, embs):
                self.query_to_embedding[q] = e
        with full_f32():
            return dense_topk(
                queries, self.query_to_embedding, self._dense_scores, len(self.passage_node_keys), k,
                sub_buckets(self.global_config.ppr_batch_size),
            )

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
        if not self.passage_node_keys:
            # empty index: empty but usable results, as HippoRAG gives
            results = [QuerySolution(question=q, docs=[], doc_scores=np.zeros(0)) for q in queries]
            return with_recall(cfg, results, gold_docs)

        with span("retrieve", questions=len(queries)):
            vals, order = self._dense_topk(queries, min(num_to_retrieve, len(self.passage_node_keys)))
            results = build_results(self._passage_contents, self._passage_metadata, queries, order, vals)
        return with_recall(cfg, results, gold_docs)

    def dense_passage_retrieval(self, query: str):
        """Full ranking over all passages: (order, scores), the contract of
        ``HippoRAG.dense_passage_retrieval``."""
        if not self.ready_to_retrieve:
            self.prepare_retrieval_objects()
        if not self.passage_node_keys:
            return np.zeros(0, np.int64), np.zeros(0)
        with span("retrieve", questions=1):
            vals, order = self._dense_topk([query], len(self.passage_node_keys))
        return order[0], vals[0].astype(np.float64)

    # ------------------------------------------------------------------
    def qa(self, queries: List[QuerySolution]):
        cfg = self.global_config
        all_messages = []
        for qs in queries:
            prompt_user = ""
            for passage in qs.docs[: cfg.qa_top_k]:
                prompt_user += f"Wikipedia Title: {passage}\n\n"
            prompt_user += "Question: " + qs.question + "\nThought: "
            name = f"rag_qa_{cfg.dataset}"
            if not self.prompt_template_manager.is_template_name_valid(name):
                name = "rag_qa"
            all_messages.append(self.prompt_template_manager.render(name, prompt_user=prompt_user))
        qa_results = self.qa_llm.batch_infer(all_messages, response_format=None)
        responses = [r[0] for r in qa_results]
        metadata = [r[1] for r in qa_results]
        for qs, response in zip(queries, responses):
            qs.answer = (
                response.split("Answer:")[1].strip() if "Answer:" in response else response.strip()
            )
        return queries, responses, metadata

    def rag_qa(
        self,
        queries,
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
            log_label="StandardRAG QA",
        )
