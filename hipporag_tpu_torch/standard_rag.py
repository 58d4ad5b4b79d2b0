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

from .config import BaseConfig
from .evaluation import RetrievalRecall
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
from .ops.scoring import dense_topk

logger = get_logger(__name__)

RETRIEVAL_K_LIST = [1, 2, 5, 10, 20, 30, 50, 100, 150, 200]


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
        mat = self.chunk_embedding_store.get_embeddings_matrix(self.passage_node_keys)
        self.passage_embeddings = mat
        self._passage_emb_dev = torch.from_numpy(np.ascontiguousarray(mat, np.float32)).to(self.device)
        self.ready_to_retrieve = True

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
            if gold_docs is not None:
                overall, _ = RetrievalRecall(cfg).calculate_metric_scores(
                    gold_docs, [[] for _ in results], RETRIEVAL_K_LIST
                )
                return results, overall
            return results

        with span("retrieve", questions=len(queries)):
            todo = [q for q in queries if q not in self.query_to_embedding]
            if todo:
                embs = self.embedding_model.batch_encode(
                    todo, instruction=get_query_instruction("query_to_passage"), norm=True
                )
                if embs.ndim == 1:
                    embs = embs[None]
                for q, e in zip(todo, embs):
                    self.query_to_embedding[q] = e

            n_passages = len(self.passage_node_keys)
            with full_f32():
                vals, order = dense_topk(
                    [self.query_to_embedding[q] for q in queries], self._passage_emb_dev, n_passages,
                    min(num_to_retrieve, n_passages), cfg.ppr_batch_size, cfg.compute_dtype,
                )
            results = []
            for i, q in enumerate(queries):
                keys = [self.passage_node_keys[j] for j in order[i]]
                results.append(
                    QuerySolution(
                        question=q,
                        docs=[self.chunk_embedding_store.get_row(key)["content"] for key in keys],
                        doc_scores=vals[i].astype(np.float64),
                        doc_metadata=[dict(self.chunk_metadata.get(key, {})) for key in keys],
                    )
                )

        if gold_docs is not None:
            evaluator = RetrievalRecall(cfg)
            overall, _ = evaluator.calculate_metric_scores(
                gold_docs, [r.docs for r in results], RETRIEVAL_K_LIST
            )
            return results, overall
        return results

    def dense_passage_retrieval(self, query: str):
        """Full ranking over all passages: (order, scores), the contract of
        ``HippoRAG.dense_passage_retrieval``."""
        result = self.retrieve([query], num_to_retrieve=len(self.passage_node_keys))[0]
        keys = {k: i for i, k in enumerate(self.passage_node_keys)}
        order = np.asarray(
            [keys[self.chunk_embedding_store.text_to_hash_id[d]] for d in result.docs]
        )
        return order, np.asarray(result.doc_scores)

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
