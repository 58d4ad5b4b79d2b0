"""One deployment of the port, built from a configuration file and a seed.

The corpus, its OpenIE output and the index texts' vectors come from the
seed; the port indexes them through ``HippoRAG.index`` (reading the OpenIE
output where ``load_existing_openie`` looks for it) and prepares its
retrieval state. Nothing is fetched: the LLM and, for the index texts, the
embedder are the benchmark's stand-ins (``adapters.py``). Questions are
encoded by the encoder the configuration's ``query_encoder`` names
(``encoders/<name>.py``, its weights drawn from the seed) inside each
engine call; without that key their stand-in vectors are made before the
call.
"""

from __future__ import annotations

import json
import tempfile
import time

import torch

from .corpus import Corpus, QuestionStream


class Deployment:
    def __init__(self, config: dict, seed: int, device):
        from hipporag_tpu_torch.config import BaseConfig
        from hipporag_tpu_torch.hipporag import HippoRAG

        from .adapters import EchoFilterLLM, StandInEmbedder

        self.config = config
        self.seed = seed
        self.device = torch.device(device)
        self.timings = {}
        t0 = time.perf_counter()
        self.corpus = Corpus(seed, config["corpus"])
        self.questions = QuestionStream(self.corpus, seed)
        self.timings["corpus_s"] = time.perf_counter() - t0

        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
        hcfg = BaseConfig(save_dir=self._tmp.name, **config["hipporag"])
        self.encoder = None
        if config.get("query_encoder"):
            from .encoders import load

            self.encoder = load(config["query_encoder"]).program(config, hcfg, self.device, seed)
            self.timings["encoder_s"] = time.perf_counter() - t0
        self.embedder = StandInEmbedder(hcfg, int(config["index_vectors"]["dim"]), self.device, self.encoder)
        self.rag = HippoRAG(hcfg, extraction_llm=EchoFilterLLM(hcfg), embedding_model=self.embedder,
                            device=self.device)
        with open(self.rag.openie_results_path, "w") as fh:
            json.dump({"docs": self.corpus.openie()}, fh)
        self.timings["build_s"] = time.perf_counter() - t0
        self.rag.index(self.corpus.docs)
        self.timings["index_s"] = time.perf_counter() - t0
        self.rag.prepare_retrieval_objects()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timings["prepare_s"] = time.perf_counter() - t0
        self.graph_info = self.rag.get_graph_info()

    def take_questions(self, count: int) -> list:
        """``count`` fresh questions, the inputs of the next engine call;
        without a question encoder their vectors are made now."""
        qs = self.questions.take(count)
        if self.encoder is None:
            self.embedder.set_questions(qs)
        return qs

    def query_rows(self, questions) -> dict:
        """The program's own fact and passage rows of ``questions`` it has
        asked: {"triple": {question: row}, "passage": {...}}."""
        from .reference.encoders import KINDS

        held = self.rag.query_to_embedding
        return {kind: {q: held[kind][q] for q in questions} for kind in KINDS}

    def close(self) -> None:
        self._tmp.cleanup()

