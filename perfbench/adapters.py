"""What the benchmark hands the port in place of outside services: an
embedding model and an LLM, each behind the port's own interface.

- :class:`StandInEmbedder` gives index texts (``instruction=""``: passages,
  entity phrases, facts) the benchmark's hashing vectors, computed in bulk
  on the device. Questions (any other instruction) go to the question
  encoder where the configuration names one (``encoders/``), which encodes
  them inside the engine call; without one they are looked up in the
  vectors of the questions handed to it last (``set_questions``), made
  before the engine call that asks them. It keeps no on-disk cache.
- :class:`EchoFilterLLM` answers the recognition-memory filter with the
  candidate facts it was shown, so the filter keeps every candidate and the
  reference knows its decision. It refuses any other prompt: OpenIE output
  is given to the port on disk, so no other call is expected.
"""

from __future__ import annotations

from typing import List

import numpy as np

from hipporag_tpu_torch.embedding.base import BaseEmbeddingModel
from hipporag_tpu_torch.llm.base import BaseLLM

from . import vectors

_FACTS_IN = "[[ ## fact_before_filter ## ]]\n"


class StandInEmbedder(BaseEmbeddingModel):
    def __init__(self, global_config, dim: int, device, questions: BaseEmbeddingModel = None):
        super().__init__(global_config)
        self.embedding_dim = dim
        self.device = device
        self.questions = questions
        self._rows: dict = {}
        self._table = np.zeros((0, dim), np.float32)

    def attach_cache(self, cache_path: str):
        """No on-disk cache: every vector is made in memory."""

    def format_with_instruction(self, text: str, instruction: str) -> str:
        return text  # symmetric, as the hashing embedder

    def set_questions(self, questions: List[str]) -> None:
        """Make the vectors of ``questions`` now, before they are asked; they
        replace the vectors of the questions handed over before."""
        fresh = list(dict.fromkeys(questions))
        self._table = vectors.embed_texts(fresh, self.embedding_dim, self.device).cpu().numpy()
        self._rows = {q: i for i, q in enumerate(fresh)}

    def batch_encode(self, texts, instruction: str = "", norm=None):
        if instruction:
            if self.questions is not None:
                return self.questions.batch_encode(texts, instruction, norm)
            return super().batch_encode(texts, instruction, norm)
        single = isinstance(texts, str)
        texts = [texts] if single else list(texts)
        out = vectors.embed_texts(texts, self.embedding_dim, self.device).cpu().numpy()
        return out[0] if single else out

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        missing = [t for t in texts if t not in self._rows]
        if missing:
            raise KeyError(f"{len(missing)} questions were not handed over before the call, e.g. {missing[0]!r}")
        return self._table[[self._rows[t] for t in texts]]


class EchoFilterLLM(BaseLLM):
    def infer(self, messages, **kwargs):
        content = messages[-1]["content"]
        if _FACTS_IN not in content:
            raise RuntimeError("the benchmark's LLM stub answers only the fact filter")
        facts = content.split(_FACTS_IN, 1)[1].split("\n\n", 1)[0]
        return f"[[ ## fact_after_filter ## ]]\n{facts}\n\n[[ ## completed ## ]]", {}, False
