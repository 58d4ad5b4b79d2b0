"""GritLM embedding backend (reference: embedding_model/GritLM.py:20-96).

Uses GritLM's embed-instruction template ``<|user|>\n{instruction}\n<|embed|>\n``;
empty instruction uses the bare ``<|embed|>`` header, matching
``gritlm_instruction`` in the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .base import BaseEmbeddingModel


def gritlm_instruction(instruction: str) -> str:
    return (
        "<|user|>\n" + instruction + "\n<|embed|>\n" if instruction else "<|embed|>\n"
    )


class GritLMEmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None):
        super().__init__(global_config)
        self.model_name = self.global_config.embedding_model_name
        self._model = None
        self._instruction = ""

    def _load(self):
        if self._model is not None:
            return
        try:
            from gritlm import GritLM
        except ImportError as e:  # pragma: no cover - env without gritlm
            raise ImportError("GritLM embedder requires the gritlm package") from e
        self._model = GritLM(self.model_name, torch_dtype="auto", device_map="auto", mode="embedding")

    def format_with_instruction(self, text: str, instruction: str) -> str:
        # GritLM takes the instruction as a separate encode() argument; stash
        # it instead of prefixing the text.
        self._instruction = instruction
        return text

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        self._load()
        emb = self._model.encode(
            texts,
            instruction=gritlm_instruction(self._instruction),
            batch_size=self.global_config.embedding_batch_size,
        )
        return np.asarray(emb, dtype=np.float32)
