"""sentence-transformers embedding backend
(reference: embedding_model/Transformers.py:13-47).

Selected by ``st/<model>`` or ``Transformers/<model>``. Host-side torch;
used when a local sentence-transformers checkpoint is the desired encoder.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .base import BaseEmbeddingModel


class TransformersEmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None):
        super().__init__(global_config)
        cfg = self.global_config
        self.model_name = cfg.embedding_model_name.split("/", 1)[1]
        self._model = None

    def _load(self):
        if self._model is None:
            from sentence_transformers import SentenceTransformer

            self._model = SentenceTransformer(self.model_name)
            self.embedding_dim = self._model.get_sentence_embedding_dimension()

    def format_with_instruction(self, text: str, instruction: str) -> str:
        # sentence-transformers models are symmetric; instruction dropped
        # (reference Transformers.py encodes raw text).
        return text

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        self._load()
        return np.asarray(
            self._model.encode(
                texts,
                batch_size=self.global_config.embedding_batch_size,
                show_progress_bar=False,
                normalize_embeddings=False,
            ),
            dtype=np.float32,
        )
