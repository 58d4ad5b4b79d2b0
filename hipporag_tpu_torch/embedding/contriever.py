"""Contriever embedding backend (reference: embedding_model/Contriever.py:20-113).

Mean-pooled HF encoder (facebook/contriever). Instructions are dropped —
Contriever is a symmetric dense retriever (reference Contriever.py encodes
queries and passages identically).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .base import BaseEmbeddingModel


def mean_pooling(token_embeddings, mask):
    """Mask-weighted mean over tokens (reference Contriever.py:15-18)."""
    token_embeddings = token_embeddings.masked_fill(~mask[..., None].bool(), 0.0)
    return token_embeddings.sum(dim=1) / mask.sum(dim=1)[..., None].clamp(min=1e-9)


class ContrieverEmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None):
        super().__init__(global_config)
        self.model_name = self.global_config.embedding_model_name
        self._model = None
        self._tokenizer = None

    def _load(self):
        if self._model is not None:
            return
        import torch
        from transformers import AutoModel, AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(self.model_name)
        self._model = AutoModel.from_pretrained(self.model_name)
        self._model.eval()
        self._torch = torch

    def format_with_instruction(self, text: str, instruction: str) -> str:
        return text

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        self._load()
        inputs = self._tokenizer(
            texts,
            padding=True,
            truncation=True,
            max_length=self.global_config.embedding_max_seq_len,
            return_tensors="pt",
        )
        with self._torch.no_grad():
            out = self._model(**inputs)
        emb = mean_pooling(out.last_hidden_state, inputs["attention_mask"])
        return emb.cpu().numpy().astype(np.float32)
