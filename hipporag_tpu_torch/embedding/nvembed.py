"""NV-Embed-v2 embedding backend (reference: embedding_model/NVEmbedV2.py:16-101).

Instruction-prefixed query encoding with NV-Embed's ``Instruct: ...\nQuery: ``
wrapper and its trailing-EOS convention. Requires the HF checkpoint
(trust_remote_code) and torch; loaded lazily.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .base import BaseEmbeddingModel


class NVEmbedV2EmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None):
        super().__init__(global_config)
        self.model_name = self.global_config.embedding_model_name
        self._model = None

    def _load(self):
        if self._model is not None:
            return
        from transformers import AutoModel

        # device_map="auto" layer-shards across visible accelerators like the
        # reference (NVEmbedV2.py:49)
        self._model = AutoModel.from_pretrained(
            self.model_name, trust_remote_code=True, device_map="auto", torch_dtype="auto"
        )

    def format_with_instruction(self, text: str, instruction: str) -> str:
        if not instruction:
            return text
        return f"Instruct: {instruction}\nQuery: {text}"

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        self._load()
        # NV-Embed requires the eos marker appended per input
        # (reference NVEmbedV2.py:75-84)
        eos = getattr(self._model.tokenizer, "eos_token", "")
        texts = [t + eos for t in texts]
        emb = self._model.encode(
            texts, max_length=self.global_config.embedding_max_seq_len
        )
        return np.asarray(emb.detach().cpu(), dtype=np.float32)
