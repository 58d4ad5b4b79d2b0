"""Remote vLLM embedding-server backend (reference: embedding_model/VLLM.py:10-61).

Selected by the ``VLLM/<model>`` prefix; posts to a vLLM server's
OpenAI-compatible ``/v1/embeddings`` route (``embedding_base_url``).
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from .base import BaseEmbeddingModel


class VLLMEmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None):
        super().__init__(global_config)
        import httpx

        cfg = self.global_config
        self.model = cfg.embedding_model_name.split("/", 1)[1]
        if not cfg.embedding_base_url:
            raise ValueError("VLLM embedder requires embedding_base_url")
        self.base_url = cfg.embedding_base_url.rstrip("/")
        self._client = httpx.Client(timeout=300.0)

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        resp = self._client.post(
            f"{self.base_url}/embeddings",
            content=json.dumps({"model": self.model, "input": texts}),
            headers={"Content-Type": "application/json"},
        )
        resp.raise_for_status()
        data = sorted(resp.json()["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)
