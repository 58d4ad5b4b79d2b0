"""Cohere-on-Bedrock embedding backend (reference: embedding_model/Cohere.py:14-62).

``input_type`` switches between ``search_query`` (when an instruction is
present — queries) and ``search_document`` (corpus items), matching the
reference's behavior at Cohere.py:52-53.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from .base import BaseEmbeddingModel


class CohereEmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None, client=None):
        super().__init__(global_config)
        self.model_id = self.global_config.embedding_model_name.replace("bedrock/", "", 1)
        if client is not None:
            self.client = client  # injected fake for tests
        else:
            try:
                import boto3
            except ImportError as e:  # pragma: no cover
                raise ImportError("Cohere (Bedrock) embedder requires boto3") from e
            self.client = boto3.client(
                "bedrock-runtime", region_name=os.environ.get("AWS_REGION", "us-east-1")
            )
        self._is_query = False

    def format_with_instruction(self, text: str, instruction: str) -> str:
        self._is_query = bool(instruction)
        return text

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        body = json.dumps(
            {
                "texts": [t[:2048] for t in texts],
                "input_type": "search_query" if self._is_query else "search_document",
            }
        )
        resp = self.client.invoke_model(
            modelId=self.model_id, body=body, contentType="application/json"
        )
        payload = json.loads(resp["body"].read())
        return np.asarray(payload["embeddings"], dtype=np.float32)
