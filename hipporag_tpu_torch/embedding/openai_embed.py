"""OpenAI-compatible embedding backend (reference: embedding_model/OpenAI.py).

Works against api.openai.com, Azure, or any OpenAI-compatible local server
(``embedding_base_url``). First-party REST client over ``httpx`` — no
``openai`` SDK dependency.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from .base import BaseEmbeddingModel


class OpenAIEmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None):
        super().__init__(global_config)
        import httpx

        cfg = self.global_config
        self.azure = bool(cfg.azure_embedding_endpoint)
        if self.azure:
            self.base_url = cfg.azure_embedding_endpoint.rstrip("/")
            self.api_version = os.environ.get("AZURE_OPENAI_API_VERSION", "2024-10-21")
            headers = {"api-key": os.environ.get("AZURE_OPENAI_API_KEY", "EMPTY")}
        else:
            from ..llm.openai_llm import _is_local_endpoint

            self.base_url = (cfg.embedding_base_url or "https://api.openai.com/v1").rstrip("/")
            api_key = os.environ.get("OPENAI_API_KEY")
            if api_key is None:
                if _is_local_endpoint(self.base_url):
                    api_key = "EMPTY"  # auth-less local/LAN server convention
                else:
                    # fail fast like the chat client: a missing key would
                    # otherwise send 'Bearer None' and surface as opaque 401s
                    raise ValueError(
                        "No OpenAI API key: set OPENAI_API_KEY (use "
                        "OPENAI_API_KEY=EMPTY for auth-less endpoints) for "
                        f"remote embedding endpoint {self.base_url}"
                    )
            headers = {"Authorization": f"Bearer {api_key}"}
        headers["Content-Type"] = "application/json"
        self._client = httpx.Client(headers=headers, timeout=120.0)
        self.model = cfg.embedding_model_name.replace("openai/", "", 1)

    def format_with_instruction(self, text: str, instruction: str) -> str:
        # OpenAI embedding endpoints are symmetric; instructions are dropped
        # (same behavior as the reference OpenAI embedder).
        return text

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        # The API rejects empty strings; substitute a single space.
        texts = [t if t.strip() else " " for t in texts]
        if self.azure:
            url = (
                f"{self.base_url}/openai/deployments/{self.model}/embeddings"
                f"?api-version={self.api_version}"
            )
            payload = {"input": texts}
        else:
            url = f"{self.base_url}/embeddings"
            payload = {"model": self.model, "input": texts}
        resp = self._client.post(url, content=json.dumps(payload))
        resp.raise_for_status()
        data = sorted(resp.json()["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)
