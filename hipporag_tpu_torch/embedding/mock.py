"""Deterministic mock embedder for tests and offline development.

Pattern from the reference's only fake backend
(tests/integration/run_vector_stores.py:34-47): hash-seeded deterministic
vectors. Extended with a shared-token component so that texts with
overlapping vocabulary have higher cosine similarity — enough signal for
end-to-end retrieval tests to produce meaningful rankings.
"""

from __future__ import annotations

import re
from hashlib import sha256
from typing import List

import numpy as np

from .base import BaseEmbeddingModel, l2_normalize

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _seeded_vector(seed_text: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(sha256(seed_text.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    return rng.standard_normal(dim).astype(np.float32)


class MockEmbeddingModel(BaseEmbeddingModel):
    def __init__(self, global_config=None):
        super().__init__(global_config)
        self.dim = self.global_config.embedding_dim
        self.embedding_dim = self.dim

    def format_with_instruction(self, text: str, instruction: str) -> str:
        # Instructions must not change token content for the mock's
        # similarity structure; keep raw text.
        return text

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, text in enumerate(texts):
            tokens = _TOKEN_RE.findall(text.lower())
            if not tokens:
                out[i] = _seeded_vector(text, self.dim)
                continue
            acc = np.zeros(self.dim, dtype=np.float32)
            for tok in tokens:
                acc += _seeded_vector("tok:" + tok, self.dim)
            acc /= np.sqrt(len(tokens))
            # small unique component so identical token-sets still differ
            acc += 0.05 * _seeded_vector("txt:" + text, self.dim)
            out[i] = acc
        return l2_normalize(out)
