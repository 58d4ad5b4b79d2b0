"""Deterministic hashing n-gram embedder (no model weights, no network).

A feature-hashed character-n-gram TF embedder: real lexical similarity
structure (shared words/phrases -> high cosine) with zero dependencies and
bit-reproducible outputs. It fills two roles the reference ecosystem leaves
to downloadable models:

- an offline default for tests/benchmarks at corpus scale (the 2Wiki
  replay harness, evaluation/twiki.py), where the deterministic mock
  embedder's hash-seeded vectors carry no similarity signal at all;
- a dependency-free fallback retriever (classic hashing-trick IR baseline).

Instructions are deliberately IGNORED (query and document encodings are
symmetric), so host-side replicas of the retrieval math can re-encode
queries without tracking instruction strings.
"""

from __future__ import annotations

import re
import zlib
from typing import List

import numpy as np

from .base import BaseEmbeddingModel, l2_normalize

_TOKEN = re.compile(r"[a-z0-9]+")


class HashingNgramEmbeddingModel(BaseEmbeddingModel):
    """Feature-hashed char n-gram + word unigram embedder.

    Signed hashing (crc32 low bit picks the sign) keeps collisions
    unbiased, sublinear TF (1 + log tf) stops long passages from being
    dominated by repeated tokens, and rows are L2-normalized.
    """

    def __init__(self, global_config=None):
        super().__init__(global_config)
        self.embedding_dim = int(
            getattr(self.global_config, "embedding_dim", 1024) or 1024
        )
        # word -> (bucket idx array, sign array). Natural text is Zipfian, so
        # the per-word feature hash is computed once and corpus encoding is
        # dominated by cheap numpy accumulation instead of the crc32 loop.
        self._word_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def format_with_instruction(self, text: str, instruction: str) -> str:
        return text  # symmetric encoder: instructions intentionally ignored

    def _word_features(self, word: str) -> tuple[np.ndarray, np.ndarray]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        d = self.embedding_dim
        feats = [f"w:{word}"]
        marked = f"^{word}$"
        for n in range(3, 6):
            feats.extend(
                marked[i : i + n] for i in range(len(marked) - n + 1)
            )
        hashes = np.fromiter(
            (zlib.crc32(f.encode("utf-8")) for f in feats),
            dtype=np.uint32, count=len(feats),
        )
        idx = (hashes % d).astype(np.int64)
        sign = np.where((hashes >> 31) & 1 == 0, 1.0, -1.0).astype(np.float32)
        out = (idx, sign)
        if len(self._word_cache) < 2_000_000:
            self._word_cache[word] = out
        return out

    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        d = self.embedding_dim
        out = np.zeros((len(texts), d), dtype=np.float32)
        for row, text in enumerate(texts):
            words = _TOKEN.findall(text.lower())
            if not words:
                continue
            parts = [self._word_features(w) for w in words]
            idx = np.concatenate([p[0] for p in parts])
            sign = np.concatenate([p[1] for p in parts])
            c = np.zeros(d, dtype=np.float32)
            np.add.at(c, idx, sign)
            nz = c != 0
            out[row, nz] = np.sign(c[nz]) * (1.0 + np.log1p(np.abs(c[nz]) - 1.0))
        return l2_normalize(out)
