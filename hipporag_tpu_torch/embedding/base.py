"""Embedding model base class.

Contract parity with the reference (embedding_model/base.py:189-218):
``batch_encode(texts, instruction=..., norm=...) -> np.ndarray [N, D]``.
Instruction-prefixed query encoding is how query-vs-document asymmetry is
expressed (reference: NVEmbedV2.py / GritLM.py instruction handling).

Embeddings are optionally cached in the shared SQLite KV cache keyed by
(model, instruction, text) — the checkpoint/resume behavior of the
reference's ``make_cache_embed`` (embedding_model/base.py:112-187).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Union

import numpy as np

from ..config import BaseConfig
from ..storage.kv_cache import SqliteKVCache, hash_key


def l2_normalize(x: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    # single-pass einsum for the ubiquitous last-axis normalize, which is
    # faster than np.linalg.norm on large row blocks. einsum's sequential
    # accumulation is NOT bit-identical to norm()'s pairwise add.reduce (~1e-6 relative
    # on f32), so the fast path covers EVERY axis=-1 shape — the same
    # rows normalize the same whether they arrive 2D or N-D
    # (parity-pinned in tests/test_foundation.py); only axis!=-1
    # falls back to norm().
    if axis == -1 or axis == x.ndim - 1:
        sq = np.einsum("...i,...i->...", x, x, optimize=True)
        norm = np.sqrt(sq, dtype=x.dtype if x.dtype.kind == "f" else None)[
            ..., None
        ]
    else:
        norm = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(norm, eps)


class TextBatch(list):
    """One batch of instruction-formatted texts, as ``batch_encode`` hands it
    to ``_encode_batch``, with the ``instruction`` they were formatted under:
    an encoder whose pooling depends on the instruction reads it here."""

    def __init__(self, texts, instruction: str = ""):
        super().__init__(texts)
        self.instruction = instruction


class BaseEmbeddingModel(ABC):
    def __init__(self, global_config: Optional[BaseConfig] = None):
        self.global_config = global_config or BaseConfig()
        self.embedding_model_name = self.global_config.embedding_model_name
        self.embedding_dim: Optional[int] = None
        self._cache: Optional[SqliteKVCache] = None
        self._cache_dim_key = "model-default"

    def attach_cache(self, cache_path: str):
        self._cache = SqliteKVCache(cache_path, table="embeddings")
        # dimension component of the cache key, frozen at attach time:
        # dim-CONFIGURABLE embedders (hashing/mock — dim known at
        # construction) must not serve blobs recorded under a different
        # embedding_dim; model-determined embedders that only learn their
        # dim after the first encode contribute a stable constant instead,
        # so their keys never shift mid-lifetime
        self._cache_dim_key = self.embedding_dim or "model-default"

    @abstractmethod
    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        """Encode a list of (already instruction-prefixed) texts to [N, D]."""

    def format_with_instruction(self, text: str, instruction: str) -> str:
        """How instructions wrap input text; backends may override."""
        if not instruction:
            return text
        return f"Instruct: {instruction}\nQuery: {text}"

    def batch_encode(
        self,
        texts: Union[str, List[str]],
        instruction: str = "",
        norm: Optional[bool] = None,
    ) -> np.ndarray:
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        if norm is None:
            norm = self.global_config.embedding_return_as_normalized
        if not texts:
            dim = self.embedding_dim or self.global_config.embedding_dim or 0
            return np.zeros((0, dim), dtype=np.float32)

        prefixed = [self.format_with_instruction(t, instruction) for t in texts]

        # the key includes the RAW instruction (not just the prefixed
        # text): instruction-stateful backends (GritLM/Cohere) pass the
        # instruction out-of-band and return the text unchanged, so a
        # prefixed-text-only key would collide across query_to_fact /
        # query_to_passage and silently return the wrong embedding
        def _key(p: str) -> str:
            return hash_key(
                "emb", self.embedding_model_name, self._cache_dim_key,
                instruction, p,
            )

        results: List[Optional[np.ndarray]] = [None] * len(prefixed)
        to_compute: List[int] = []
        keys: List[str] = []
        if self._cache is not None:
            # keys are computed ONCE and reused for the put below: hash_key
            # JSON-serializes the full text, so recomputing them would
            # double the hashing cost of a large index()
            keys = [_key(p) for p in prefixed]
            hits = self._cache.get_many(keys)
            for i, hit in enumerate(hits):
                if hit is not None:
                    value = hit[0]
                    results[i] = (
                        np.frombuffer(value, dtype=np.float32).copy()
                        if isinstance(value, bytes)
                        else np.asarray(value, dtype=np.float32)  # legacy JSON rows
                    )
                else:
                    to_compute.append(i)
        else:
            to_compute = list(range(len(prefixed)))

        computed_arr = None
        if to_compute:
            bs = max(1, self.global_config.embedding_batch_size)
            computed = []
            for s in range(0, len(to_compute), bs):
                batch_idx = to_compute[s : s + bs]
                # device-backed encoders return an UNMATERIALIZED array
                # (device dispatch is async): the np.asarray below only runs
                # after every batch is dispatched, so host-side
                # tokenization of batch i+1 overlaps device compute of
                # batch i instead of blocking on its transfer
                computed.append(self._encode_batch(TextBatch([prefixed[i] for i in batch_idx], instruction)))
            computed_arr = np.concatenate(
                [np.asarray(c) for c in computed], axis=0
            ).astype(np.float32, copy=False)
            if self._cache is not None:
                self._cache.put_many(
                    [
                        (keys[i], computed_arr[j].tobytes())
                        for j, i in enumerate(to_compute)
                    ]
                )

        # assemble block-wise: np.stack over one tiny array PER ROW costs
        # more than the encode itself at 30k+ rows (measured)
        if computed_arr is not None and len(to_compute) == len(prefixed):
            out = computed_arr
        else:
            dim = (
                computed_arr.shape[1]
                if computed_arr is not None and computed_arr.ndim == 2
                else next(len(r) for r in results if r is not None)
            )
            out = np.empty((len(prefixed), dim), np.float32)
            for i, r in enumerate(results):
                if r is not None:
                    out[i] = r
            if computed_arr is not None:
                out[np.asarray(to_compute)] = computed_arr
        if norm:
            out = l2_normalize(out)
        if self.embedding_dim is None and out.size:
            self.embedding_dim = out.shape[-1]
        return out[0] if single else out
