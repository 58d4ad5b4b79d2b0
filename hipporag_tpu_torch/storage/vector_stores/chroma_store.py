"""ChromaDB-backed embedding store (reference: vector_stores/chroma_store.py:52-200).

Persistent local client by default; HTTP client when ``config.chroma_host``
is set. Hash ids are used directly as Chroma ids.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..embedding_store import InMemoryEmbeddingStore


class ChromaEmbeddingStore(InMemoryEmbeddingStore):
    def __init__(self, embedding_model, db_dirname: str, batch_size: int,
                 namespace: str, config=None):
        try:
            import chromadb
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "ChromaEmbeddingStore requires chromadb (`pip install chromadb`)"
            ) from e
        super().__init__(embedding_model, batch_size, namespace)

        host = getattr(config, "chroma_host", None)
        if host:
            self.client = chromadb.HttpClient(
                host=host, port=getattr(config, "chroma_port", 8000)
            )
        else:
            os.makedirs(db_dirname, exist_ok=True)
            self.client = chromadb.PersistentClient(
                path=os.path.join(db_dirname, "chroma")
            )
        self.collection = self.client.get_or_create_collection(
            f"hipporag_{namespace}", metadata={"hnsw:space": "cosine"}
        )
        self._rebuild_caches()

    def _rebuild_caches(self):
        got = self.collection.get(include=["documents", "embeddings"])
        # chromadb may return embeddings as a numpy array (truthiness is
        # ambiguous) or None. Rows WITHOUT an embedding are deliberately
        # not cached: caching them would make dedup treat the row as
        # present, so it would never be re-encoded and get_embeddings
        # would later KeyError; leaving it "missing" re-embeds and
        # re-upserts it on the next insert_strings.
        embs = got.get("embeddings")
        if embs is None:
            embs = [None] * len(got["ids"])
        for h, text, emb in zip(got["ids"], got["documents"], embs):
            if emb is None:
                continue
            self._rows[h] = {"hash_id": h, "content": text}
            self._embeddings[h] = np.asarray(emb, dtype=np.float32)
            self.text_to_hash_id[text] = h

    def insert_strings(self, texts: List[str]) -> None:
        missing = self.get_missing_string_hash_ids(texts)
        if not missing:
            return
        ids = list(missing.keys())
        contents = [missing[h]["content"] for h in ids]
        embeddings = self._encode(contents)
        for h, text, emb in zip(ids, contents, embeddings):
            self._rows[h] = {"hash_id": h, "content": text}
            self._embeddings[h] = np.asarray(emb, dtype=np.float32)
            self.text_to_hash_id[text] = h
        self.collection.upsert(
            ids=ids,
            documents=contents,
            embeddings=[np.asarray(e, dtype=np.float32).tolist() for e in embeddings],
        )

    def delete(self, hash_ids: List[str]) -> None:
        present = [h for h in hash_ids if h in self._rows]
        super().delete(hash_ids)
        if present:
            self.collection.delete(ids=present)
