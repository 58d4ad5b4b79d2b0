"""Qdrant-backed embedding store (reference: vector_stores/qdrant_store.py:39-296).

Local-file mode (default, under the working dir) or remote via
``config.qdrant_url``/``qdrant_api_key``. Qdrant point ids must be
UUIDs/ints, so namespace hash-ids map through UUIDv5 like the reference
(qdrant_store.py:39-40); the original hash id is kept in the payload.
In-memory caches are rebuilt by scrolling the collection at startup.
"""

from __future__ import annotations

import os
import uuid
from typing import List

import numpy as np

from ..embedding_store import InMemoryEmbeddingStore


def to_qdrant_id(hash_id: str) -> str:
    return str(uuid.uuid5(uuid.NAMESPACE_DNS, hash_id))


class QdrantEmbeddingStore(InMemoryEmbeddingStore):
    def __init__(self, embedding_model, db_dirname: str, batch_size: int,
                 namespace: str, config=None):
        try:
            from qdrant_client import QdrantClient
            from qdrant_client.models import Distance, VectorParams
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "QdrantEmbeddingStore requires qdrant-client "
                "(`pip install qdrant-client`)"
            ) from e
        super().__init__(embedding_model, batch_size, namespace)
        self._models = __import__("qdrant_client").models

        url = getattr(config, "qdrant_url", None)
        if url:
            self.client = QdrantClient(
                url=url, api_key=getattr(config, "qdrant_api_key", None)
            )
        else:
            os.makedirs(db_dirname, exist_ok=True)
            self.client = QdrantClient(path=os.path.join(db_dirname, "qdrant"))
        self.collection = f"hipporag_{namespace}"

        dim = getattr(embedding_model, "embedding_dim", None) or getattr(
            config, "embedding_dim", 128
        )
        if not self.client.collection_exists(self.collection):
            self.client.create_collection(
                self.collection,
                vectors_config=VectorParams(size=dim, distance=Distance.COSINE),
            )
        self._rebuild_caches()

    def _rebuild_caches(self):
        offset = None
        while True:
            points, offset = self.client.scroll(
                self.collection, limit=1024, offset=offset,
                with_payload=True, with_vectors=True,
            )
            for p in points:
                h = p.payload["hash_id"]
                text = p.payload["content"]
                self._rows[h] = {"hash_id": h, "content": text}
                self._embeddings[h] = np.asarray(p.vector, dtype=np.float32)
                self.text_to_hash_id[text] = h
            if offset is None:
                break

    def insert_strings(self, texts: List[str]) -> None:
        missing = self.get_missing_string_hash_ids(texts)
        if not missing:
            return
        ids = list(missing.keys())
        contents = [missing[h]["content"] for h in ids]
        embeddings = self._encode(contents)
        points = []
        for h, text, emb in zip(ids, contents, embeddings):
            emb = np.asarray(emb, dtype=np.float32)
            self._rows[h] = {"hash_id": h, "content": text}
            self._embeddings[h] = emb
            self.text_to_hash_id[text] = h
            points.append(
                self._models.PointStruct(
                    id=to_qdrant_id(h),
                    vector=emb.tolist(),
                    payload={"hash_id": h, "content": text},
                )
            )
        self.client.upsert(self.collection, points=points)

    def delete(self, hash_ids: List[str]) -> None:
        present = [h for h in hash_ids if h in self._rows]
        super().delete(hash_ids)
        if present:
            self.client.delete(
                self.collection,
                points_selector=self._models.PointIdsList(
                    points=[to_qdrant_id(h) for h in present]
                ),
            )

    def close(self) -> None:
        self.client.close()
