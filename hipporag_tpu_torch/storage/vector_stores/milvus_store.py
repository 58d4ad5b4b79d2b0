"""Milvus-backed embedding store (reference: vector_stores/milvus_store.py:41-381).

Milvus Lite (local file) by default; server/Zilliz via ``config.milvus_uri``
+ ``milvus_token`` or the ``MILVUS_URI``/``MILVUS_TOKEN`` env vars, with
optional ``milvus_consistency_level`` — the same env-var surface as the
reference (milvus_store.py:51-55). Collection names are sanitized to
Milvus's identifier rules.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from ...utils.logging import get_logger
from ..embedding_store import InMemoryEmbeddingStore

logger = get_logger(__name__)


def safe_collection_name(name: str) -> str:
    """Milvus identifiers: alnum + underscore, must not start with a digit."""
    name = re.sub(r"[^0-9a-zA-Z_]", "_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


class MilvusEmbeddingStore(InMemoryEmbeddingStore):
    # Milvus servers cap a single query window at 16384 rows; the cache
    # rebuild fallback pages by this much (class attr so tests can shrink it)
    FALLBACK_QUERY_PAGE = 16384

    def __init__(self, embedding_model, db_dirname: str, batch_size: int,
                 namespace: str, config=None):
        try:
            from pymilvus import MilvusClient
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "MilvusEmbeddingStore requires pymilvus (`pip install pymilvus`)"
            ) from e
        super().__init__(embedding_model, batch_size, namespace)

        uri = (
            getattr(config, "milvus_uri", None)
            or os.environ.get("MILVUS_URI")
        )
        token = getattr(config, "milvus_token", None) or os.environ.get("MILVUS_TOKEN")
        db_name = getattr(config, "milvus_db_name", None) or os.environ.get(
            "MILVUS_DB_NAME", ""
        )
        if not uri:
            os.makedirs(db_dirname, exist_ok=True)
            uri = os.path.join(db_dirname, "milvus.db")  # Milvus Lite
        kwargs = {"uri": uri}
        if token:
            kwargs["token"] = token
        if db_name:
            kwargs["db_name"] = db_name
        self.client = MilvusClient(**kwargs)
        self.collection = safe_collection_name(f"hipporag_{namespace}")
        self.consistency = getattr(config, "milvus_consistency_level", None)

        self.dim = getattr(embedding_model, "embedding_dim", None) or getattr(
            config, "embedding_dim", 128
        )
        if not self.client.has_collection(self.collection):
            self._create_collection()
        self._rebuild_caches()

    def _create_collection(self):
        from pymilvus import DataType

        schema = self.client.create_schema(auto_id=False)
        schema.add_field("hash_id", DataType.VARCHAR, is_primary=True, max_length=128)
        schema.add_field("content", DataType.VARCHAR, max_length=65535)
        schema.add_field("embedding", DataType.FLOAT_VECTOR, dim=self.dim)
        index_params = self.client.prepare_index_params()
        index_params.add_index(field_name="embedding", metric_type="COSINE")
        kwargs = {}
        if self.consistency:
            kwargs["consistency_level"] = self.consistency
        self.client.create_collection(
            self.collection, schema=schema, index_params=index_params, **kwargs
        )

    def _rebuild_caches(self):
        try:
            it = self.client.query_iterator(
                self.collection, output_fields=["hash_id", "content", "embedding"],
                batch_size=1024,
            )
        except Exception:  # collection empty / iterator unsupported in Lite
            # Milvus caps a query window at offset + limit <= 16384, so
            # offset pagination CANNOT exceed one window — a single capped
            # query with a loud warning on truncation is the honest
            # fallback (query_iterator above is the complete path).
            rows = self.client.query(
                self.collection, filter="", limit=self.FALLBACK_QUERY_PAGE,
                output_fields=["hash_id", "content", "embedding"],
            )
            self._ingest_rows(rows)
            if len(rows) >= self.FALLBACK_QUERY_PAGE:
                logger.warning(
                    "Milvus cache rebuild truncated at %d rows (server "
                    "lacks query_iterator and caps query windows at "
                    "16384); rows beyond the cap will be re-embedded and "
                    "re-upserted on insert", len(rows),
                )
            return
        while True:
            rows = it.next()
            if not rows:
                it.close()
                break
            self._ingest_rows(rows)

    def _ingest_rows(self, rows):
        for r in rows:
            h, text = r["hash_id"], r["content"]
            self._rows[h] = {"hash_id": h, "content": text}
            self._embeddings[h] = np.asarray(r["embedding"], dtype=np.float32)
            self.text_to_hash_id[text] = h

    def insert_strings(self, texts: List[str]) -> None:
        missing = self.get_missing_string_hash_ids(texts)
        if not missing:
            return
        ids = list(missing.keys())
        contents = [missing[h]["content"] for h in ids]
        embeddings = self._encode(contents)
        data = []
        for h, text, emb in zip(ids, contents, embeddings):
            emb = np.asarray(emb, dtype=np.float32)
            self._rows[h] = {"hash_id": h, "content": text}
            self._embeddings[h] = emb
            self.text_to_hash_id[text] = h
            data.append({"hash_id": h, "content": text, "embedding": emb.tolist()})
        self.client.upsert(self.collection, data)

    def delete(self, hash_ids: List[str]) -> None:
        present = [h for h in hash_ids if h in self._rows]
        super().delete(hash_ids)
        if present:
            self.client.delete(self.collection, ids=present)

    def close(self) -> None:
        self.client.close()
