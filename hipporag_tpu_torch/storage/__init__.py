from .embedding_store import (
    BaseEmbeddingStore,
    InMemoryEmbeddingStore,
    ParquetEmbeddingStore,
    get_embedding_store,
)
from .kv_cache import SqliteKVCache, hash_key

__all__ = [
    "BaseEmbeddingStore",
    "InMemoryEmbeddingStore",
    "ParquetEmbeddingStore",
    "SqliteKVCache",
    "get_embedding_store",
    "hash_key",
]
