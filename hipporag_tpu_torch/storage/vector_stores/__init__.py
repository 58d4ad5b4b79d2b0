"""Optional external vector-store backends (Qdrant / Chroma / Milvus).

Each implements the BaseEmbeddingStore contract over a third-party client
(reference: src/hipporag/vector_stores/). All imports are deferred so the
framework loads without any of the optional clients installed.
"""
