"""Content-addressed text + embedding stores.

Functional parity with the reference store contract
(reference: src/hipporag/embedding_store.py:18-254): MD5 content addressing
per namespace, insert-if-missing, delete, bulk row/embedding fetch with
order preservation, and persistence across reloads.

Device-first difference: ``get_embeddings_matrix`` returns one contiguous,
row-aligned ``np.ndarray`` ready for a single host→device transfer, instead
of a Python list of vectors — the retrieval pipeline keeps the full matrix
resident in device memory.
"""

from __future__ import annotations

import os
import re
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Set

import numpy as np

# ".delta-g000001-000003.parquet" (generation-tagged) or the legacy
# ".delta-000003.parquet" (generation 0)
_DELTA_NAME_RE = re.compile(r"\.delta-(?:g(\d+)-)?(\d+)\.parquet$")

from ..utils.logging import get_logger
from ..utils.misc import compute_mdhash_id

logger = get_logger(__name__)


class BaseEmbeddingStore(ABC):
    """Abstract store interface shared by all backends."""

    namespace: str
    embedding_model: Any
    batch_size: int
    text_to_hash_id: Dict[str, str]

    def get_missing_string_hash_ids(self, texts: List[str]) -> Dict[str, Dict]:
        existing = set(self.get_all_ids())
        result = {}
        for text in texts:
            h = compute_mdhash_id(text, prefix=self.namespace + "-")
            if h not in existing:
                result[h] = {"hash_id": h, "content": text}
        return result

    def get_hash_id(self, text: str) -> str:
        return self.text_to_hash_id[text]

    @abstractmethod
    def insert_strings(self, texts: List[str]) -> None: ...

    @abstractmethod
    def delete(self, hash_ids: List[str]) -> None: ...

    @abstractmethod
    def get_row(self, hash_id: str) -> Dict: ...

    @abstractmethod
    def get_rows(self, hash_ids: List[str]) -> Dict[str, Dict]: ...

    @abstractmethod
    def get_all_ids(self) -> List[str]: ...

    @abstractmethod
    def get_all_id_to_rows(self) -> Dict[str, Dict]: ...

    @abstractmethod
    def get_all_texts(self) -> Set[str]: ...

    @abstractmethod
    def get_embedding(self, hash_id: str, dtype=np.float32) -> np.ndarray: ...

    @abstractmethod
    def get_embeddings(self, hash_ids: List[str], dtype=np.float32) -> List[np.ndarray]: ...

    def get_embeddings_matrix(
        self, hash_ids: List[str], dtype=np.float32
    ) -> np.ndarray:
        """Contiguous [len(hash_ids), D] matrix, row-aligned with hash_ids."""
        embs = self.get_embeddings(hash_ids, dtype=dtype)
        if len(embs) == 0:
            return np.zeros((0, 0), dtype=dtype)
        return np.ascontiguousarray(np.stack(embs).astype(dtype))

    def close(self) -> None:
        """Release held resources. No-op by default."""


class InMemoryEmbeddingStore(BaseEmbeddingStore):
    """Volatile dict-backed store (tests and ephemeral sessions)."""

    def __init__(self, embedding_model, batch_size: int, namespace: str):
        self.embedding_model = embedding_model
        # kept for reference API parity (embedding_store.py:37); encode
        # batching itself lives in BaseEmbeddingModel.batch_encode
        # (embedding_batch_size), see _encode below
        self.batch_size = batch_size
        self.namespace = namespace
        self._rows: Dict[str, Dict] = {}
        self._embeddings: Dict[str, np.ndarray] = {}
        self.text_to_hash_id: Dict[str, str] = {}

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

    def _encode(self, contents: List[str]) -> np.ndarray:
        # ONE batch_encode call for the whole insert: the model base
        # already splits into embedding_batch_size device batches and
        # pipelines tokenize(i+1) against forward(i) via async dispatch —
        # an outer chunk loop here would break that overlap and multiply
        # the embedding-cache lookups/commits (147 sqlite commits -> 1 on
        # a 37k-entity index, measured)
        if not contents:
            return np.zeros((0, 0))
        return np.asarray(self.embedding_model.batch_encode(contents))

    def delete(self, hash_ids: List[str]) -> None:
        for h in hash_ids:
            row = self._rows.pop(h, None)
            self._embeddings.pop(h, None)
            if row is not None:
                self.text_to_hash_id.pop(row["content"], None)

    def get_row(self, hash_id: str) -> Dict:
        return self._rows[hash_id]

    def get_rows(self, hash_ids: List[str]) -> Dict[str, Dict]:
        return {h: self._rows[h] for h in hash_ids if h in self._rows}

    def get_all_ids(self) -> List[str]:
        return list(self._rows.keys())

    def get_all_id_to_rows(self) -> Dict[str, Dict]:
        return dict(self._rows)

    def get_all_texts(self) -> Set[str]:
        return {row["content"] for row in self._rows.values()}

    def get_embedding(self, hash_id: str, dtype=np.float32) -> np.ndarray:
        return self._embeddings[hash_id].astype(dtype)

    def get_embeddings(self, hash_ids: List[str], dtype=np.float32) -> List[np.ndarray]:
        return [self._embeddings[h].astype(dtype) for h in hash_ids]


class ParquetEmbeddingStore(InMemoryEmbeddingStore):
    """Default durable backend: one Parquet file per namespace.

    Keeps the full store in memory (like the reference). Inserts append
    LSM-style *delta* files (only the new rows) instead of rewriting the
    whole table — a +2% incremental index on a 100k-row store writes
    ~2k rows, not ~102k. Deltas fold into the base file when they exceed
    ``_COMPACT_FRACTION`` of the store (or on any delete, which always
    rewrites). Crash safety is generation-based: every base rewrite bumps
    a generation marker in the base file's Parquet metadata and delta
    filenames carry the generation they were appended under, so a crash
    between the base rewrite and delta cleanup leaves stale deltas that
    the next load recognizes (gen < base gen), skips, and removes — a
    row deleted in the rewrite can never be resurrected by a leftover
    delta. Within a generation, reloads read base + deltas in order.
    """

    _COMPACT_FRACTION = 0.25
    _MAX_DELTA_FILES = 64

    def __init__(self, embedding_model, db_dirname: str, batch_size: int, namespace: str):
        super().__init__(embedding_model, batch_size, namespace)
        os.makedirs(db_dirname, exist_ok=True)
        self.filename = os.path.join(db_dirname, f"vdb_{namespace}.parquet")
        self._delta_rows = 0  # rows living in delta files
        self._gen = 0  # base-file generation (bumped on every full rewrite)
        self._load()

    # -- delta bookkeeping ------------------------------------------------
    def _delta_entries(self) -> List[tuple]:
        """Sorted [(generation, seq, path)] for every delta file on disk.

        Legacy (pre-generation) delta names ``.delta-NNNNNN.parquet``
        parse as generation 0; they sort before ``.delta-gGGGGGG-…`` names
        of the same generation, which matches their write order."""
        base = os.path.basename(self.filename)
        dirname = os.path.dirname(self.filename) or "."
        prefix = base + ".delta-"
        out = []
        for n in os.listdir(dirname):
            if not (n.startswith(prefix) and n.endswith(".parquet")):
                continue
            m = _DELTA_NAME_RE.search(n)
            if not m:
                continue
            gen = int(m.group(1)) if m.group(1) else 0
            out.append((gen, int(m.group(2)), os.path.join(dirname, n)))
        out.sort()
        return out

    def _delta_paths(self) -> List[str]:
        return [p for _, _, p in self._delta_entries()]

    def _next_delta_path(self) -> str:
        live = [s for g, s, _ in self._delta_entries() if g == self._gen]
        seq = (max(live) + 1) if live else 0
        return f"{self.filename}.delta-g{self._gen:06d}-{seq:06d}.parquet"

    def _read_table_into_rows(self, path: str) -> int:
        import pyarrow as pa
        import pyarrow.parquet as pq

        tbl = pq.read_table(path, memory_map=True)
        ids = tbl["hash_id"].to_pylist()
        contents = tbl["content"].to_pylist()
        emb_col = tbl["embedding"].combine_chunks()
        if ids:
            if pa.types.is_fixed_size_list(emb_col.type):
                flat = emb_col.values.to_numpy(zero_copy_only=False)
                embs = np.ascontiguousarray(flat, dtype=np.float32).reshape(
                    len(ids), emb_col.type.list_size
                )
            else:  # legacy variable-length list layout (e.g. pandas-written)
                embs = np.asarray(emb_col.to_pylist(), dtype=np.float32)
            for i, (h, text) in enumerate(zip(ids, contents)):
                self._rows[h] = {"hash_id": h, "content": text}
                self._embeddings[h] = embs[i]
                self.text_to_hash_id[text] = h
        return len(ids)

    def _load(self):
        self._gen = 0
        if os.path.exists(self.filename):
            import pyarrow.parquet as pq

            md = pq.read_schema(self.filename).metadata or {}
            self._gen = int(md.get(b"hipporag_generation", b"0"))
            self._read_table_into_rows(self.filename)
        self._delta_rows = 0
        stale = []
        for gen, _seq, path in self._delta_entries():
            if gen < self._gen:
                # leftover from a crash between a base rewrite and delta
                # cleanup: its rows are already folded into the base (and
                # may include rows the rewrite deleted) — never replay it
                stale.append(path)
                continue
            if gen > self._gen:
                # a delta tagged AHEAD of the base should be impossible
                # (the generation only advances after a successful base
                # write); if it happens, the delta may hold rows newer
                # than the base — warn and keep it for manual recovery
                # instead of deleting data we cannot account for
                logger.warning(
                    "Delta %s has generation %d > base generation %d; "
                    "skipping it but NOT removing (possible newer data)",
                    path, gen, self._gen,
                )
                continue
            self._delta_rows += self._read_table_into_rows(path)
        for path in stale:
            logger.warning("Removing stale delta %s (gen < %d)", path, self._gen)
            os.remove(path)
        if self._rows:
            logger.info(
                "Loaded %d rows from %s (+%d delta rows)",
                len(self._rows), self.filename, self._delta_rows,
            )

    def _write_table(self, ids: List[str], path: str, generation=None) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        contents = [self._rows[h]["content"] for h in ids]
        if ids:
            # fixed-size-list over one contiguous f32 buffer: much faster
            # than a python-list object column through pandas at corpus
            # scale (100k+ rows x 1024 dims)
            emb = np.stack([self._embeddings[h] for h in ids]).astype(
                np.float32, copy=False
            )
            emb_arr = pa.FixedSizeListArray.from_arrays(
                pa.array(emb.reshape(-1)), emb.shape[1]
            )
        else:
            emb_arr = pa.array([], type=pa.list_(pa.float32()))
        table = pa.table(
            {
                "hash_id": pa.array(ids, type=pa.string()),
                "content": pa.array(contents, type=pa.string()),
                "embedding": emb_arr,
            }
        )
        if generation is not None:
            table = table.replace_schema_metadata(
                {b"hipporag_generation": str(generation).encode()}
            )
        tmp = path + ".tmp"
        # float32 embeddings are incompressible; NONE + memory_map makes
        # the reload path a near-zero-copy read
        pq.write_table(
            table,
            tmp,
            compression={
                "hash_id": "SNAPPY", "content": "SNAPPY", "embedding": "NONE",
            },
        )
        os.replace(tmp, path)

    def _persist(self):
        """Full rewrite: fold everything into the base file, drop deltas.

        The generation bump closes the delete-crash window: the new base
        carries gen+1, so a crash before the delta removals below leaves
        only stale-generation deltas, which the next ``_load`` skips and
        cleans instead of replaying (they may hold rows this rewrite
        deleted). The in-memory generation advances only AFTER the base
        write succeeds — if the write raises, memory and disk stay in
        sync (still the old generation), so later deltas keep being
        tagged with a generation that actually exists on disk."""
        self._write_table(
            list(self._rows.keys()), self.filename, generation=self._gen + 1
        )
        self._gen += 1
        for path in self._delta_paths():
            os.remove(path)
        self._delta_rows = 0

    def _append_delta(self, new_ids: List[str]) -> None:
        total = self._delta_rows + len(new_ids)
        if total > max(
            1024, self._COMPACT_FRACTION * len(self._rows)
        ) or len(self._delta_paths()) >= self._MAX_DELTA_FILES:
            # over the compaction threshold: fold the new rows straight
            # into the base rewrite — writing a delta first would pay a
            # table write that _persist immediately discards
            self._persist()
            return
        self._write_table(new_ids, self._next_delta_path())
        self._delta_rows = total

    def insert_strings(self, texts: List[str]) -> None:
        before = len(self._rows)
        super().insert_strings(texts)
        if len(self._rows) != before:
            # _rows is insertion-ordered: the new ids are exactly the tail
            new_ids = list(self._rows.keys())[before:]
            if not os.path.exists(self.filename):
                self._persist()  # first write: straight to the base file
            else:
                self._append_delta(new_ids)

    def delete(self, hash_ids: List[str]) -> None:
        before = len(self._rows)
        super().delete(hash_ids)
        if len(self._rows) != before:
            self._persist()


def get_embedding_store(
    embedding_model,
    db_dirname: str,
    batch_size: int,
    namespace: str,
    config=None,
) -> BaseEmbeddingStore:
    """Factory over store backends (reference: embedding_store.py:224-254)."""
    store_type = getattr(config, "vector_store_type", "parquet") if config else "parquet"
    if store_type == "memory":
        return InMemoryEmbeddingStore(embedding_model, batch_size, namespace)
    if store_type == "parquet":
        return ParquetEmbeddingStore(embedding_model, db_dirname, batch_size, namespace)
    if store_type == "qdrant":
        from .vector_stores.qdrant_store import QdrantEmbeddingStore

        return QdrantEmbeddingStore(embedding_model, db_dirname, batch_size, namespace, config)
    if store_type == "chroma":
        from .vector_stores.chroma_store import ChromaEmbeddingStore

        return ChromaEmbeddingStore(embedding_model, db_dirname, batch_size, namespace, config)
    if store_type == "milvus":
        from .vector_stores.milvus_store import MilvusEmbeddingStore

        return MilvusEmbeddingStore(embedding_model, db_dirname, batch_size, namespace, config)
    raise ValueError(f"Unknown vector_store_type: {store_type}")
