"""Read-only adapter over the REFERENCE's SQLite LLM-cache format.

The reference caches every LLM response in SQLite as
``cache(key TEXT PRIMARY KEY, message TEXT, metadata TEXT)`` with
``key = sha256(json.dumps({"messages":…, "model":…, "seed":…,
"temperature":…}, sort_keys=True, default=str))``
(reference llm/openai_gpt.py:44-75). This adapter reproduces that key
derivation bit-for-bit so OpenIE / recognition-memory-filter / QA
responses recorded by a reference run can be REPLAYED through this
framework — the SURVEY §7 "LLM nondeterminism" requirement: parity evals
pin cached LLM outputs instead of depending on a live, nondeterministic
model.

Enable via ``BaseConfig(llm_replay_cache_path=…)``; the provider consults
it after its own cache misses and forwards hits into its own cache.
"""

from __future__ import annotations

import hashlib
import json
import sqlite3
from typing import Any, Dict, List, Optional, Tuple


def reference_cache_key(
    messages: List[Dict[str, str]],
    model: Optional[str],
    seed: Optional[int],
    temperature: Optional[float],
) -> str:
    """The reference's exact key derivation (llm/openai_gpt.py:44-51)."""
    key_data = {
        "messages": messages,
        "model": model,
        "seed": seed,
        "temperature": temperature,
    }
    key_str = json.dumps(key_data, sort_keys=True, default=str)
    return hashlib.sha256(key_str.encode("utf-8")).hexdigest()


class ReferenceReplayCache:
    """Read-only lookup into a reference-format cache file."""

    def __init__(self, path: str):
        self.path = path

    def get(
        self,
        messages: List[Dict[str, str]],
        model: Optional[str],
        seed: Optional[int],
        temperature: Optional[float],
    ) -> Optional[Tuple[str, Dict[str, Any]]]:
        key = reference_cache_key(messages, model, seed, temperature)
        try:
            conn = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        except sqlite3.OperationalError:
            return None
        try:
            row = conn.execute(
                "SELECT message, metadata FROM cache WHERE key = ?", (key,)
            ).fetchone()
        except sqlite3.OperationalError:
            return None
        finally:
            conn.close()
        if row is None:
            return None
        message, metadata_str = row
        try:
            metadata = json.loads(metadata_str) if metadata_str else {}
        except (TypeError, ValueError):
            metadata = {}
        return message, metadata
