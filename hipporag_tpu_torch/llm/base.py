"""LLM provider base class (reference contract: llm/base.py:113-194).

``infer(messages, **kwargs) -> (response_text, metadata, cache_hit)`` and
``batch_infer`` over message lists. Metadata carries token accounting and
``finish_reason`` (used by OpenIE to trigger truncated-JSON repair).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

TextChatMessage = Dict[str, str]  # {"role": ..., "content": ...}


class BaseLLM(ABC):
    def __init__(self, global_config=None):
        from ..config import BaseConfig

        self.global_config = global_config or BaseConfig()
        self.llm_name = self.global_config.llm_name

    @abstractmethod
    def infer(
        self, messages: List[TextChatMessage], **kwargs
    ) -> Tuple[str, Dict[str, Any], bool]:
        """Return (response_text, metadata, cache_hit)."""

    def batch_infer(
        self, batch_messages: List[List[TextChatMessage]], max_workers: int = 16, **kwargs
    ) -> List[Tuple[str, Dict[str, Any], bool]]:
        """Concurrent fan-out over independent requests (network-bound)."""
        if len(batch_messages) <= 1:
            return [self.infer(m, **kwargs) for m in batch_messages]
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(lambda m: self.infer(m, **kwargs), batch_messages))
