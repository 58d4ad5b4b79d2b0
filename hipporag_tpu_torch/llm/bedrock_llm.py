"""AWS Bedrock chat backend (reference: llm/bedrock_llm.py:20-131).

Selected by the ``bedrock/<model-id>`` name prefix. Uses the Bedrock
Runtime ``converse`` API through boto3 directly (the reference goes
through litellm; the wire semantics are identical and boto3 is the only
real dependency). Exponential-backoff retry ×``max_retry_attempts`` and a
durable SQLite response cache, matching the reference's ``LLM_Cache``.

boto3 is an optional dependency: constructing this backend without it
raises ImportError with install guidance; the rest of the framework is
unaffected.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Tuple

from ..storage.kv_cache import SqliteKVCache, hash_key
from ..utils.logging import get_logger
from .base import BaseLLM, TextChatMessage

logger = get_logger(__name__)


class BedrockLLM(BaseLLM):
    def __init__(self, global_config=None, cache_dir: str = None, client=None):
        super().__init__(global_config)
        cfg = self.global_config
        self.model_id = cfg.llm_name.split("/", 1)[1]
        cache_dir = cache_dir or os.path.join(cfg.save_dir, "llm_cache")
        self.cache = SqliteKVCache(
            os.path.join(cache_dir, f"{self.model_id.replace('/', '_')}_cache.sqlite"),
            table="llm",
        )
        self.max_retries = cfg.max_retry_attempts
        if client is not None:
            self.client = client  # injected fake for tests
        else:
            try:
                import boto3
            except ImportError as e:  # pragma: no cover - env without boto3
                raise ImportError(
                    "BedrockLLM requires boto3 (`pip install boto3`); "
                    "or use an OpenAI-compatible endpoint via llm_base_url"
                ) from e
            # config-first region/profile (reference config_utils.py:62-68),
            # env fallback for parity with boto3 conventions
            region = (
                getattr(cfg, "bedrock_region", None)
                or os.environ.get("AWS_REGION", "us-east-1")
            )
            profile = getattr(cfg, "bedrock_aws_profile", None)
            session = boto3.Session(profile_name=profile) if profile else boto3
            self.client = session.client("bedrock-runtime", region_name=region)

    def infer(
        self, messages: List[TextChatMessage], **kwargs
    ) -> Tuple[str, Dict[str, Any], bool]:
        cfg = self.global_config
        max_new = kwargs.get("max_completion_tokens", cfg.max_new_tokens) or 2048
        key = hash_key("llm", self.llm_name, cfg.seed, cfg.temperature, messages, max_new)
        hit = self.cache.get(key)
        if hit is not None:
            return hit[0], hit[1], True

        system = [
            {"text": m["content"]} for m in messages if m["role"] == "system"
        ]
        converse_messages = [
            {"role": m["role"], "content": [{"text": m["content"]}]}
            for m in messages
            if m["role"] != "system"
        ]
        last_err = None
        for attempt in range(self.max_retries):
            try:
                resp = self.client.converse(
                    modelId=self.model_id,
                    messages=converse_messages,
                    system=system,
                    inferenceConfig={
                        "maxTokens": max_new,
                        "temperature": cfg.temperature,
                    },
                )
                text = "".join(
                    blk.get("text", "")
                    for blk in resp["output"]["message"]["content"]
                )
                usage = resp.get("usage", {})
                metadata = {
                    "prompt_tokens": usage.get("inputTokens"),
                    "completion_tokens": usage.get("outputTokens"),
                    "finish_reason": resp.get("stopReason"),
                }
                self.cache.put(key, text, metadata)
                return text, metadata, False
            except Exception as e:  # noqa: BLE001
                last_err = e
                if attempt + 1 < self.max_retries:
                    # backoff only BEFORE a retry — never after the final
                    # failure (dead wall-clock on a hard-down endpoint)
                    wait = min(2**attempt, 30)
                    logger.warning(
                        "Bedrock call failed (attempt %d): %s; retrying in %ss",
                        attempt + 1, e, wait,
                    )
                    time.sleep(wait)
        raise RuntimeError(f"Bedrock inference failed after {self.max_retries} attempts: {last_err}")
