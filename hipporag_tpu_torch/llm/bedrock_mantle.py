"""Bedrock Mantle backend: OpenAI Responses API over Bedrock
(reference: llm/bedrock_mantle.py:20-93).

Selected by the ``bedrock-mantle/<model-id>`` prefix. Auth is either an
API key (``AWS_BEARER_TOKEN_BEDROCK``) or SigV4 request signing when
boto3 credentials are available — same two modes as the reference's
``BedrockMantleSigV4Auth``. The HTTP layer is first-party httpx.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Tuple

from ..storage.kv_cache import SqliteKVCache, hash_key
from ..utils.logging import get_logger
from .base import BaseLLM, TextChatMessage

logger = get_logger(__name__)


def _sigv4_headers(method: str, url: str, body: bytes, region: str,
                   profile: str = None) -> Dict[str, str]:
    """SigV4-sign a request using botocore (only needed without an API key)."""
    try:
        import botocore.auth
        import botocore.awsrequest
        import botocore.session
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "SigV4 auth for Bedrock Mantle requires botocore; "
            "set AWS_BEARER_TOKEN_BEDROCK to use API-key auth instead"
        ) from e
    session = botocore.session.Session(profile=profile)
    creds = session.get_credentials()
    if creds is None:
        raise RuntimeError("No AWS credentials found for SigV4 signing")
    request = botocore.awsrequest.AWSRequest(method=method, url=url, data=body)
    botocore.auth.SigV4Auth(creds.get_frozen_credentials(), "bedrock", region).add_auth(request)
    return dict(request.headers)


class BedrockMantleLLM(BaseLLM):
    def __init__(self, global_config=None, cache_dir: str = None, transport=None):
        super().__init__(global_config)
        import httpx

        cfg = self.global_config
        self.model_id = cfg.llm_name.split("/", 1)[1]
        cache_dir = cache_dir or os.path.join(cfg.save_dir, "llm_cache")
        self.cache = SqliteKVCache(
            os.path.join(cache_dir, f"{self.model_id.replace('/', '_')}_cache.sqlite"),
            table="llm",
        )
        self.max_retries = cfg.max_retry_attempts
        # auth mode parity with the reference (bedrock_mantle.py:53-64):
        # "api_key" requires the bearer env var; "aws_credentials" requires
        # an explicit bedrock_region and SigV4-signs with the named profile
        self.auth_mode = getattr(cfg, "bedrock_mantle_auth", "api_key")
        self.aws_profile = getattr(cfg, "bedrock_aws_profile", None)
        self.region = (
            getattr(cfg, "bedrock_region", None)
            or os.environ.get("AWS_REGION", "us-east-1")
        )
        self.api_key = os.environ.get("AWS_BEARER_TOKEN_BEDROCK")
        if self.auth_mode == "api_key":
            if not self.api_key and transport is None:
                raise ValueError(
                    "AWS_BEARER_TOKEN_BEDROCK is required when "
                    "bedrock_mantle_auth is 'api_key'"
                )
        elif self.auth_mode == "aws_credentials":
            if not getattr(cfg, "bedrock_region", None):
                raise ValueError(
                    "bedrock_region is required when bedrock_mantle_auth "
                    "is 'aws_credentials'"
                )
            self.api_key = None  # force SigV4 signing
        else:
            raise ValueError(
                f"Unsupported Bedrock Mantle auth mode: {self.auth_mode!r} "
                "(expected 'api_key' or 'aws_credentials')"
            )
        self.base_url = (
            cfg.llm_base_url
            or f"https://bedrock-mantle.{self.region}.amazonaws.com/v1"
        ).rstrip("/")
        self._client = httpx.Client(timeout=120.0, transport=transport)

    def _post(self, url: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        if self.api_key:
            headers = {
                "Authorization": f"Bearer {self.api_key}",
                "Content-Type": "application/json",
            }
        else:
            headers = _sigv4_headers(
                "POST", url, body, self.region, profile=self.aws_profile
            )
            headers["Content-Type"] = "application/json"
        resp = self._client.post(url, content=body, headers=headers)
        resp.raise_for_status()
        return resp.json()

    def infer(
        self, messages: List[TextChatMessage], **kwargs
    ) -> Tuple[str, Dict[str, Any], bool]:
        cfg = self.global_config
        max_new = kwargs.get("max_completion_tokens", cfg.max_new_tokens) or 2048
        key = hash_key("llm", self.llm_name, cfg.seed, cfg.temperature, messages, max_new)
        hit = self.cache.get(key)
        if hit is not None:
            return hit[0], hit[1], True

        # Responses API shape: `input` is the message list, output is a list
        # of content items (reference bedrock_mantle.py:68-90).
        payload = {
            "model": self.model_id,
            "input": messages,
            "max_output_tokens": max_new,
            "temperature": cfg.temperature,
        }
        last_err = None
        for attempt in range(self.max_retries):
            try:
                resp = self._post(f"{self.base_url}/responses", payload)
                text = ""
                for item in resp.get("output", []):
                    for part in item.get("content", []):
                        if part.get("type") in ("output_text", "text"):
                            text += part.get("text", "")
                usage = resp.get("usage", {}) or {}
                metadata = {
                    "prompt_tokens": usage.get("input_tokens"),
                    "completion_tokens": usage.get("output_tokens"),
                    "finish_reason": resp.get("status", "completed"),
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
                        "Bedrock Mantle call failed (attempt %d): %s; retrying in %ss",
                        attempt + 1, e, wait,
                    )
                    time.sleep(wait)
        raise RuntimeError(
            f"Bedrock Mantle inference failed after {self.max_retries} attempts: {last_err}"
        )
