"""OpenAI-compatible chat LLM with durable response cache and retries.

Behavioral parity with the reference's default provider
(llm/openai_gpt.py:26-195): responses cached in SQLite keyed by
(messages, model, seed, temperature); retry with backoff on transient
errors; metadata carries prompt/completion tokens and finish_reason.
Azure endpoints are selected via ``config.azure_endpoint``.

First-party REST client over ``httpx`` (no dependency on the ``openai``
SDK): the chat-completions wire format is the lingua franca of OpenAI,
Azure, vLLM, and most local servers, and a thin pooled HTTP client is all
this framework needs host-side — the heavy lifting happens on the device.
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

_RETRYABLE_STATUS = {408, 409, 429, 500, 502, 503, 504}


def _is_local_endpoint(base_url: str) -> bool:
    """True for endpoints that conventionally run without auth: loopback,
    RFC1918 private ranges, link-local, and .local hostnames (self-hosted
    vLLM/TGI). Public endpoints keep the fail-fast missing-key error."""
    import ipaddress
    from urllib.parse import urlparse

    host = (urlparse(base_url).hostname or "").lower()
    if host in ("localhost",) or host.endswith(".local"):
        return True
    try:
        ip = ipaddress.ip_address(host)
    except ValueError:
        return False
    return ip.is_loopback or ip.is_private or ip.is_link_local


class OpenAIChatClient:
    """Minimal pooled chat-completions client (OpenAI / Azure / compatible).

    Mirrors the reference's high-throughput httpx pool settings
    (llm/openai_gpt.py:151-170) without the SDK wrapper.
    """

    def __init__(
        self,
        base_url: str | None = None,
        api_key: str | None = None,
        azure_endpoint: str | None = None,
        timeout: float = 120.0,
        transport=None,
    ):
        import httpx

        self.azure = bool(azure_endpoint)
        if self.azure:
            self.base_url = azure_endpoint.rstrip("/")
            self.api_version = os.environ.get("AZURE_OPENAI_API_VERSION", "2024-10-21")
            key = api_key or os.environ.get("AZURE_OPENAI_API_KEY", "EMPTY")
            headers = {"api-key": key}
        else:
            self.base_url = (base_url or "https://api.openai.com/v1").rstrip("/")
            key = api_key or os.environ.get("OPENAI_API_KEY")
            if key is None:
                if _is_local_endpoint(self.base_url):
                    key = "EMPTY"  # auth-less local/LAN vLLM/TGI convention
                else:
                    # fail fast like the reference SDK: a missing key would
                    # otherwise send 'Bearer None' and surface as opaque 401s
                    raise ValueError(
                        "No OpenAI API key: set OPENAI_API_KEY (use "
                        "OPENAI_API_KEY=EMPTY for auth-less endpoints) or "
                        f"pass api_key for remote endpoint {self.base_url}"
                    )
            headers = {"Authorization": f"Bearer {key}"}
        headers["Content-Type"] = "application/json"
        self._client = httpx.Client(
            headers=headers,
            timeout=timeout,
            limits=httpx.Limits(max_connections=500, max_keepalive_connections=100),
            transport=transport,
        )

    def chat(self, model: str, messages: List[TextChatMessage], **gen_kwargs) -> dict:
        if self.azure:
            url = (
                f"{self.base_url}/openai/deployments/{model}/chat/completions"
                f"?api-version={self.api_version}"
            )
            payload = {"messages": messages, **gen_kwargs}
        else:
            url = f"{self.base_url}/chat/completions"
            payload = {"model": model, "messages": messages, **gen_kwargs}
        resp = self._client.post(url, content=json.dumps(payload))
        if resp.status_code in _RETRYABLE_STATUS:
            raise TransientAPIError(f"HTTP {resp.status_code}: {resp.text[:500]}")
        resp.raise_for_status()
        return resp.json()

    def close(self):
        self._client.close()


class TransientAPIError(RuntimeError):
    pass


class CacheOpenAILLM(BaseLLM):
    def __init__(self, global_config=None, cache_dir: str = None,
                 cache_filename: str = None, transport=None):
        super().__init__(global_config)
        cfg = self.global_config
        cache_dir = cache_dir or os.path.join(cfg.save_dir, "llm_cache")
        cache_filename = cache_filename or f"{cfg.llm_name.replace('/', '_')}_cache.sqlite"
        self.cache = SqliteKVCache(os.path.join(cache_dir, cache_filename), table="llm")
        self.max_retries = cfg.max_retry_attempts
        self.replay_cache = None
        if cfg.llm_replay_cache_path:
            from .replay_cache import ReferenceReplayCache

            self.replay_cache = ReferenceReplayCache(cfg.llm_replay_cache_path)
        self.client = OpenAIChatClient(
            base_url=cfg.llm_base_url, azure_endpoint=cfg.azure_endpoint,
            transport=transport,
        )

    @classmethod
    def from_experiment_config(cls, global_config):
        return cls(global_config)

    def _cache_key(self, model, messages, gen_kwargs) -> str:
        # keyed by the RESOLVED model (infer accepts a per-call override),
        # not self.llm_name — otherwise two models' responses collide
        cfg = self.global_config
        return hash_key("llm", model, cfg.seed, cfg.temperature, messages, gen_kwargs)

    def infer(
        self, messages: List[TextChatMessage], **kwargs
    ) -> Tuple[str, Dict[str, Any], bool]:
        cfg = self.global_config
        gen_kwargs = {
            "max_completion_tokens": kwargs.pop("max_completion_tokens", cfg.max_new_tokens),
            "n": cfg.num_gen_choices,
            "seed": cfg.seed,
            "temperature": cfg.temperature,
        }
        model = kwargs.pop("model", self.llm_name)
        if kwargs.get("response_format") is not None or cfg.response_format is not None:
            gen_kwargs["response_format"] = kwargs.pop("response_format", cfg.response_format)
        kwargs.pop("response_format", None)
        gen_kwargs = {k: v for k, v in gen_kwargs.items() if v is not None}

        key = self._cache_key(model, messages, gen_kwargs)
        hit = self.cache.get(key)
        if hit is not None:
            return hit[0], hit[1], True

        if self.replay_cache is not None:
            # reference-recorded response replay (pinned parity evals);
            # forward hits into the live cache so the replay file is only
            # consulted once per distinct request
            replayed = self.replay_cache.get(
                messages, model, cfg.seed, cfg.temperature
            )
            if replayed is not None:
                self.cache.put(key, replayed[0], replayed[1])
                return replayed[0], replayed[1], True

        import httpx

        last_err = None
        for attempt in range(self.max_retries):
            if attempt:
                # backoff BEFORE each retry — never after the final failure
                # (a trailing sleep would add dead wall-clock per chunk on a
                # hard-down endpoint, hours across a large OpenIE run)
                wait = min(2 ** (attempt - 1), 30)
                logger.warning(
                    "LLM call failed (attempt %d): %s; retrying in %ss",
                    attempt, last_err, wait,
                )
                time.sleep(wait)
            try:
                resp = self.client.chat(model, messages, **gen_kwargs)
                choice = resp["choices"][0]
                content = choice.get("message", {}).get("content") or ""
                usage = resp.get("usage", {}) or {}
                metadata = {
                    "prompt_tokens": usage.get("prompt_tokens"),
                    "completion_tokens": usage.get("completion_tokens"),
                    "finish_reason": choice.get("finish_reason"),
                }
                self.cache.put(key, content, metadata)
                return content, metadata, False
            except httpx.HTTPStatusError:
                raise  # deterministic 4xx (bad key/model/request): don't retry
            except (TransientAPIError, httpx.TransportError, KeyError, ValueError) as e:
                last_err = e
        raise RuntimeError(f"LLM inference failed after {self.max_retries} attempts: {last_err}")
