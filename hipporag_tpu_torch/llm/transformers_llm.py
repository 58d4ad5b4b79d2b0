"""Local HuggingFace causal-LM backend (reference: llm/transformers_llm.py).

Selected by the ``Transformers/<model>`` name prefix. Runs the model with
torch on the host (the device is reserved for the retrieval compute path;
large-scale LLM serving belongs on an external OpenAI-compatible endpoint,
which is the deployment shape the reference also recommends). Responses are
cached in the shared SQLite KV cache for resumable indexing.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

from ..storage.kv_cache import SqliteKVCache, hash_key
from ..utils.logging import get_logger
from .base import BaseLLM, TextChatMessage

logger = get_logger(__name__)


class TransformersLLM(BaseLLM):
    def __init__(self, global_config=None, cache_dir: str = None):
        super().__init__(global_config)
        cfg = self.global_config
        self.model_name = cfg.llm_name.split("/", 1)[1]
        cache_dir = cache_dir or os.path.join(cfg.save_dir, "llm_cache")
        self.cache = SqliteKVCache(
            os.path.join(cache_dir, f"{self.model_name.replace('/', '_')}_cache.sqlite"),
            table="llm",
        )
        self._model = None
        self._tokenizer = None

    def _load(self):
        if self._model is not None:
            return
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        logger.info("Loading local causal LM %s", self.model_name)
        self._tokenizer = AutoTokenizer.from_pretrained(self.model_name)
        self._model = AutoModelForCausalLM.from_pretrained(
            self.model_name, torch_dtype="auto", device_map="auto"
        )
        if self._tokenizer.pad_token is None:
            self._tokenizer.pad_token = self._tokenizer.eos_token
        self._torch = torch

    def _render(self, messages: List[TextChatMessage]) -> str:
        if getattr(self._tokenizer, "chat_template", None):
            return self._tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        return "\n\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\n\nassistant:"

    def infer(
        self, messages: List[TextChatMessage], **kwargs
    ) -> Tuple[str, Dict[str, Any], bool]:
        cfg = self.global_config
        max_new = kwargs.get("max_completion_tokens", cfg.max_new_tokens) or 512
        key = hash_key("llm", self.llm_name, cfg.seed, cfg.temperature, messages, max_new)
        hit = self.cache.get(key)
        if hit is not None:
            return hit[0], hit[1], True

        self._load()
        prompt = self._render(messages)
        inputs = self._tokenizer(prompt, return_tensors="pt").to(self._model.device)
        with self._torch.no_grad():
            out = self._model.generate(
                **inputs,
                max_new_tokens=max_new,
                do_sample=cfg.temperature > 0,
                temperature=max(cfg.temperature, 1e-5),
                pad_token_id=self._tokenizer.pad_token_id,
            )
        gen = out[0][inputs["input_ids"].shape[1] :]
        text = self._tokenizer.decode(gen, skip_special_tokens=True)
        metadata = {
            "prompt_tokens": int(inputs["input_ids"].shape[1]),
            "completion_tokens": int(gen.shape[0]),
            "finish_reason": "length" if gen.shape[0] >= max_new else "stop",
        }
        self.cache.put(key, text, metadata)
        return text, metadata, False
