"""LLM provider factory with name-prefix routing.

Mirrors the reference's routing scheme (llm/__init__.py:16-29):
``mock`` → MockLLM (tests), ``bedrock/`` → Bedrock, ``bedrock-mantle/`` →
Bedrock Mantle, ``Transformers/`` → local HF, anything else →
OpenAI-compatible chat endpoint.
"""

from __future__ import annotations

from ..config import BaseConfig
from .base import BaseLLM, TextChatMessage
from .mock import MockLLM

__all__ = ["BaseLLM", "MockLLM", "TextChatMessage", "get_llm"]


def get_llm(config: BaseConfig) -> BaseLLM:
    name = config.llm_name
    if name == "mock" or name.startswith("mock/"):
        return MockLLM(config)
    if name.startswith("bedrock-mantle/"):
        from .bedrock_mantle import BedrockMantleLLM

        return BedrockMantleLLM(config)
    if name.startswith("bedrock/"):
        from .bedrock_llm import BedrockLLM

        return BedrockLLM(config)
    if name.startswith("Transformers/"):
        from .transformers_llm import TransformersLLM

        return TransformersLLM(config)
    from .openai_llm import CacheOpenAILLM

    return CacheOpenAILLM.from_experiment_config(config)
