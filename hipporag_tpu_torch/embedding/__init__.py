"""Embedding model factory.

Name routing mirrors the reference factory (embedding_model/__init__.py:15-30):
model-family substrings (NV-Embed-v2, GritLM, contriever) and explicit
prefixes select backends; anything else goes to the OpenAI-compatible
client. ``jax/<spec>`` names (the JAX package's on-device encoder) go to
the port's encoder on the given torch device, so one configuration drives
both packages. ``NV-Embed-v2/random[-<key>=<value>,...]`` names go to the
port's on-device NV-Embed-v2 with weights drawn from a seed
(``nvembed_encoder.py``); other NV-Embed-v2 names load a checkpoint.
``GritLM/random[-<key>=<value>,...]`` names go to the port's on-device
GritLM-8x7B (``gritlm_encoder.py``); other GritLM names load a checkpoint.
"""

from __future__ import annotations

from typing import Union

import torch

from ..config import BaseConfig
from .base import BaseEmbeddingModel
from .mock import MockEmbeddingModel

__all__ = ["BaseEmbeddingModel", "MockEmbeddingModel", "get_embedding_model"]


def get_embedding_model(config: BaseConfig, device: Union[str, torch.device] = "cuda",
                        mesh_devices=None) -> BaseEmbeddingModel:
    name = config.embedding_model_name
    if name == "mock" or name.startswith("mock/"):
        return MockEmbeddingModel(config)
    if name == "hashing" or name.startswith("hashing/"):
        from .hashing import HashingNgramEmbeddingModel

        return HashingNgramEmbeddingModel(config)
    if name.startswith("jax/"):
        from .encoder import TorchEncoderEmbeddingModel

        return TorchEncoderEmbeddingModel(config, device=device, mesh_devices=mesh_devices)
    if name.startswith("st/") or name.startswith("Transformers/"):
        from .transformers_embed import TransformersEmbeddingModel

        return TransformersEmbeddingModel(config)
    if name.startswith("VLLM/"):
        from .vllm_embed import VLLMEmbeddingModel

        return VLLMEmbeddingModel(config)
    if name == "NV-Embed-v2/random" or name.startswith("NV-Embed-v2/random-"):
        from .nvembed_encoder import NVEmbedV2DeviceEmbeddingModel

        return NVEmbedV2DeviceEmbeddingModel(config, device=device)
    if "NV-Embed-v2" in name:
        from .nvembed import NVEmbedV2EmbeddingModel

        return NVEmbedV2EmbeddingModel(config)
    if name == "GritLM/random" or name.startswith("GritLM/random-"):
        from .gritlm_encoder import GritLMDeviceEmbeddingModel

        return GritLMDeviceEmbeddingModel(config, device=device)
    if "GritLM" in name:
        from .gritlm_embed import GritLMEmbeddingModel

        return GritLMEmbeddingModel(config)
    if "contriever" in name.lower():
        from .contriever import ContrieverEmbeddingModel

        return ContrieverEmbeddingModel(config)
    if "cohere" in name.lower():
        from .cohere_embed import CohereEmbeddingModel

        return CohereEmbeddingModel(config)
    from .openai_embed import OpenAIEmbeddingModel

    return OpenAIEmbeddingModel(config)
