"""The port's embedding factory.

``jax/<spec>`` names (the JAX package's on-device encoder) go to the
port's encoder on the given torch device, so one ``BaseConfig`` drives both
packages. Every other name goes to ``hipporag_tpu.embedding``'s factory,
whose backends for those names import no JAX.
"""

from __future__ import annotations

from typing import Union

import torch

from hipporag_tpu.config import BaseConfig
from hipporag_tpu.embedding import get_embedding_model as _host_embedding_model
from hipporag_tpu.embedding.base import BaseEmbeddingModel

__all__ = ["get_embedding_model"]


def get_embedding_model(config: BaseConfig, device: Union[str, torch.device] = "cuda") -> BaseEmbeddingModel:
    if config.embedding_model_name.startswith("jax/"):
        from .encoder import TorchEncoderEmbeddingModel

        return TorchEncoderEmbeddingModel(config, device=device)
    return _host_embedding_model(config)
