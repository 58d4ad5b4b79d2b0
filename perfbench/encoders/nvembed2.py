"""The port's on-device NV-Embed-v2 (``embedding/nvembed_encoder.py``) on the
query path, built through its route and holding weights drawn from the
run's seed (``reference/encoders/nvembed2.py``).

The port's route for NV-Embed-v2 without a checkpoint is the embedding name
``NV-Embed-v2/random[-<key>=<value>,...]``, which states the sizes by their
Hugging Face names and its hashing tokenizer. The model is built through
that name with the seed's weights handed to it in place of the route's own
draw, so the device holds one copy of the weights after set-up. The model
keeps its own tokenizer, batching (a batch padded to its longest text),
instruction prefix, device forward and copy to the host: each question is
read under each instruction, two texts and two rows per question.
"""

from __future__ import annotations

import dataclasses

from hipporag_tpu_torch.embedding.nvembed_encoder import (
    PUBLISHED as ROUTE_SIZES,
    NVEmbedV2DeviceEmbeddingModel,
    route_name,
)

from ..reference.encoders import nvembed2 as plain

MAX_POSITIONS = 32768  # Mistral-7B-v0.1's max_position_embeddings
# The sizes at which the CPU tests run the pair: two layers of 128 with 8
# query heads sharing 2 key/value heads of 16, 16 latents under 4 cross
# heads of the full width, in float32.
TINY = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 448, "vocab_size": 32000, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
        "num_latents": 16, "num_cross_heads": 4, "cross_dim_head": 128, "latent_mlp_mult": 4,
        "max_position_embeddings": 64, "torch_dtype": "float32"}
# set between 6 CPU seeds' 2.26e-7 to 2.88e-7 and the TF32 control's 6.6e-4
# to 1.0e-3 (PERF.md)
TINY_LIMITS = {"embed_err": 1e-5}
# nvidia/NV-Embed-v2's config.json, served in bfloat16 products
PUBLISHED = {**ROUTE_SIZES, "max_position_embeddings": MAX_POSITIONS, "torch_dtype": "bfloat16"}
# the cell's limit: set between 12 sound runs' largest reading on the card,
# 0.0798, and the fp8 control's smallest over 4 seeds, 0.972 (PERF.md)
PROBE_LIMITS = {"embed_err": 0.3}


def embedding_name(config: dict) -> str:
    return route_name({k: config[k] for k in ROUTE_SIZES})


def program(config: dict, hcfg, device, seed: int) -> NVEmbedV2DeviceEmbeddingModel:
    ecfg = dataclasses.replace(hcfg, embedding_model_name=embedding_name(config),
                               embedding_model_dtype=config["torch_dtype"],
                               embedding_max_seq_len=int(config["max_position_embeddings"]))
    model = NVEmbedV2DeviceEmbeddingModel(ecfg, device, params=plain.weights(config, seed, device))
    assert model.compute_dtype == config["torch_dtype"], (model.compute_dtype, config["torch_dtype"])
    return model


def work(config: dict, token_counts) -> tuple:
    """Every product once over the real tokens (no padding). Per token: per
    layer the query, key, value and output projections and the three MLP
    products; the pooling's query and output projections over the cross
    heads, QK^T and PV over the latents, and the GEGLU's two products. Per
    sequence of n tokens and layer, QK^T and PV over its own length (2 n^2
    per query head and head dimension each). Bytes: every linear weight
    read once, the latents' keys and values (computed once per set of
    weights) read once, each token's embedding row and id read, each row
    written in float32."""
    d, f, layers = int(config["hidden_size"]), int(config["intermediate_size"]), int(config["num_hidden_layers"])
    h, kv, hd = int(config["num_attention_heads"]), int(config["num_key_value_heads"]), int(config["head_dim"])
    inner = int(config["num_cross_heads"]) * int(config["cross_dim_head"])
    wide = int(config["latent_mlp_mult"]) * d
    latents = int(config["num_latents"])
    tokens = sum(token_counts)
    squares = sum(n * n for n in token_counts)
    layer_weights = d * (h + 2 * kv) * hd + h * hd * d + 3 * d * f
    pool_weights = 2 * d * inner + 2 * d * wide + wide * d
    flops = (2.0 * tokens * (layers * layer_weights + pool_weights + 2 * latents * inner)
             + 4.0 * squares * layers * h * hd)
    elem = 2 if config["torch_dtype"] == "bfloat16" else 4
    nbytes = (elem * (layers * layer_weights + pool_weights + 2 * latents * inner + tokens * d)
              + 4 * tokens + 4 * d * len(token_counts))
    return flops, nbytes, "bf16" if config["torch_dtype"] == "bfloat16" else "tf32"
