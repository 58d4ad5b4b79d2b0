"""The port's on-device BERT encoder (``embedding/encoder.py``) on the
query path, built as the port builds it and holding weights drawn from the
run's seed (``reference/encoders/bert.py``).

The port's route for an encoder without a checkpoint is the embedding name
``jax/random-<width>x<layers>``: ``width // 64`` heads, an MLP of four
widths, BERT's vocabulary of 30,522 and 512 positions, and its hashing
tokenizer. Its ``TorchEncoderEmbeddingModel`` is built through that name,
and the seed's weights are loaded into its ``BertEncoder`` by
``load_state_dict``. The model keeps its own tokenizer, batching, bucket
padding, device forward, copy to the host and question format: the bare
question under either instruction (a symmetric encoder).
"""

from __future__ import annotations

import dataclasses

import torch

from hipporag_tpu_torch.embedding.encoder import BertEncoder, TorchEncoderEmbeddingModel

from ..reference.encoders import bert as plain

PRECISION = {"bfloat16": "bf16", "float32": "tf32"}
# the shapes that the port's random route fixes, beside the width and depth
# its embedding name gives
ROUTE = {"vocab_size": 30522, "max_position_embeddings": 512}

# The sizes at which the CPU tests run the pair, whatever widths a
# configuration states: a third of BERT-base's width in two layers, heads
# of 64 and an MLP of four widths as the route builds them, in float32.
TINY = {"hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 1024,
        **ROUTE, "layer_norm_eps": 1e-12, "hidden_act": "gelu_new", "torch_dtype": "float32"}
# set between 6 CPU seeds' 1.68e-7 to 2.04e-7 and the TF32 control's 7.2e-5 (PERF.md)
TINY_LIMITS = {"embed_err": 1e-5}
# google-bert/bert-base-uncased's config.json, which the encoder probe runs;
# the port computes the tanh GELU (``gelu_new``) and its encoder serves
# bfloat16 products by default
PUBLISHED = {"hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
             **ROUTE, "layer_norm_eps": 1e-12, "hidden_act": "gelu_new", "torch_dtype": "bfloat16"}
# set between the probe's sound runs' largest reading and the control's smallest (PERF.md)
PROBE_LIMITS = {"embed_err": 0.02}


def embedding_name(config: dict) -> str:
    """The port's embedding name for ``config``'s encoder; refuses widths
    that route cannot build."""
    d, layers = int(config["hidden_size"]), int(config["num_hidden_layers"])
    stated = {k: config[k] for k in ("num_attention_heads", "intermediate_size", *ROUTE)}
    built = dict(ROUTE, num_attention_heads=max(1, d // 64), intermediate_size=4 * d)
    if stated != built:
        raise ValueError(f"the port's random encoder route builds {built} at width {d}, "
                         f"the configuration states {stated}")
    return f"jax/random-{d}x{layers}"


def program(config: dict, hcfg, device, seed: int) -> TorchEncoderEmbeddingModel:
    ecfg = dataclasses.replace(hcfg, embedding_model_name=embedding_name(config),
                               embedding_model_dtype=config["torch_dtype"])
    model = TorchEncoderEmbeddingModel(ecfg, device)
    assert model.compute_dtype == config["torch_dtype"], (model.compute_dtype, config["torch_dtype"])
    seeded = BertEncoder(plain.weights(config, seed, device), int(config["num_attention_heads"]),
                         model.compute_dtype, torch.device(device))
    model.encoder.load_state_dict(seeded.state_dict())
    return model


def work(config: dict, token_counts) -> tuple:
    """Every product once over the real tokens (no padding): per layer the
    four d x d projections, the two MLP products and, per sequence of n
    tokens, QK^T and PV (2 n^2 d each); the linear weights read once, each
    token's embedding row and id read, each row written in float32."""
    d, f = int(config["hidden_size"]), int(config["intermediate_size"])
    layers = int(config["num_hidden_layers"])
    tokens = sum(token_counts)
    squares = sum(n * n for n in token_counts)
    flops = layers * (2.0 * tokens * (4 * d * d + 2 * d * f) + 4.0 * squares * d)
    elem = 2 if config["torch_dtype"] == "bfloat16" else 4
    nbytes = elem * (layers * (4 * d * d + 2 * d * f) + tokens * d) + 4 * tokens + 4 * d * len(token_counts)
    return flops, nbytes, PRECISION[config["torch_dtype"]]
