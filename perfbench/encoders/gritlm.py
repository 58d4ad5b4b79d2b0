"""The port's on-device GritLM-8x7B (``embedding/gritlm_encoder.py``) on the
query path, built through its route and holding weights drawn from the
run's seed (``reference/encoders/gritlm.py``).

The port's route for GritLM without a checkpoint is the embedding name
``GritLM/random[-<key>=<value>,...]``, which states the sizes by their
Hugging Face names and its hashing tokenizer. The model is built through
that name with the seed's weights handed to it in place of the route's own
draw; it adopts the experts' weights without a copy, so the device holds
one copy of them after set-up. The model keeps its own tokenizer, batching
(a batch padded to its longest text), instruction template, device forward
and copy to the host: each question is read under each instruction, two
texts and two rows per question.

Besides ``work``, :func:`moe_least_s` gives the mixture-of-experts layer's
least time from the counters the model adds to its ``retrieve/embed`` span,
for ``metrics/moe_roofline.grit.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os

from hipporag_tpu_torch.embedding.gritlm_encoder import (
    PUBLISHED as ROUTE_SIZES,
    GritLMDeviceEmbeddingModel,
    route_name,
)

from .. import roofline as rf
from ..reference.encoders import gritlm as plain

CONFIG_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                           "gritlm-8x7b-musique.json")
MAX_POSITIONS = 32768  # Mixtral-8x7B-v0.1's max_position_embeddings
# The sizes at which the CPU tests run the pair: two layers of 128 with 8
# query heads sharing 2 key/value heads of 16, and 8 experts of 96, top 2,
# in float32.
TINY = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 96, "num_local_experts": 8, "num_experts_per_tok": 2,
        "vocab_size": 32000, "rope_theta": 1e6, "rms_norm_eps": 1e-5, "max_position_embeddings": 64,
        "torch_dtype": "float32"}
# set between 6 CPU seeds' 1.96e-7 to 2.71e-7 and the TF32 control's 6.8e-4
# to 1.5e-2 (PERF.md)
TINY_LIMITS = {"embed_err": 1e-5}
# No ``PUBLISHED`` for ``encoder_probe.py``: the published 32 layers (93.4 GB
# in bf16) do not fit one card; the cell holds 16 (configs/gritlm-8x7b-musique.json).


def embedding_name(config: dict) -> str:
    return route_name({k: config[k] for k in ROUTE_SIZES})


def program(config: dict, hcfg, device, seed: int) -> GritLMDeviceEmbeddingModel:
    ecfg = dataclasses.replace(hcfg, embedding_model_name=embedding_name(config),
                               embedding_model_dtype=config["torch_dtype"],
                               embedding_max_seq_len=int(config["max_position_embeddings"]))
    model = GritLMDeviceEmbeddingModel(ecfg, device, params=plain.weights(config, seed, device))
    assert model.compute_dtype == config["torch_dtype"], (model.compute_dtype, config["torch_dtype"])
    return model


def _sizes(config: dict) -> tuple:
    return (int(config["hidden_size"]), int(config["intermediate_size"]), int(config["num_local_experts"]),
            int(config["num_experts_per_tok"]), int(config["num_hidden_layers"]),
            2 if config["torch_dtype"] == "bfloat16" else 4)


def work(config: dict, token_counts) -> tuple:
    """Every product once over the real tokens (no padding). Per token and
    layer: the query, key, value and output projections, the router, and
    the three products of each of its ``num_experts_per_tok`` experts. Per
    sequence of n tokens and layer, QK^T and PV over its own length (2 n^2
    per query head and head dimension each). Bytes: every weight read once,
    all ``num_local_experts`` experts of every layer, each token's
    embedding row and id read, each row written in float32."""
    d, f, n_exp, top, layers, elem = _sizes(config)
    h, kv, hd = int(config["num_attention_heads"]), int(config["num_key_value_heads"]), int(config["head_dim"])
    tokens = sum(token_counts)
    squares = sum(n * n for n in token_counts)
    attention = d * (h + 2 * kv) * hd + h * hd * d
    flops = 2.0 * tokens * layers * (attention + d * n_exp + top * 3 * d * f) + 4.0 * squares * layers * h * hd
    nbytes = (elem * (layers * (attention + d * n_exp + n_exp * 3 * d * f) + tokens * d)
              + 4 * tokens + 4 * d * len(token_counts))
    return flops, nbytes, "bf16" if config["torch_dtype"] == "bfloat16" else "tf32"


def moe_least_s(config: dict, routed: int, forwards: int) -> float:
    """The least device time of the mixture-of-experts layers of
    ``forwards`` forwards that routed ``routed`` (token, expert) pairs over
    all their layers: the larger of the routed pairs' expert products
    (``6 d f`` each) at the peak of the configuration's precision, and, per
    forward, every layer's ``num_local_experts`` experts' weights read once,
    plus the combine's rows: each pair's float32 down row read and each
    routed token's float32 row written, over the memory's bandwidth."""
    d, f, n_exp, top, layers, elem = _sizes(config)
    flops = 6.0 * d * f * routed
    nbytes = forwards * layers * n_exp * 3 * d * f * elem + 4.0 * d * routed * (1 + 1 / top)
    return rf.least_s(flops, nbytes, "bf16" if config["torch_dtype"] == "bfloat16" else "tf32")


def cell_config() -> dict:
    """The configuration of the ``gritlm-8x7b-musique`` cells, as they run."""
    with open(CONFIG_FILE) as fh:
        return json.load(fh)
