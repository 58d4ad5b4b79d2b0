"""Helpers of the benchmark's tests: the manifest and cells cut to run in
seconds on the CPU."""

from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# Cells whose files are kept but that BENCHMARK.json does not list yet: the
# tests drive them too, so that a later manifest entry finds them working.
PARKED = [{"name": "nvembed2-musique.dpr", "config": "nvembed2-musique", "traffic": "dpr", "chips": 1,
           "why": "retrieve_dpr only"}]


def manifest(parked: bool = False) -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        m = json.load(fh)
    if parked:
        m["workloads"] += PARKED
    return m


def tiny_spec(cell: str, passages: int = 400, **params):
    """The cell's spec, cut to run in seconds on the CPU: fewer passages."""
    from perfbench import run

    cell_entry, config, traffic, limits = run.cell_spec(manifest(parked=True), cell)
    config = copy.deepcopy(config)
    config["corpus"]["passages"] = passages
    traffic = dict(traffic, sample=48, questions_per_call=64)
    traffic.update(params)
    return cell_entry, config, traffic, dict(limits)


# A configuration whose questions the ``bert`` pair encodes inside the
# timed call (``encoders/bert.py``), parked as ``.dpr`` is: nvembed2-musique's
# corpus and settings at the encoder's width.
ENCODER_CELL = "bert-tiny-musique.batch"
BERT_TINY = {"query_encoder": "bert", "hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
             "intermediate_size": 1024, "vocab_size": 30522, "max_position_embeddings": 512,
             "layer_norm_eps": 1e-12, "hidden_act": "gelu_new", "torch_dtype": "float32"}
ENCODER_LIMITS = {"embed_err": 1e-5}


def encoder_spec(passages: int = 400, **params):
    """The parked encoder cell's spec, cut as ``tiny_spec`` cuts a cell."""
    cell, config, traffic, limits = tiny_spec("nvembed2-musique.batch", passages, **params)
    config = dict(config, name="bert-tiny-musique", **BERT_TINY)
    dim = config["hidden_size"]
    config["index_vectors"] = dict(config["index_vectors"], dim=dim)
    config["hipporag"] = dict(config["hipporag"], embedding_dim=dim, embedding_model_name="bert-tiny")
    cell = dict(cell, name=ENCODER_CELL, config=config["name"])
    return cell, config, traffic, dict(limits, **ENCODER_LIMITS)
