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
    """The cell's spec, cut to run in seconds on the CPU: fewer passages and
    questions, and the question encoder the configuration names, if any, at
    the sizes its module states for the CPU (``cut_encoder``)."""
    from perfbench import run

    cell_entry, config, traffic, limits = run.cell_spec(manifest(parked=True), cell)
    config = copy.deepcopy(config)
    config["corpus"]["passages"] = passages
    traffic = dict(traffic, sample=48, questions_per_call=64)
    traffic.update(params)
    config, limits = cut_encoder(config, dict(limits))
    return cell_entry, config, traffic, limits


def cut_encoder(config: dict, limits: dict) -> tuple:
    """(configuration, limits) with the encoder that ``query_encoder`` names
    at its module's ``TINY`` keys, the index vectors at that width, and the
    module's ``TINY_LIMITS`` in place of the cell's; unchanged without the key."""
    if not config.get("query_encoder"):
        return config, limits
    from perfbench.encoders import load

    module = load(config["query_encoder"])
    config = dict(config, **module.TINY)
    dim = config["hidden_size"]
    config["index_vectors"] = dict(config["index_vectors"], dim=dim)
    config["hipporag"] = dict(config["hipporag"], embedding_dim=dim)
    return config, dict(limits, **module.TINY_LIMITS)


# A configuration whose questions the ``bert`` pair encodes inside the
# timed call (``encoders/bert.py``), parked as ``.dpr`` is: nvembed2-musique's
# corpus and settings with that encoder, cut as every encoder cell is.
ENCODER_CELL = "bert-tiny-musique.batch"


def encoder_spec(passages: int = 400, **params):
    """The parked encoder cell's spec, cut as ``tiny_spec`` cuts a cell."""
    cell, config, traffic, limits = tiny_spec("nvembed2-musique.batch", passages, **params)
    config = dict(config, name="bert-tiny-musique", query_encoder="bert")
    config["hipporag"] = dict(config["hipporag"], embedding_model_name="bert-tiny")
    config, limits = cut_encoder(config, limits)
    cell = dict(cell, name=ENCODER_CELL, config=config["name"])
    return cell, config, traffic, limits
