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
