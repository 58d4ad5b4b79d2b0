"""Whole runs of every cell, cut to run on the CPU: the plain reference
agrees with the port, the comparison catches a broken timed path, and the
control runs."""

from __future__ import annotations

import time

import pytest
import torch

from tiny import manifest, tiny_spec

from perfbench import run

CELLS = [w["name"] for w in manifest()["workloads"]]
ALL_CELLS = [w["name"] for w in manifest(parked=True)["workloads"]]
SEED = 2**31 + 77


def _run(cell, trace=False):
    # the dense baseline answers fastest: more passages, so more distinct questions
    spec = tiny_spec(cell, passages=1000) if cell.endswith(".dpr") else tiny_spec(cell)
    # a traced window needs a call that starts after 40% of it
    seconds = 2.0 if trace else 0.5
    return run.execute(manifest(parked=True), cell, SEED, seconds, trace, torch.device("cpu"), time.perf_counter(),
                       spec=spec)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_reference_agrees_with_the_port(cell):
    result, rows = _run(cell)
    numbers = {name: value for name, value, _limit in rows}
    assert result["correct"], rows
    assert numbers["malformed"] == 0 and result["failed"] == 0 and result["attempted"] > 0
    assert numbers["rank_gap"] <= 1e-6 and numbers.get("score_err", 0.0) <= 1e-6
    assert numbers.get("fact_gap", 0.0) <= 1e-6
    assert set(result["metrics"]) >= {"setup_s"} and all(v["value"] > 0 for v in result["metrics"].values())


def _step_mfu(cell):
    """The name of the cell's own whole-step share."""
    names = [x["name"] for x in manifest()["per_layer"] if x["name"].startswith("step_mfu") and run.applies(x, cell)]
    assert len(names) == 1, (cell, names)
    return names[0]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_metrics(cell):
    result, _rows = _run(cell, trace=True)
    assert result["correct"]
    mfu = _step_mfu(cell)
    assert mfu in result["metrics"] and result["metrics"][mfu]["value"] > 0
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def _swap_first_two(fn):
    def broken(*args, **kwargs):
        a, b = fn(*args, **kwargs)
        a, b = a.clone(), b.clone()
        a[:, [0, 1]], b[:, [0, 1]] = a[:, [1, 0]], b[:, [1, 0]]
        return a, b
    return broken


def _state_unchanged(fn):
    def broken(graph, reset, **kwargs):
        p, iters = fn(graph, reset, **dict(kwargs, max_iters=0))
        return p, iters
    return broken


def _half_batch(fn):
    def broken(queries, *args, **kwargs):
        half = max(1, int((queries.abs().sum(1) > 0).sum()) // 2)  # of the real (nonzero) rows
        vals, idx = fn(queries, *args, **kwargs)
        vals, idx = vals.clone(), idx.clone()
        vals[half:], idx[half:] = vals[0], idx[0]
        return vals, idx
    return broken


FAULTS = [
    # an answer altered where it is produced
    ("nvembed2-musique.batch", "hipporag_tpu_torch.hipporag", "rank_documents_topk", _swap_first_two),
    ("nvembed2-musique.dpr", "hipporag_tpu_torch.hipporag", "topk_lower_index", _swap_first_two),
    # a step that returns its state unchanged: PageRank runs no iteration
    ("nvembed2-musique.batch", "hipporag_tpu_torch.models.retrieval", "batched_ppr_ell", _state_unchanged),
    # half of each bucket left out: its rows get the first row's facts
    ("nvembed2-musique.batch", "hipporag_tpu_torch.hipporag", "fact_topk", _half_batch),
]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS, ids=[f"{c}-{n}-{f.__name__}" for c, _m, n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, module, name, fault):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    result, rows = _run(cell)
    assert not result["correct"], rows


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_runs(cell):
    from perfbench import control

    _cell, config, params, limits = tiny_spec(cell)
    numbers = control.control_numbers(config, params, SEED, 40, torch.device("cpu"))
    assert set(limits) - {"unanswered"} <= set(numbers)


@pytest.mark.chip
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_fails_at_the_cells_size(cuda_device, cell):
    """The reference in TF32, in the program's place, at the cell's own
    size: on three seeds it breaks at least one limit each time."""
    from perfbench import control

    _cell, config, params, limits = run.cell_spec(manifest(parked=True), cell)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        numbers = control.control_numbers(config, params, seed, params["sample"], cuda_device)
        assert any(numbers[n] > limits[n] for n in limits if n in numbers), numbers
