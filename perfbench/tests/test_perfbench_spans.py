"""The per-layer metrics read from the program's span log: a traced run of
the cell, cut to run on the CPU, reports each of them."""

from __future__ import annotations

import time

import pytest
import torch

from tiny import manifest, tiny_spec

from perfbench import run

SPAN_METRICS = ["fact_topk_ms.batch", "filter_ms.batch", "result_build_ms.batch", "ppr_iters.batch",
                "ppr_iter_ms.batch"]
SEED = 2**31 + 91


@pytest.fixture(scope="module")
def traced():
    # one thread per process: with several test processes on the CPU, a call
    # slowed past the window would leave no call to profile
    cell, threads = "nvembed2-musique.batch", torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, _rows = run.execute(manifest(), cell, SEED, 3.0, True, torch.device("cpu"), time.perf_counter(),
                                    spec=tiny_spec(cell))
    finally:
        torch.set_num_threads(threads)
    return result


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_traced_run_reports_the_span_metric(traced, metric):
    assert traced["correct"]
    assert traced["metrics"][metric]["value"] > 0
    entry = next(m for m in manifest()["per_layer"] if m["name"] == metric)
    assert traced["metrics"][metric]["unit"] == entry["unit"]


def test_iterations_per_tile_lie_within_the_solver_cap(traced):
    from hipporag_tpu_torch.config import BaseConfig

    config = tiny_spec("nvembed2-musique.batch")[1]["hipporag"]
    cap = config.get("ppr_max_iters", BaseConfig().ppr_max_iters)
    assert 1 <= traced["metrics"]["ppr_iters.batch"]["value"] <= cap


def test_an_untraced_run_reads_no_span():
    """Spans of an earlier traced call stay in the log; a run without a
    trace reads none of them."""
    from perfbench.spans import mean_ms, ppr_totals

    ctx = run.Context(counters={}, trace=None, window_s=1.0, stages=[], traced_stages=[])
    assert mean_ms(ctx, "retrieve/filter") is None and ppr_totals(ctx) is None
