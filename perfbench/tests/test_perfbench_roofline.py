"""The least-work arithmetic, on shapes worked out by hand."""

from __future__ import annotations

import pytest

from tiny import manifest  # noqa: F401

from perfbench import roofline as rf


def test_peaks():
    assert rf.PEAK_FLOPS == {"tf32": 495e12, "bf16": 989e12, "fp32": 67e12}
    assert rf.HBM_BYTES_PER_S == 3.35e12


def test_dense_scores_and_least_time():
    # 2 queries x 3 keys x 4 wide: 2*2*3*4 = 48 flops; (12 + 8 + 6) floats
    flops, nbytes = rf.dense_scores(2, 3, 4)
    assert (flops, nbytes) == (48.0, 104)
    assert rf.least_s(flops, nbytes) == pytest.approx(104 / 3.35e12)
    assert rf.least_s(495e12, 1.0) == pytest.approx(1.0)
    assert rf.least_s(989e12, 0.0, "bf16") == pytest.approx(1.0)


def test_k1_and_topk():
    # 128 queries, 256 keys (2 tiles), 32 wide
    flops, nbytes = rf.k1_pass_a(128, 256, 32)
    assert flops == 2 * 128 * 256 * 32
    assert nbytes == 4 * (256 * 32 + 128 * 32 + 2 * 128 * 2)
    flops, nbytes = rf.fact_topk(1, 10, 4, 5)
    assert (flops, nbytes) == (80.0, 4 * 44 + 12 * 5)
    assert rf.topk(2, 10, 3) == (0.0, 4 * 20 + 12 * 6)


def test_graph_stages():
    # 10 entries, 5 nodes, 2 columns, 3 iterations: per iteration 80 + 80 bytes
    assert rf.ppr(10, 5, 2, 3) == (2 * 10 * 2 * 3, 160 * 3)
    assert rf.seeds(2, 5, 3) == (0.0, 4 * 2 * 8)
    assert rf.passage_scores(2, 3) == (6.0, 72)

