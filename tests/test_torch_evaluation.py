"""The port's quality harnesses against the JAX package's.

- ``run_multihop_eval`` (2-hop and 3-hop chains, mock providers): the four
  numbers equal, with no ``multihop3_error``. The JAX package's run is
  recorded in ``tests/fixtures/torch_port_multihop_expected.json``, which
  ``chip_smoke.py`` phase 7 holds the port to on the GPU; a test here
  regenerates it so it cannot go stale, and ``python
  tests/test_torch_evaluation.py`` rewrites it.
- ``graph_vs_dense_eval``, ``numpy_retrieval_twin`` and ``exact_rank_check``
  on ``data/sample_corpus.json``: equal recalls, paired statistics, twin
  rankings and exact-solver agreement (the hashing embedder, as the 2wiki
  harness runs).
"""

import json
import os
import sys

import pytest
import torch

import hipporag_tpu
import hipporag_tpu_torch
from hipporag_tpu.datasets import load_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(ROOT, "data")


def record_multihop_fixture(save_dir):
    from hipporag_tpu.evaluation.multihop import run_multihop_eval

    return {"result": run_multihop_eval(save_dir=str(save_dir))}


def test_multihop_fixture_unchanged(tmp_path):
    with open(chip_smoke.MULTIHOP_FIXTURE) as fh:
        recorded = json.load(fh)
    assert record_multihop_fixture(tmp_path) == recorded
    assert "multihop3_error" not in recorded["result"] and len(recorded["result"]) == 4


def test_port_multihop_matches_the_fixture(tmp_path):
    from hipporag_tpu_torch.evaluation.multihop import run_multihop_eval

    with open(chip_smoke.MULTIHOP_FIXTURE) as fh:
        want = json.load(fh)["result"]
    got = run_multihop_eval(save_dir=str(tmp_path), device="cpu")
    assert "multihop3_error" not in got
    assert got == want
    assert got["multihop_recall2_graph"] > got["multihop_recall2_dense"]


def _hashing_config(pkg, save_dir):
    return pkg.BaseConfig(llm_name="mock", embedding_model_name="hashing", embedding_dim=256,
                          vector_store_type="memory", save_dir=str(save_dir), retrieval_top_k=20,
                          passage_node_weight=0.1, linking_top_k=3)


def _port(save_dir):
    return hipporag_tpu_torch.HippoRAG(_hashing_config(hipporag_tpu_torch, save_dir), device="cpu")


def _ref(save_dir):
    return hipporag_tpu.HippoRAG(_hashing_config(hipporag_tpu, save_dir))


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """graph_vs_dense_eval on the sample corpus through both packages."""
    from hipporag_tpu.evaluation.harness import graph_vs_dense_eval as ref_eval
    from hipporag_tpu_torch.evaluation.harness import graph_vs_dense_eval as port_eval

    docs, queries, gold_docs, _ = load_dataset("sample", DATA)
    ref_rag, port_rag = _ref(tmp_path_factory.mktemp("ref")), _port(tmp_path_factory.mktemp("port"))
    ref = ref_eval(ref_rag, docs, queries, gold_docs)
    port = port_eval(port_rag, docs, queries, gold_docs)
    return (ref_rag, ref), (port_rag, port), queries


def test_graph_vs_dense_eval_matches_jax(harness_runs):
    (_r, ref), (_p, port), _q = harness_runs
    for key in ("corpus_docs", "num_queries", "graph_nodes", "graph_edges", "recall", "dense_recall", "stats"):
        assert port[key] == ref[key], key
    for name in ("results", "dense_results"):
        assert [s.docs for s in port[name]] == [s.docs for s in ref[name]]


def test_numpy_twin_and_exact_rank_check_match_jax(harness_runs):
    from hipporag_tpu.evaluation import twiki as ref_twiki
    from hipporag_tpu_torch.evaluation import twiki as port_twiki

    (ref_rag, ref), (port_rag, port), queries = harness_runs
    ref_twin = ref_twiki.numpy_retrieval_twin(ref_rag, queries, top_k=10)
    port_twin = port_twiki.numpy_retrieval_twin(port_rag, queries, top_k=10)
    assert port_twin == ref_twin
    # the twin ranks as the device pipeline does
    assert port_twin == [s.docs[:10] for s in port["results"]]
    want = ref_twiki.exact_rank_check(ref_rag, queries, [s.docs for s in ref["results"]], top_k=5)
    got = port_twiki.exact_rank_check(port_rag, queries, [s.docs for s in port["results"]], top_k=5)
    assert got == want
    assert got["solver"] == "native_ppr_serial" and got["agreement"] == 1.0


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp, open(chip_smoke.MULTIHOP_FIXTURE, "w") as fh:
        json.dump(record_multihop_fixture(tmp), fh, indent=1)
        fh.write("\n")
    print("wrote", chip_smoke.MULTIHOP_FIXTURE)
