"""The port's dense entry points against the JAX package.

``retrieve_dpr``, ``dense_passage_retrieval``, ``rag_qa_dpr``,
``StandardRAG``, ``HippoRAG.retrieve`` and IRCoT of both packages run on the
sample corpus with ``jax/random-64x2`` (the encoder of
``tests/test_torch_encoder.py``) and the mock LLM, each package in its own
``save_dir`` (their embedding-cache keys are equal, so a shared one would
hand the port the JAX package's vectors). Rankings must be identical and
EM/F1 equal; doc scores agree to 1e-4 (min-max normalization over passages
whose raw scores lie close together magnifies the encoders' ~1e-7
differences). IRCoT replays ``tests/fixtures/replay_ircot_cache.sqlite``
through the port with a dead LLM endpoint.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
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


def _config(save_dir, pkg=hipporag_tpu_torch, **kw):
    return pkg.BaseConfig(
        llm_name="mock", embedding_model_name="jax/random-64x2", vector_store_type="memory",
        save_dir=str(save_dir), **kw,
    )


def _data():
    return load_dataset("sample", DATA)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    data = _data()
    out = {}
    for name, pkg, kw in (("ref", hipporag_tpu, {}), ("port", hipporag_tpu_torch, {"device": "cpu"})):
        root = tmp_path_factory.mktemp(name)
        out[name] = chip_smoke.entry_point_record(
            pkg.HippoRAG(_config(root / "hipporag", pkg), **kw),
            pkg.StandardRAG(_config(root / "standard", pkg), **kw),
            data,
        )[0]
    return out


@pytest.mark.parametrize("entry", [
    "hipporag.retrieve", "hipporag.rag_qa", "hipporag.retrieve_dpr", "hipporag.rag_qa_dpr",
    "hipporag.dense_passage_retrieval", "standard_rag.retrieve", "standard_rag.rag_qa",
])
def test_entry_point_matches_jax(records, entry):
    chip_smoke.compare_records({entry: records["port"][entry]}, {entry: records["ref"][entry]})


def test_dense_passage_retrieval_ranks_every_passage(records):
    docs = _data()[0]
    record = records["port"]["hipporag.dense_passage_retrieval"]
    assert sorted(record["order"]) == list(range(len(docs)))
    scores = record["scores"]
    assert scores == sorted(scores, reverse=True) and scores[0] == 1.0 and scores[-1] == 0.0


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)], ids=["single", "mesh"])
def test_retrieve_dpr_bucket_padding_and_top_k(tmp_path, mesh_shape):
    """More queries than a bucket (sub-bucket padding across two buckets)
    and a top-k below the passage count, against the JAX package on one
    device: the port on one device, and on a (2, 2) mesh of CPU virtual
    shards with a query count that is not a multiple of dp."""
    docs, queries, _, _ = _data()
    many = [f"{q} variant {i}" for i in range(5) for q in queries]
    assert len(many) % 2 == 1  # not a multiple of the mesh's dp
    got, want = [], []
    for out, pkg, kw in ((want, hipporag_tpu, {}), (got, hipporag_tpu_torch, {"device": "cpu"})):
        shape = mesh_shape if pkg is hipporag_tpu_torch else (1, 1)
        rag = pkg.HippoRAG(_config(tmp_path / pkg.__name__, pkg, ppr_batch_size=8, mesh_shape=shape), **kw)
        rag.index(docs)
        out.extend(rag.retrieve_dpr(many, num_to_retrieve=3))
        if pkg is hipporag_tpu_torch:
            assert rag._backend.dp == mesh_shape[0]
    assert len(got) == len(want) == len(many)
    for g, w in zip(got, want):
        assert g.docs == w.docs and len(g.docs) == 3
        np.testing.assert_allclose(g.doc_scores, w.doc_scores, atol=1e-4)


def test_standard_rag_empty_index(tmp_path):
    queries, gold = ["where?", "who?"], [["a"], ["b"]]
    outs = []
    for pkg, kw in ((hipporag_tpu, {}), (hipporag_tpu_torch, {"device": "cpu"})):
        rag = pkg.StandardRAG(_config(tmp_path / pkg.__name__, pkg), **kw)
        rag.index([])
        sols = rag.retrieve(queries)
        assert [s.docs for s in sols] == [[], []]
        outs.append(rag.retrieve(queries, gold_docs=gold)[1])
    assert outs[0] == outs[1]


def test_standard_rag_delete_then_retrieve(tmp_path):
    docs, queries, _, _ = _data()
    results = []
    for pkg, kw in ((hipporag_tpu, {}), (hipporag_tpu_torch, {"device": "cpu"})):
        rag = pkg.StandardRAG(_config(tmp_path / pkg.__name__, pkg), **kw)
        rag.index(docs)
        rag.delete(docs[:2] + ["not indexed"])
        results.append([s.docs for s in rag.retrieve(queries)])
    assert results[0] == results[1]
    assert all(docs[0] not in r and docs[1] not in r for r in results[1])


@pytest.fixture(scope="module")
def replay_mod():
    spec = importlib.util.spec_from_file_location(
        "make_replay_fixture", os.path.join(ROOT, "scripts", "make_replay_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ircot_replay_through_port(replay_mod, tmp_path, monkeypatch):
    """``run_ircot_pipeline`` of ``scripts/make_replay_fixture.py`` with the
    port's HippoRAG: every LLM response replayed (a miss is a connection
    error), the pinned EM/F1 and the branch counts [1, 2, 2]."""
    monkeypatch.chdir(ROOT)
    fixture = os.path.join(ROOT, "tests", "fixtures", "replay_ircot_cache.sqlite")
    cfg = hipporag_tpu_torch.BaseConfig(save_dir=str(tmp_path / "ir"), llm_replay_cache_path=fixture,
                                        **replay_mod.IRCOT_CONFIG_KWARGS)
    rag = hipporag_tpu_torch.HippoRAG(global_config=cfg, device="cpu")
    docs, queries, gold_docs, gold_answers = _data()
    rag.index(docs)
    sols, _responses, _meta, retrieval, qa = rag.answer_with_ircot(
        queries, gold_docs=gold_docs, gold_answers=gold_answers, max_qa_steps=replay_mod.IRCOT_MAX_STEPS)
    assert qa["ExactMatch"] == pytest.approx(replay_mod.IRCOT_EXPECTED_EM, abs=1e-4)
    assert qa["F1"] == pytest.approx(replay_mod.IRCOT_EXPECTED_F1, abs=1e-4)
    assert sorted(len(s.thoughts or []) for s in sols) == [1, 2, 2]
    assert all("So the answer is:" in s.thoughts[-1] for s in sols)
    assert retrieval is not None
    from hipporag_tpu_torch.llm.openai_llm import CacheOpenAILLM

    assert isinstance(rag.llm, CacheOpenAILLM)


def test_rag_qa_replay_through_port(replay_mod, tmp_path, monkeypatch):
    """``run_pipeline`` of ``scripts/make_replay_fixture.py`` with the port's
    HippoRAG: index -> retrieve -> filter -> QA replayed from
    ``tests/fixtures/replay_sample_cache.sqlite``, the pinned EM/F1."""
    monkeypatch.chdir(ROOT)
    fixture = os.path.join(ROOT, "tests", "fixtures", "replay_sample_cache.sqlite")
    cfg = hipporag_tpu_torch.BaseConfig(save_dir=str(tmp_path / "qa"), llm_replay_cache_path=fixture,
                                        **replay_mod.CONFIG_KWARGS)
    rag = hipporag_tpu_torch.HippoRAG(global_config=cfg, device="cpu")
    docs, queries, gold_docs, gold_answers = _data()
    rag.index(docs)
    qa = rag.rag_qa(queries, gold_docs=gold_docs, gold_answers=gold_answers)[4]
    assert qa["ExactMatch"] == pytest.approx(replay_mod.EXPECTED_EM, abs=1e-4)
    assert qa["F1"] == pytest.approx(replay_mod.EXPECTED_F1, abs=1e-4)


def test_answer_with_ircot_matches_jax(tmp_path):
    """Multi-step IRCoT with the mock LLM: the same thoughts, rankings and EM/F1."""
    docs, queries, gold_docs, gold_answers = _data()
    outs = []
    for pkg, kw in ((hipporag_tpu, {}), (hipporag_tpu_torch, {"device": "cpu"})):
        rag = pkg.HippoRAG(_config(tmp_path / pkg.__name__, pkg), **kw)
        rag.index(docs)
        outs.append(rag.answer_with_ircot(queries, gold_docs=gold_docs, gold_answers=gold_answers,
                                          max_qa_steps=3))
    (ref_sols, *_, ref_ret, ref_qa), (sols, *_, ret, qa) = outs
    assert [s.thoughts for s in sols] == [s.thoughts for s in ref_sols]
    assert [s.docs for s in sols] == [s.docs for s in ref_sols]
    assert [s.answer for s in sols] == [s.answer for s in ref_sols]
    assert (ret, qa) == (ref_ret, ref_qa)
    with pytest.raises(ValueError):
        hipporag_tpu_torch.HippoRAG(_config(tmp_path / "bad", dataset="nope"), device="cpu").retrieve_ircot(
            queries, max_qa_steps=2)


@pytest.mark.parametrize("rag_type", ["hipporag", "standard"])
def test_cli_matches_main(tmp_path, monkeypatch, rag_type):
    """``python -m hipporag_tpu_torch`` as a subprocess on the CPU against
    ``main.py`` of the JAX package, run in this process."""
    args = ["--dataset", "sample", "--llm_name", "mock", "--embedding_name", "jax/random-64x2",
            "--rag_type", rag_type, "--data_dir", DATA]
    port_json = tmp_path / "port.json"
    proc = subprocess.run(
        [sys.executable, "-m", "hipporag_tpu_torch", *args, "--device", "cpu",
         "--vector_store_type", "memory", "--save_dir", str(tmp_path / "port"),
         "--output_json", str(port_json)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "QA:" in proc.stdout

    import main

    ref_json = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["main.py", *args, "--save_dir", str(tmp_path / "ref"),
                                      "--output_json", str(ref_json)])
    assert main.main() == 0
    port, ref = json.loads(port_json.read_text()), json.loads(ref_json.read_text())
    assert port["qa_eval"] == ref["qa_eval"] and port["retrieval_eval"] == ref["retrieval_eval"]
    for p, r in zip(port["solutions"], ref["solutions"]):
        assert p["docs"] == r["docs"] and p["answer"] == r["answer"]


def test_cli_refuses_serve():
    """``--serve`` is ported (``tests/test_torch_serving.py`` serves through
    it); what the CLI still refuses is a front end it does not have."""
    from hipporag_tpu_torch.__main__ import parse_args

    args = parse_args(["--serve", "--serve_frontend", "native", "--port", "0"])
    assert args.serve and args.serve_frontend == "native" and args.port == 0
    assert args.serve_max_wait_ms == 8.0 and args.host == "127.0.0.1"
    with pytest.raises(SystemExit):
        parse_args(["--serve", "--serve_frontend", "grpc"])
