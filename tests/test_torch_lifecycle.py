"""The port's ``HippoRAG.delete`` and re-index against the JAX package.

The delete cases of ``tests/test_e2e.py`` run on both packages with the
mock LLM and embedder on the CPU, each package in its own ``save_dir``
with its own ``BaseConfig``. After every step both packages must rank the
same passages (scores to 1e-5), hold the same device index (the ELL layout
and the fact/passage/node arrays array for array, the same sticky
capacities) and take the same PPR iteration counts from the same resets.
The random lifecycle replay runs one operation sequence through both. The
sample lifecycle of ``chip_smoke.py`` phase 6 (index -> delete -> retrieve
-> re-index -> retrieve, float32 and bfloat16) is recorded from the JAX
package in ``tests/fixtures/torch_port_lifecycle_expected.json``; a test
here regenerates it so it cannot go stale, and
``python tests/test_torch_lifecycle.py`` rewrites it.
"""

import json
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hipporag_tpu
import hipporag_tpu_torch
from hipporag_tpu.ops import pagerank as ref_pagerank
from hipporag_tpu_torch.ops import pagerank as port_pagerank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

DATA_DIR = os.path.join(ROOT, "data")
PACKAGES = (("ref", hipporag_tpu, {}), ("port", hipporag_tpu_torch, {"device": "cpu"}))
LIFECYCLE_DTYPES = ("float32", "bfloat16")


def _config(pkg, save_dir, **kw):
    base = dict(llm_name="mock", embedding_model_name="mock", save_dir=str(save_dir),
                embedding_dim=96, ppr_batch_size=4, retrieval_top_k=9)
    base.update(kw)
    return pkg.BaseConfig(**base)


def _pair(root, **kw):
    """Both packages' HippoRAG on one configuration, each in its own save_dir."""
    return {tag: pkg.HippoRAG(global_config=_config(pkg, root / tag, **kw), **extra)
            for tag, pkg, extra in PACKAGES}


def _both(rags, fn):
    return {tag: fn(rag) for tag, rag in rags.items()}


@pytest.fixture(scope="module")
def toy_data():
    return hipporag_tpu_torch.load_dataset("sample", DATA_DIR)


def _assert_same_solutions(got, want, what=""):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.question == w.question
        assert g.docs == w.docs, (what, g.question)
        np.testing.assert_allclose(g.doc_scores, w.doc_scores, rtol=1e-5, atol=1e-7, err_msg=what)


def _ppr_iters(tag, rag):
    """PPR iteration counts over the rag's device graph, one reset at a time:
    each passage node alone, and an all-zero row (the uniform fallback)."""
    cfg = rag.global_config
    graph = (rag._index_state if tag == "ref" else rag._backend.index).graph
    resets = np.zeros((len(rag.passage_node_keys) + 1, np.asarray(graph.dangling).shape[0]), np.float32)
    for i, key in enumerate(rag.passage_node_keys):
        resets[i, rag.graph.node_to_idx[key]] = 1.0
    iters = []
    for reset in resets:
        kw = dict(damping=cfg.damping, max_iters=cfg.ppr_max_iters, tol=cfg.ppr_tol, return_iters=True)
        if tag == "ref":
            _, it = ref_pagerank.batched_ppr_ell(graph, jnp.asarray(reset[None]), **kw)
        else:
            _, it = port_pagerank.batched_ppr_ell(graph, torch.from_numpy(reset[None]), **kw)
        iters.append(int(np.asarray(it)[0]))
    return iters


def _assert_same_device_state(rags):
    ref, port = rags["ref"], rags["port"]
    assert ref.ready_to_retrieve and port.ready_to_retrieve
    g_ref, g_port = ref._index_state.graph, port._backend.index.graph
    assert len(g_ref.bucket_idx) == len(g_port.bucket_idx)
    for name in ("bucket_idx", "bucket_wgt"):
        for a, b in zip(getattr(g_ref, name), getattr(g_port, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    for name in ("hub_idx", "hub_wgt", "hub_seg", "hub_zero", "local_inv", "slot_to_node", "dangling", "num_nodes"):
        np.testing.assert_array_equal(np.asarray(getattr(g_ref, name)), getattr(g_port, name).numpy(), err_msg=name)
    for name in ("fact_subj_node", "fact_obj_node", "node_chunk_counts", "passage_node_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(ref._index_state, name)),
                                      getattr(port._backend.index, name).numpy(), err_msg=name)
    for key in ("node", "edge", "fact", "passage", "ell"):
        assert ref._capacities[key] == port._capacities[key], key
    assert ref.passage_node_keys == port.passage_node_keys
    assert ref.fact_node_keys == port.fact_node_keys
    assert _ppr_iters("ref", ref) == _ppr_iters("port", port)


def _step(rags, queries, what, **kw):
    """Retrieve on both packages; same rankings, device state and iterations.
    Returns the port's solutions."""
    sols = _both(rags, lambda rag: rag.retrieve(list(queries), **kw))
    _assert_same_solutions(sols["port"], sols["ref"], what)
    assert rags["port"].get_graph_info() == rags["ref"].get_graph_info(), what
    if rags["port"]._backend is not None and rags["port"].graph.num_edges > 0:
        _assert_same_device_state(rags)
    return sols["port"]


def test_incremental_and_delete(tmp_path, toy_data):
    """tests/test_e2e.py::test_hipporag_incremental_and_delete on both packages."""
    docs, queries, _, _ = toy_data
    rags = _pair(tmp_path / "inc")
    _both(rags, lambda rag: rag.index(docs[:5]))
    assert len(rags["port"].chunk_embedding_store.get_all_ids()) == 5
    _both(rags, lambda rag: rag.index(docs))
    assert len(rags["port"].chunk_embedding_store.get_all_ids()) == 9
    assert len(_step(rags, [queries[2]], "after incremental index")[0].docs) == 9

    _both(rags, lambda rag: rag.delete(docs[:2]))
    assert len(rags["port"].chunk_embedding_store.get_all_ids()) == 7
    results = _step(rags, [queries[1]], "after delete")
    assert len(results[0].docs) == 7 and docs[0] not in results[0].docs

    reloaded = {tag: pkg.HippoRAG(global_config=_config(pkg, tmp_path / "inc" / tag), **extra)
                for tag, pkg, extra in PACKAGES}
    assert len(reloaded["port"].chunk_embedding_store.get_all_ids()) == 7
    _step(reloaded, queries, "after reload")


def test_full_delete_then_retrieve_and_reindex(tmp_path, toy_data):
    """Deleting every document leaves an empty-but-usable index; re-indexing
    on the same instance restores retrieval, as in the JAX package."""
    docs, queries, _, _ = toy_data
    rags = _pair(tmp_path / "wipe")
    _both(rags, lambda rag: rag.index(docs))
    _both(rags, lambda rag: rag.delete(list(docs)))
    info = rags["port"].get_graph_info()
    assert info["num_total_nodes"] == 0 and info["num_total_triples"] == 0
    assert _step(rags, [queries[0]], "after full delete")[0].docs == []
    _both(rags, lambda rag: rag.index(docs))
    assert _step(rags, queries, "after re-index")[0].docs


def test_delete_is_host_only(tmp_path, toy_data):
    """delete() on a fresh instance never prepares the device state; a clean
    instance on the same save_dir then retrieves as the JAX package does."""
    docs, queries, _, _ = toy_data
    _both(_pair(tmp_path / "hostdel"), lambda rag: rag.index(docs))
    fresh = _pair(tmp_path / "hostdel")

    def _boom():
        raise AssertionError("delete() must not prepare device retrieval objects")

    fresh["port"].prepare_retrieval_objects = _boom
    _both(fresh, lambda rag: rag.delete(docs[:2]))
    assert fresh["port"].ready_to_retrieve is False
    assert len(fresh["port"].chunk_embedding_store.get_all_ids()) == len(docs) - 2
    sols = _step(_pair(tmp_path / "hostdel"), queries, "clean instance after host-only delete")
    assert len(sols[0].docs) == len(docs) - 2


def test_delete_under_force_openie_preserves_results(tmp_path, toy_data):
    """Under force_openie_from_scratch, delete() still reads the persisted
    OpenIE results: the survivors' extractions stay on disk and the deleted
    document's facts leave the store."""
    docs, queries, _, _ = toy_data
    rags = _pair(tmp_path / "fdel")
    _both(rags, lambda rag: rag.index(docs[:4]))
    n_facts = len(rags["port"].fact_embedding_store.get_all_ids())
    assert n_facts > 0
    forced = _pair(tmp_path / "fdel", force_openie_from_scratch=True)
    _both(forced, lambda rag: rag.delete(docs[:1]))
    remaining = {}
    for tag, rag in forced.items():
        with open(rag.openie_results_path) as fh:
            remaining[tag] = json.load(fh)["docs"]
    assert len(remaining["port"]) == 3 and remaining["port"] == remaining["ref"]
    assert len(forced["port"].fact_embedding_store.get_all_ids()) < n_facts
    assert (forced["port"].fact_embedding_store.get_all_ids()
            == forced["ref"].fact_embedding_store.get_all_ids())
    _step(forced, queries, "after forced-OpenIE delete")


def test_repeated_index_delete_cycles(tmp_path, toy_data):
    """Several index/delete/retrieve cycles keep stores, graph and retrieval
    consistent, and equal to the JAX package's after each step."""
    docs, queries, _, _ = toy_data
    rags = _pair(tmp_path / "cycles")
    _both(rags, lambda rag: rag.index(docs[:4]))
    for cycle in range(3):
        extra = [f"Cycle {cycle} fact: Entity{cycle}A is linked to Entity{cycle}B."]
        _both(rags, lambda rag: rag.index(extra))
        assert _step(rags, [f"Entity{cycle}A link"], f"cycle {cycle} index", num_to_retrieve=3)[0].docs
        _both(rags, lambda rag: rag.delete(extra))
        assert extra[0] not in rags["port"].chunk_embedding_store.get_all_texts()
        assert _step(rags, [queries[0]], f"cycle {cycle} delete", num_to_retrieve=3)[0].docs
    assert rags["port"].get_graph_info()["num_passage_nodes"] == 4


@pytest.mark.parametrize("seed", [4, 11, 23])
def test_random_lifecycle_replay_matches_jax(tmp_path, seed):
    """tests/test_e2e.py::test_random_lifecycle_replay_and_reload_invariants
    with both packages on one random sequence of index and delete
    operations: equal rankings, device state and iteration counts after
    every operation; the port's retrieval covers exactly the survivors and
    a reload of its save_dir reproduces it."""
    pool = [
        f"Fact {i}: Entity{i % 5}A works with Entity{(i * 3) % 7}B in "
        f"City{i % 4}. Entity{i % 5}A also founded Org{i}."
        for i in range(12)
    ]
    queries = ["Who works with Entity2B?", "Where does Entity1A work?", "Who founded Org3?"]
    rnd = random.Random(seed)
    ops, alive, deleted = [], [], []
    for _ in range(6):
        if alive and rnd.random() < 0.4:
            victims = rnd.sample(alive, k=rnd.randint(1, min(2, len(alive))))
            for v in victims:
                alive.remove(v)
            deleted.extend(victims)
            ops.append(("del", victims))
        else:
            fresh = [d for d in pool if d not in alive and d not in deleted]
            if not fresh:
                continue
            add = rnd.sample(fresh, k=rnd.randint(1, min(3, len(fresh))))
            alive.extend(add)
            ops.append(("add", add))
    assert alive, f"degenerate op sequence: {ops}"

    rags = _pair(tmp_path / "replay")
    survivors = []
    for step, (kind, batch) in enumerate(ops):
        if kind == "add":
            _both(rags, lambda rag: rag.index(list(batch)))
            survivors.extend(batch)
        else:
            _both(rags, lambda rag: rag.delete(list(batch)))
            survivors = [d for d in survivors if d not in batch]
        got = _step(rags, queries, f"step {step} ({kind})", num_to_retrieve=max(1, len(survivors)))
        for g in got:
            assert set(g.docs) == set(survivors), f"doc set wrong after step {step}"

    reloaded = hipporag_tpu_torch.HippoRAG(
        global_config=_config(hipporag_tpu_torch, tmp_path / "replay" / "port"), device="cpu")
    _assert_same_solutions(reloaded.retrieve(queries, num_to_retrieve=len(alive)), got, "reload")


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_save_dir_written_by_one_package_reads_in_the_other(tmp_path, toy_data, writer, reader):
    """The stores, the OpenIE JSON, the graph state and the embedding cache
    keep the JAX package's formats: an index written by one package reloads
    in the other, retrieves the same, and re-indexing finds nothing new."""
    docs, queries, _, _ = toy_data
    pkgs = {tag: (pkg, extra) for tag, pkg, extra in PACKAGES}

    def open_rag(tag):
        pkg, extra = pkgs[tag]
        return pkg.HippoRAG(global_config=_config(pkg, tmp_path / "shared"), **extra)

    first = open_rag(writer)
    first.index(docs)
    want = first.retrieve(queries)
    second = open_rag(reader)
    assert len(second.chunk_embedding_store.get_all_ids()) == len(docs)
    assert second.graph.node_names == first.graph.node_names
    assert second.graph.edge_weights == first.graph.edge_weights
    facts = second.fact_embedding_store.get_all_ids()
    second.index(docs)
    assert second.fact_embedding_store.get_all_ids() == facts
    _assert_same_solutions(second.retrieve(queries), want, f"{writer} -> {reader}")


def test_prompts_and_filter_messages_identical():
    """The port's prompt templates are found through its own package and
    render as the JAX package's; the recognition-memory filter sends the
    same messages, with the default and the packaged DSPy prompt."""
    from hipporag_tpu.llm.mock import MockLLM as RefMock
    from hipporag_tpu.prompts import PromptTemplateManager as RefManager
    from hipporag_tpu.rerank import RecognitionMemoryFilter as RefFilter
    from hipporag_tpu_torch.llm.mock import MockLLM
    from hipporag_tpu_torch.prompts import PromptTemplateManager
    from hipporag_tpu_torch.rerank import RecognitionMemoryFilter

    ref_mgr, mgr = RefManager(), PromptTemplateManager()
    assert mgr.list_template_names() == ref_mgr.list_template_names()
    assert len(mgr.list_template_names()) >= 10
    for name in mgr.list_template_names():
        got, want = mgr.templates[name], ref_mgr.templates[name]
        assert [(m["role"], m["content"].template) for m in got] == [
            (m["role"], m["content"].template) for m in want], name
    args = dict(passage="Mira Voss was born in Calder County.", named_entity_json='{"named_entities": []}',
                prompt_user="Question: Who is Mira Voss?\nThought: ")
    for name in ("ner", "triple_extraction", "rag_qa", "rag_qa_musique"):
        assert mgr.render(name, **args) == ref_mgr.render(name, **args), name

    facts = [("mira voss", "born in", "calder county"), ("calder county", "located in", "port ellery")]
    for path in (None, "filter_llama3.3-70B-Instruct.json"):
        logs = []
        for filt_cls, llm_cls in ((RefFilter, RefMock), (RecognitionMemoryFilter, MockLLM)):
            llm = llm_cls()
            out = filt_cls(llm, path).rerank("Where was Mira Voss born?", facts, [0, 1], 2)
            logs.append((llm.call_log, out[0], out[1]))
        assert logs[0] == logs[1], path


def _lifecycle_fixture(pkg, root, **kw):
    """The phase-6 lifecycle record of ``pkg`` for each compute dtype."""
    data = hipporag_tpu_torch.load_dataset("sample", DATA_DIR)
    out = {}
    for dtype in LIFECYCLE_DTYPES:
        cfg = pkg.BaseConfig(save_dir=os.path.join(str(root), dtype), compute_dtype=dtype,
                             **chip_smoke.LIFECYCLE_CONFIG)
        out[dtype] = chip_smoke.lifecycle_record(pkg.HippoRAG(cfg, **kw), data)
    return {"config": chip_smoke.LIFECYCLE_CONFIG, "deleted": chip_smoke.LIFECYCLE_DELETED, "records": out}


def test_lifecycle_fixture_matches_jax_package(tmp_path):
    with open(chip_smoke.LIFECYCLE_FIXTURE) as fh:
        recorded = json.load(fh)
    fresh = _lifecycle_fixture(hipporag_tpu, tmp_path)
    assert recorded["config"] == fresh["config"] and recorded["deleted"] == fresh["deleted"]
    for dtype in LIFECYCLE_DTYPES:
        chip_smoke.compare_lifecycle(fresh["records"][dtype], recorded["records"][dtype], score_atol=1e-6)


@pytest.mark.parametrize("dtype", LIFECYCLE_DTYPES)
def test_port_lifecycle_matches_fixture(tmp_path, monkeypatch, dtype):
    """What phase 6 checks on the card, here on the CPU, with the fact top-k
    routed through the fused path (its plain pass A) as every CUDA call is."""
    from hipporag_tpu_torch.ops import scoring

    monkeypatch.setattr(scoring, "fused_topk_route", lambda device: True)
    with open(chip_smoke.LIFECYCLE_FIXTURE) as fh:
        recorded = json.load(fh)["records"][dtype]
    cfg = hipporag_tpu_torch.BaseConfig(save_dir=str(tmp_path), compute_dtype=dtype, **chip_smoke.LIFECYCLE_CONFIG)
    got = chip_smoke.lifecycle_record(hipporag_tpu_torch.HippoRAG(cfg, device="cpu"),
                                      hipporag_tpu_torch.load_dataset("sample", DATA_DIR))
    chip_smoke.compare_lifecycle(got, recorded, score_atol=chip_smoke.LIFECYCLE_SCORE_ATOL[dtype])


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        payload = _lifecycle_fixture(hipporag_tpu, tmp)
    with open(chip_smoke.LIFECYCLE_FIXTURE, "w") as fh:
        json.dump(payload, fh, indent=1)
        fh.write("\n")
    print(f"wrote {chip_smoke.LIFECYCLE_FIXTURE}")
