"""A configuration that puts a question encoder on the query path
(``query_encoder``): the ``bert`` pair on the parked tiny configuration,
run whole on the CPU, its faults caught by ``embed_err``; and the parts
that a configuration without the key must see unchanged."""

from __future__ import annotations

import time

import pytest
import torch

from test_perfbench_runs import _swap_first_two
from tiny import ENCODER_CELL, encoder_spec, manifest, tiny_spec

from perfbench import check, run, work
from perfbench.encoders.bert import TINY_LIMITS

SEED = 2**31 + 4242


def _run(trace=False, seconds=0.5):
    return run.execute(manifest(), ENCODER_CELL, SEED, 2.0 if trace else seconds, trace, torch.device("cpu"),
                       time.perf_counter(), spec=encoder_spec())


def test_two_row_judge_equals_the_one_row_judge():
    """nvembed2-musique names no encoder: its hashing rows go to both row
    kinds as one tensor, and the judge reads the same numbers, float for
    float, as with fact and passage rows handed over apart."""
    from perfbench.deployment import Deployment
    from perfbench.sampling import answer

    _cell, config, params, _limits = tiny_spec("nvembed2-musique.batch")
    dep = Deployment(config, SEED, "cpu")
    try:
        qs = dep.take_questions(48)
        sols = dep.rag.retrieve(qs)
    finally:
        dep.close()
    k = config["hipporag"]["retrieval_top_k"]
    answers = [answer(s.question, s.docs, s.doc_scores, k, s.graph_seeds) for s in sols]
    ref, query_rows = run.reference_for(config, dep.corpus, torch.device("cpu"))
    fact, passage = query_rows(qs)
    assert fact is passage
    one = check.judge(ref, fact, fact, answers, graph=True)
    two = check.judge(ref, fact.clone(), passage.clone(), answers, graph=True)
    assert set(one) == {"malformed", "fact_gap", "rank_gap", "score_err"}
    assert {n: repr(v) for n, v in one.items()} == {n: repr(v) for n, v in two.items()}


def test_an_encoder_run_is_correct_and_reports_embed_err():
    result, rows = _run()
    numbers = {name: value for name, value, _limit in rows}
    assert result["correct"], rows
    assert 0 <= numbers["embed_err"] <= TINY_LIMITS["embed_err"] / 5
    assert numbers["malformed"] == 0 and numbers["fact_gap"] <= 1e-6 and numbers["rank_gap"] <= 1e-6
    assert result["checks"]["embed_err"]["limit"] == TINY_LIMITS["embed_err"]
    assert list(result["checks"])[-1] == "embed_err"


def test_an_encoder_config_without_an_embed_err_limit_is_not_judged_on_it():
    cell, config, params, limits = encoder_spec()
    limits.pop("embed_err")
    result, rows = run.execute(manifest(), ENCODER_CELL, SEED, 0.5, False, torch.device("cpu"), time.perf_counter(),
                               spec=(cell, config, params, limits))
    assert result["correct"] and "embed_err" not in result["checks"]


def _weight_perturbed(fn):
    def broken(*args, **kwargs):
        model = fn(*args, **kwargs)
        model.encoder.layers[0].ffn_in_w[0, 0] += 0.05
        return model
    return broken


def _residual_in_bf16(fn):
    def broken(x, scale, bias, eps=1e-12):
        return fn(x.to(torch.bfloat16).float(), scale, bias, eps)
    return broken


ENCODER_FAULTS = [
    ("perfbench.encoders.bert", "program", _weight_perturbed),
    ("hipporag_tpu_torch.embedding.encoder", "_layernorm", _residual_in_bf16),
]


@pytest.mark.parametrize("module,name,fault", ENCODER_FAULTS, ids=[f.__name__ for _m, _n, f in ENCODER_FAULTS])
def test_a_broken_encoder_is_caught_by_embed_err(monkeypatch, module, name, fault):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    result, rows = _run()
    assert not result["correct"], rows
    assert result["checks"]["embed_err"]["value"] > TINY_LIMITS["embed_err"], rows


def test_a_symmetric_encoder_gives_one_row_for_both_instructions():
    """The port's BERT encoder reads the bare question under either
    instruction, so its fact and passage rows are equal: a passage row
    handed to the fact scores changes nothing there and cannot be seen."""
    from perfbench.deployment import Deployment

    _cell, config, _params, _limits = encoder_spec()
    dep = Deployment(config, SEED, "cpu")
    try:
        qs = dep.take_questions(8)
        dep.rag.retrieve(qs)
        rows = dep.query_rows(qs)
    finally:
        dep.close()
    for q in qs:
        assert (rows["triple"][q] == rows["passage"][q]).all()


def test_the_port_route_refuses_widths_it_cannot_build():
    from perfbench.encoders import bert

    config = encoder_spec()[1]
    assert bert.embedding_name(config) == "jax/random-256x2"
    for key, value in (("num_attention_heads", 8), ("intermediate_size", 512), ("vocab_size", 4096)):
        with pytest.raises(ValueError):
            bert.embedding_name(dict(config, **{key: value}))


def test_a_ranking_fault_is_caught_on_an_encoder_config(monkeypatch):
    import hipporag_tpu_torch.hipporag as hipporag

    monkeypatch.setattr(hipporag, "rank_documents_topk", _swap_first_two(hipporag.rank_documents_topk))
    result, rows = _run()
    assert not result["correct"], rows
    assert result["checks"]["embed_err"]["value"] <= TINY_LIMITS["embed_err"]
    assert result["checks"]["rank_gap"]["value"] > result["checks"]["rank_gap"]["limit"]


def test_the_control_reports_embed_err_above_its_limit():
    from perfbench import control

    _cell, config, params, limits = encoder_spec()
    numbers = control.control_numbers(config, params, SEED, 40, torch.device("cpu"))
    assert set(limits) <= set(numbers)
    assert numbers["embed_err"] > limits["embed_err"]


def test_a_traced_encoder_run_counts_the_encoder(monkeypatch):
    """Every call of a traced run has an ``encode`` stage, and the whole
    step's share counts it."""
    from perfbench import metrics

    seen = []

    def call_stages(*args):
        seen.append(work_call_stages(*args))
        return seen[-1]

    work_call_stages = work.call_stages
    monkeypatch.setattr(work, "call_stages", call_stages)
    result, _rows = _run(trace=True)
    assert result["correct"]
    stages = seen[0]
    assert stages and all(st["encode"] > 0 for st in stages)
    least = dict(result["breakdown"]["least_s"])
    assert 0 < least["encode"] <= sum(st["encode"] for st in stages)
    assert isinstance(result["breakdown"]["range_device_s"], list)
    ctx = run.Context(stages=stages, window_s=1.0)
    without = run.Context(stages=[{k: v for k, v in st.items() if k != "encode"} for st in stages], window_s=1.0)
    assert "encode" in work.STEP_STAGES
    assert metrics.step_mfu(ctx) == pytest.approx(metrics.step_mfu(without) + 100 * sum(st["encode"] for st in stages))


class _StubRef:
    """A reference with no facts and no passages."""

    class graph:
        facts, passages, num_nodes, num_entries = [], [], 0, 0


def test_the_encode_stage_by_hand():
    """Two sequences of 3 and 5 tokens through one layer of width 4 with an
    MLP of 8, in float32: 2 * 8 * (4*16 + 2*32) + 4 * 34 * 4 FLOPs."""
    from perfbench.encoders import bert
    from perfbench.reference.encoders import token_counts

    config = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 1, "torch_dtype": "float32"}
    flops, nbytes, precision = bert.work(config, [3, 5])
    assert flops == 2 * 8 * (4 * 16 + 2 * 32) + 4 * (9 + 25) * 4
    assert nbytes == 4 * (4 * 16 + 2 * 32 + 8 * 4) + 4 * 8 + 4 * 4 * 2 and precision == "tf32"
    assert bert.work(dict(config, torch_dtype="bfloat16"), [3, 5])[2] == "bf16"
    counts = token_counts(encoder_spec()[1], ["Tell me about Kalo Vemi."])
    # [CLS] tell me about kalo vemi. [SEP], once: the same text under both instructions
    assert counts == [1 + 5 + 1]


def test_no_encoder_stage_without_the_key():
    _cell, config, _params, _limits = tiny_spec("nvembed2-musique.batch")
    assert "query_encoder" not in config
    calls = [{"questions": ["Tell me about Kalo Vemi."], "entry": "retrieve_dpr", "traced": False}]
    assert set(work.call_stages(_StubRef(), calls, config, None)[0]) == {"dense_scores", "passage_topk"}
    assert "encode" in work.call_stages(_StubRef(), calls, encoder_spec()[1], None)[0]


def test_the_reference_encoder_is_the_ports_encoder_in_float32():
    """The plain reference and the port's encoder on the same weights and
    tokens agree to float32 rounding; the TF32 and fp8 controls do not."""
    from perfbench.encoders import bert
    from perfbench.reference import encoders

    _cell, config, _params, _limits = encoder_spec()
    qs = ["Tell me about Kalo Vemi.", "What connects Kalo Vemi and Ren Sta?"]
    from hipporag_tpu_torch.config import BaseConfig

    model = bert.program(config, BaseConfig(embedding_dim=config["hidden_size"]), "cpu", SEED)
    got = [torch.from_numpy(model.batch_encode(qs, instruction=text, norm=True)) for _k, text in encoders.INSTRUCTIONS]
    want = encoders.rows(config, SEED, qs, "cpu")
    assert check.embed_err(got, want) < 1e-6
    assert check.embed_err(want, encoders.rows(config, SEED, qs, "cpu", precision="tf32")) > 1e-6
    assert check.embed_err(want, encoders.rows(config, SEED, qs, "cpu", precision="fp8")) > 1e-3
    assert check.embed_err(got, encoders.rows(config, SEED + 1, qs, "cpu")) > 1e-2  # another seed's weights


def test_range_device_s_from_a_synthetic_trace():
    """Kernels launched inside nested retrieve/* ranges count in each
    enclosing range; graph_search's readings stay as before."""
    from perfbench.trace import reduce_events

    def rng(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}

    def launch(corr, ts, tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid,
                "args": {"correlation": corr}}

    def kernel(corr, ts, dur, name="k"):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
                "args": {"correlation": corr}}

    events = [
        rng("retrieve", 0, 1000), rng("retrieve/embed", 10, 100), rng("retrieve/graph_search", 200, 300),
        rng("retrieve/ppr", 250, 100), rng("retrieve/graph_search", 600, 100),
        launch(1, 20), kernel(1, 30, 40),      # embed
        launch(2, 260), kernel(2, 270, 10),    # graph_search and ppr
        launch(3, 400), kernel(3, 410, 20),    # graph_search only
        launch(4, 650), kernel(4, 660, 5),     # the second graph_search range
        launch(5, 900), kernel(5, 905, 8),     # in retrieve only: no retrieve/* range
        launch(6, 30, tid=2), kernel(6, 40, 3),  # another host thread
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 50, "dur": 4, "tid": 7, "args": {"correlation": 9}},
        launch(9, 60),
    ]
    t = reduce_events(events, 1e-3)
    assert t["range_device_s"] == pytest.approx({"retrieve/embed": 40e-6, "retrieve/graph_search": 35e-6,
                                                 "retrieve/ppr": 10e-6})
    assert t["graph_search_ranges_s"] == pytest.approx([300e-6, 100e-6])
    assert [(n, inside) for n, _d, inside in t["kernels"]] == [("k", False), ("k", True), ("k", True), ("k", True),
                                                              ("k", False), ("k", False)]
    # the copy and the other thread's kernel lie inside the first kernel
    assert t["busy_s"] == pytest.approx((40 + 10 + 20 + 5 + 8) * 1e-6)


def test_the_tiny_encoder_spec_is_the_modules_cut():
    """The parked encoder configuration runs at ``encoders/bert.py``'s tiny
    sizes: 256 wide in 2 layers of 4 heads, float32, ``embed_err`` 1e-5."""
    _cell, config, _params, limits = encoder_spec()
    assert {k: config[k] for k in ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                                   "torch_dtype")} == {"hidden_size": 256, "num_hidden_layers": 2,
                                                       "num_attention_heads": 4, "intermediate_size": 1024,
                                                       "torch_dtype": "float32"}
    assert config["index_vectors"]["dim"] == config["hipporag"]["embedding_dim"] == 256
    assert limits["embed_err"] == TINY_LIMITS["embed_err"] == 1e-5


def test_tiny_spec_cuts_only_the_corpus_and_traffic_without_an_encoder():
    from tiny import PARKED

    for cell in [w["name"] for w in manifest()["workloads"]] + [w["name"] for w in PARKED]:
        full = run.cell_spec(manifest(parked=True), cell)
        cut = tiny_spec(cell)
        if full[1].get("query_encoder"):
            continue
        assert dict(cut[1], corpus=None) == dict(full[1], corpus=None)
        assert dict(cut[1]["corpus"], passages=None) == dict(full[1]["corpus"], passages=None)
        assert cut[3] == full[3]


def test_tiny_spec_cuts_an_encoder_cell_to_its_modules_sizes():
    """A cell whose configuration names an encoder at any widths runs on the
    CPU at its module's ``TINY`` sizes and ``TINY_LIMITS``."""
    from perfbench.encoders import bert
    from tiny import cut_encoder

    _cell, config, _params, limits = tiny_spec("nvembed2-musique.batch")
    wide = dict(config, query_encoder="bert", **bert.PUBLISHED)
    cut, cut_limits = cut_encoder(wide, dict(limits, embed_err=0.02))
    assert {k: cut[k] for k in bert.TINY} == bert.TINY
    assert cut["index_vectors"]["dim"] == cut["hipporag"]["embedding_dim"] == bert.TINY["hidden_size"]
    assert cut_limits == dict(limits, **bert.TINY_LIMITS)
    assert wide["hidden_size"] == 768 and config["index_vectors"]["dim"] == 4096  # the inputs are left as they were


def test_every_encoder_module_states_its_cpu_cut():
    from perfbench.encoder_probe import encoder_names
    from perfbench.encoders import load

    names = encoder_names()
    assert "bert" in names
    for name in names:
        module = load(name)
        assert "torch_dtype" in module.TINY and int(module.TINY["num_hidden_layers"]) >= 2, name
        assert "embed_err" in module.TINY_LIMITS, name
        if hasattr(module, "PUBLISHED"):
            assert set(module.PUBLISHED) == set(module.TINY) and "embed_err" in module.PROBE_LIMITS, name


def test_the_probe_builds_its_spec_from_the_module():
    """``encoder_probe.py --encoder bert``: the batch cell with BERT-base's
    published sizes in bf16, index vectors at 768, ``embed_err`` 0.02."""
    from perfbench import encoder_probe
    from perfbench.encoders import bert

    name, (cell, config, params, limits) = encoder_probe.spec_for(manifest(), "bert")
    full = run.cell_spec(manifest(), encoder_probe.CELL)
    assert name == cell["name"] == "nvembed2-musique-bert.batch" and cell["config"] == "nvembed2-musique-bert"
    assert {k: config[k] for k in bert.PUBLISHED} == bert.PUBLISHED
    assert {k: config[k] for k in ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                                   "hidden_act", "torch_dtype")} == {"hidden_size": 768, "num_hidden_layers": 12,
                                                                     "num_attention_heads": 12,
                                                                     "intermediate_size": 3072,
                                                                     "hidden_act": "gelu_new",
                                                                     "torch_dtype": "bfloat16"}
    assert config["query_encoder"] == "bert"
    assert config["index_vectors"]["dim"] == config["hipporag"]["embedding_dim"] == 768
    assert params == full[2] and limits == dict(full[3], embed_err=0.02)
