"""The port's on-device GritLM-8x7B (``embedding/gritlm_encoder.py`` and the
mixture-of-experts ops of ``ops/moe.py``) against the benchmark's plain
float32 reference (``perfbench/reference/encoders/gritlm.py``), at the
benchmark's tiny sizes on the CPU (``perfbench/encoders/gritlm.TINY``: two
layers of 128, GQA at 4 query heads per key/value head, 8 experts of 96,
top 2).

Tolerance: both sides compute float32 products of the same float32
weights, in different orders (the port fuses the query, key and value
weights into one product, groups the query heads that share a key/value
head, and computes the gates as the softmax over the chosen experts), so
their unit rows differ by float32 rounding only, as long as no token's
choice of experts lies within that rounding of a tie: measured 2.0e-7 to
2.7e-7 in L2 over 6 seeds in the benchmark's tiny cell. ``F32_TOL`` (2e-6)
leaves room for other BLAS builds and lies far below what a fault gives
(bf16 operands: about 1e-2; the reference's TF32 control: 6.8e-4 to
1.5e-2).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hipporag_tpu_torch.config import BaseConfig
from hipporag_tpu_torch.embedding import get_embedding_model
from hipporag_tpu_torch.embedding import gritlm_encoder as grit
from hipporag_tpu_torch.embedding.gritlm_embed import GritLMEmbeddingModel, gritlm_instruction
from hipporag_tpu_torch.ops import moe
from hipporag_tpu_torch.prompts.linking import get_query_instruction
from hipporag_tpu_torch.utils.timing import recording, span
from perfbench.encoders.gritlm import TINY
from perfbench.reference.encoders import gritlm as plain

torch.set_num_threads(1)

F32_TOL = 2e-6
SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)
INSTRUCTIONS = (get_query_instruction("query_to_fact"), get_query_instruction("query_to_passage"), "")
QUESTIONS = ["Tell me about Kalo Vemi.", "What connects Kalo Vemi and Ren Sta Jr?", "Tell me about Mor Ni.",
             "What connects Dun Gar III and Wen Yor?"]
SIZES = {k: TINY[k] for k in grit.PUBLISHED}


def _model(seed: int, dtype: str = "float32", batch: int = 16, sizes=SIZES, config=TINY):
    cfg = BaseConfig(embedding_model_name=grit.route_name(sizes), embedding_model_dtype=dtype,
                     embedding_batch_size=batch, embedding_max_seq_len=config["max_position_embeddings"])
    return grit.GritLMDeviceEmbeddingModel(cfg, "cpu", params=plain.weights(config, seed, "cpu"))


def _reference(seed: int, instruction: str, questions=QUESTIONS, config=TINY) -> np.ndarray:
    texts = [plain.format_query(config, instruction, q) for q in questions]
    return plain.encode(config, plain.weights(config, seed, "cpu"), texts, "cpu").numpy()


def _err(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64), axis=1).max())


@pytest.mark.parametrize("instruction", INSTRUCTIONS, ids=("fact", "passage", "none"))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_matches_the_plain_reference(seed, instruction):
    got = _model(seed).batch_encode(QUESTIONS, instruction=instruction, norm=True)
    assert got.shape == (len(QUESTIONS), TINY["hidden_size"]) and got.dtype == np.float32
    assert _err(got, _reference(seed, instruction)) <= F32_TOL


def test_bf16_operands_are_caught_by_the_tolerance():
    seed, instruction = SEEDS[0], INSTRUCTIONS[0]
    got = _model(seed, "bfloat16").batch_encode(QUESTIONS, instruction=instruction, norm=True)
    err = _err(got, _reference(seed, instruction))
    assert F32_TOL * 100 < err < 0.5, err


def test_top_k_of_every_expert_is_the_softmax_weighted_sum_of_all():
    """With ``num_experts_per_tok`` equal to ``num_local_experts`` the block
    is the dense mixture: every expert weighted by the full softmax."""
    sizes = dict(SIZES, num_experts_per_tok=SIZES["num_local_experts"])
    enc = _model(SEEDS[0], sizes=sizes, config=dict(TINY, **sizes)).encoder
    layer = enc.layers[0]
    y = torch.randn(2 * 7, TINY["hidden_size"], generator=torch.Generator().manual_seed(3))
    lengths = torch.tensor([7, 7])
    got = grit._moe(y, lengths, layer, enc)
    probs = torch.softmax(y @ layer.router_w, dim=-1)
    want = sum(probs[:, e, None] * ((F.silu(y @ layer.gate_w[e]) * (y @ layer.up_w[e])) @ layer.down_w[e])
               for e in range(SIZES["num_local_experts"]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert int(enc.moe_stats[0]) == 14 * 8 and int(enc.moe_stats[1]) == 14


@pytest.mark.parametrize("top_k, want", [(1, [1]), (2, [1, 2]), (3, [1, 2, 4]), (4, [1, 2, 4, 0])])
def test_ties_go_to_the_lower_expert_index(top_k, want):
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, -1.0, 0.5, 1.0]])
    r = moe.moe_route_plain(logits, torch.tensor([1]), top_k)
    assert r.experts[0].tolist() == want
    expect = torch.softmax(logits[0, want], dim=0)  # the full softmax renormalised over the chosen
    torch.testing.assert_close(r.gates[0], expect, rtol=0, atol=1e-7)


def test_the_routing_groups_each_experts_pairs_by_token():
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(4 * 6, 8, generator=gen)
    lengths = torch.tensor([6, 3, 0, 5])
    stats = torch.zeros(2, dtype=torch.int64)
    r = moe.moe_route_plain(logits, lengths, 2, stats)
    real = (torch.arange(6)[None, :] < lengths[:, None]).reshape(-1)
    routed = int(real.sum()) * 2
    counts = torch.bincount(r.experts[real].reshape(-1).long(), minlength=8)
    assert r.offsets.tolist() == [0] + counts.cumsum(0).tolist() and int(r.offsets[-1]) == routed
    assert stats.tolist() == [routed, int(counts.max())]
    assert (r.experts[~real] == -1).all() and (r.slots[~real] == -1).all() and (r.gates[~real] == 0).all()
    for e in range(8):
        rows = r.tokens[r.offsets[e]:r.offsets[e + 1]].tolist()
        assert rows == sorted(rows) and all(e in r.experts[t].tolist() for t in rows)
    for t in torch.nonzero(real).flatten().tolist():
        for j in range(2):
            assert int(r.tokens[r.slots[t, j]]) == t
    torch.testing.assert_close(r.gates[real].sum(1), torch.ones(int(real.sum())))


def test_a_row_is_the_same_alone_and_padded_in_a_batch():
    """Padded positions are left out of the experts; the reference, which
    routes them, gives the same rows."""
    model = _model(SEEDS[1])
    short, long = QUESTIONS[0], QUESTIONS[3] + " and the rest of a much longer question"
    alone = model.batch_encode([short], instruction=INSTRUCTIONS[0], norm=True)
    padded = model.batch_encode([long, short], instruction=INSTRUCTIONS[0], norm=True)
    np.testing.assert_allclose(padded[1], alone[0], rtol=0, atol=1e-6)
    assert _err(padded, _reference(SEEDS[1], INSTRUCTIONS[0], [long, short])) <= F32_TOL


def test_the_route_by_name():
    name = grit.route_name(SIZES, seed=7)
    assert grit.parse_name(name) == (SIZES, 7)
    assert grit.parse_name("GritLM/random") == (grit.PUBLISHED, 0)
    with pytest.raises(ValueError):
        grit.parse_name("GritLM/random-experts=4")
    model = get_embedding_model(BaseConfig(embedding_model_name=name, embedding_model_dtype="float32"), device="cpu")
    assert isinstance(model, grit.GritLMDeviceEmbeddingModel) and model.embedding_dim == TINY["hidden_size"]
    layer = model.encoder.layers[0]
    assert tuple(layer.gate_w.shape) == (8, TINY["hidden_size"], TINY["intermediate_size"])
    assert tuple(layer.router_w.shape) == (TINY["hidden_size"], 8) and model.encoder.top_k == 2
    assert len(model.encoder.layers) == TINY["num_hidden_layers"] and not model.tokenizer.eos
    assert model.format_with_instruction("q", "find") == gritlm_instruction("find") + "q"
    other = get_embedding_model(BaseConfig(embedding_model_name=grit.route_name(SIZES, seed=8),
                                           embedding_model_dtype="float32"), device="cpu")
    rows = [m.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[0]) for m in (model, other)]
    assert _err(rows[0], rows[1]) > 0.1
    # a checkpoint name still goes to the host wrapper, which loads nothing until it encodes
    for checkpoint in ("GritLM/GritLM-8x7B", "GritLM/GritLM-7B"):
        assert isinstance(get_embedding_model(BaseConfig(embedding_model_name=checkpoint)), GritLMEmbeddingModel)


def test_the_published_sizes():
    """GritLM-8x7B's layer: 41.9 M parameters of attention, 1,409.3 M of
    experts, 0.03 M of router; 46.7 B parameters with the LM head this
    route leaves out; the 16 layers of one pipeline stage and the
    embedding are 46.7 GB in bfloat16."""
    shapes = grit.param_shapes(grit.PUBLISHED)
    layer = {k: int(np.prod(s)) for k, s in shapes["layers"][0].items()}
    attention = sum(layer[k] for k in ("q_w", "k_w", "v_w", "o_w"))
    experts = sum(layer[k] for k in ("gate_w", "up_w", "down_w"))
    assert round(attention / 1e6, 1) == 41.9 and round(experts / 1e6, 1) == 1409.3
    assert round(layer["router_w"] / 1e6, 2) == 0.03 and round(sum(layer.values()) / 1e6, 1) == 1451.3
    embed = int(np.prod(shapes["embed"]))
    total = 32 * sum(layer.values()) + embed + shapes["norm"][0]
    assert len(shapes["layers"]) == 32 and round((total + embed) / 1e9, 1) == 46.7
    assert round(2 * (16 * sum(layer.values()) + embed) / 1e9, 1) == 46.7


def test_the_counters_on_the_open_span():
    model = _model(SEEDS[0], batch=3)
    instruction = INSTRUCTIONS[1]
    masked = 1 + len(gritlm_instruction(instruction).split())
    lengths = [masked + len(q.split()) for q in QUESTIONS]
    with recording() as rec:
        with span("retrieve/embed"):
            model.batch_encode(QUESTIONS, instruction=instruction, norm=True)
    (embed,) = [s for s in rec.spans() if s.name == "retrieve/embed"]
    routed = 2 * TINY["num_hidden_layers"] * sum(lengths)
    rows_max = embed.attrs.pop("expert_rows_max")
    assert embed.attrs == {
        "texts": 4, "forwards": 2, "tokens": sum(lengths), "pooled": sum(n - masked for n in lengths),
        "padded_tokens": 3 * max(lengths[:3]) + lengths[3], "fused_kernels": 0, "moe_kernels": 0,
        "routed": routed,
    }
    # each layer's largest expert holds at least an even share of each forward's pairs
    forwards = [sum(lengths[:3]), lengths[3]]
    assert sum(-(-2 * n // 8) for n in forwards) * TINY["num_hidden_layers"] <= rows_max <= routed
    # outside a span nothing is read, and the next span counts only its own forwards
    model.batch_encode(QUESTIONS[:1], instruction=instruction, norm=True)
    with recording() as rec:
        with span("retrieve/embed"):
            model.batch_encode(QUESTIONS[1:2], instruction=instruction, norm=True)
    (embed,) = [s for s in rec.spans() if s.name == "retrieve/embed"]
    assert embed.attrs["routed"] == 2 * TINY["num_hidden_layers"] * lengths[1]
    assert embed.attrs["expert_rows_max"] <= embed.attrs["routed"] // TINY["num_hidden_layers"] * 2


def _second_expert_dropped(monkeypatch):
    route = moe.moe_route_plain

    def dropped(logits, lengths, top_k, stats=None):
        r = route(logits, lengths, top_k, stats)
        return r._replace(gates=torch.cat([r.gates[:, :1], torch.zeros_like(r.gates[:, 1:])], 1))
    monkeypatch.setattr(moe, "moe_route_plain", dropped)


def _gates_not_renormalised(monkeypatch):
    route = moe.moe_route_plain

    def softmax_gates(logits, lengths, top_k, stats=None):
        r = route(logits, lengths, top_k, stats)
        probs = torch.softmax(logits, dim=-1).gather(1, r.experts.clamp_min(0).long())
        return r._replace(gates=torch.where(r.experts >= 0, probs, 0.0))
    monkeypatch.setattr(moe, "moe_route_plain", softmax_gates)


def _instruction_pooled(monkeypatch):
    monkeypatch.setattr(grit.GritLMDeviceEmbeddingModel, "_masked_positions", lambda self, instruction: 0)


def _eos_appended(monkeypatch):
    monkeypatch.setattr(grit.GritLMDeviceEmbeddingModel, "EOS", True)


@pytest.mark.parametrize("fault", [_second_expert_dropped, _gates_not_renormalised, _instruction_pooled,
                                   _eos_appended], ids=lambda f: f.__name__.strip("_"))
def test_a_fault_in_the_forward_fails_the_comparison(monkeypatch, fault):
    seed, instruction = SEEDS[0], INSTRUCTIONS[0]
    fault(monkeypatch)
    got = _model(seed).batch_encode(QUESTIONS, instruction=instruction, norm=True)
    assert _err(got, _reference(seed, instruction)) > 100 * F32_TOL
