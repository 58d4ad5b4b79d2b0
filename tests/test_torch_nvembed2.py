"""The port's on-device NV-Embed-v2 (``embedding/nvembed_encoder.py``)
against the benchmark's plain float32 reference
(``perfbench/reference/encoders/nvembed2.py``), at the benchmark's tiny
sizes on the CPU (``perfbench/encoders/nvembed2.TINY``: two layers of 128,
GQA at 4 query heads per key/value head, 16 latents under 4 cross heads).

Tolerance: both sides compute float32 products of the same float32
weights, in different orders (the port fuses the query, key and value
weights and the gate and up weights into one product each, groups the
query heads that share a key/value head, and projects the latents once per
set of weights), so their unit rows differ by float32 rounding only:
measured 1.9e-7 to 2.9e-7 in L2. ``F32_TOL`` (2e-6) leaves room for other
BLAS builds and lies far below what a fault gives (bf16 operands: about
1e-2; the reference's TF32 control: 5e-4 to 1.0e-3).
"""

import numpy as np
import pytest
import torch

from hipporag_tpu_torch.config import BaseConfig
from hipporag_tpu_torch.embedding import get_embedding_model
from hipporag_tpu_torch.embedding import nvembed_encoder as nv
from hipporag_tpu_torch.embedding.nvembed import NVEmbedV2EmbeddingModel
from hipporag_tpu_torch.prompts.linking import get_query_instruction
from hipporag_tpu_torch.utils.timing import recording, span
from perfbench.encoders.nvembed2 import TINY
from perfbench.reference.encoders import nvembed2 as plain

torch.set_num_threads(1)

F32_TOL = 2e-6
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
INSTRUCTIONS = (get_query_instruction("query_to_fact"), get_query_instruction("query_to_passage"))
QUESTIONS = ["Tell me about Kalo Vemi.", "What connects Kalo Vemi and Ren Sta Jr?", "Tell me about Mor Ni.",
             "What connects Dun Gar III and Wen Yor?"]
SIZES = {k: TINY[k] for k in nv.PUBLISHED}


def _model(seed: int, dtype: str = "float32", batch: int = 16):
    cfg = BaseConfig(embedding_model_name=nv.route_name(SIZES), embedding_model_dtype=dtype,
                     embedding_batch_size=batch, embedding_max_seq_len=TINY["max_position_embeddings"])
    return nv.NVEmbedV2DeviceEmbeddingModel(cfg, "cpu", params=plain.weights(TINY, seed, "cpu"))


def _reference(seed: int, instruction: str, questions=QUESTIONS) -> np.ndarray:
    texts = [plain.format_query(TINY, instruction, q) for q in questions]
    return plain.encode(TINY, plain.weights(TINY, seed, "cpu"), texts, "cpu").numpy()


def _err(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64), axis=1).max())


@pytest.mark.parametrize("instruction", INSTRUCTIONS, ids=("fact", "passage"))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_matches_the_plain_reference(seed, instruction):
    got = _model(seed).batch_encode(QUESTIONS, instruction=instruction, norm=True)
    assert got.shape == (len(QUESTIONS), TINY["hidden_size"]) and got.dtype == np.float32
    assert _err(got, _reference(seed, instruction)) <= F32_TOL


def test_bf16_operands_are_caught_by_the_tolerance():
    seed, instruction = SEEDS[0], INSTRUCTIONS[0]
    got = _model(seed, "bfloat16").batch_encode(QUESTIONS, instruction=instruction, norm=True)
    err = _err(got, _reference(seed, instruction))
    assert F32_TOL * 100 < err < 0.2, err


def test_a_row_is_the_same_alone_and_padded_in_a_batch():
    model = _model(SEEDS[1])
    short, long = QUESTIONS[0], QUESTIONS[3] + " and the rest of a much longer question"
    alone = model.batch_encode([short], instruction=INSTRUCTIONS[0], norm=True)
    padded = model.batch_encode([long, short], instruction=INSTRUCTIONS[0], norm=True)
    np.testing.assert_allclose(padded[1], alone[0], rtol=0, atol=1e-6)


def test_the_two_instructions_give_their_own_rows(tmp_path):
    """An asymmetric encoder: each question gives a different row under each
    instruction, and ``get_query_embeddings`` keeps each under its own."""
    from hipporag_tpu_torch.hipporag import HippoRAG

    cfg = BaseConfig(save_dir=str(tmp_path), llm_name="mock", embedding_model_name=nv.route_name(SIZES, seed=5),
                     embedding_model_dtype="float32")
    rag = HippoRAG(global_config=cfg, device="cpu")
    assert isinstance(rag.embedding_model, nv.NVEmbedV2DeviceEmbeddingModel)
    rag.get_query_embeddings(QUESTIONS)
    fact = rag.embedding_model.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[0], norm=True)
    passage = rag.embedding_model.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[1], norm=True)
    assert np.linalg.norm(fact - passage, axis=1).min() > 0.05
    for i, q in enumerate(QUESTIONS):
        np.testing.assert_array_equal(rag.query_to_embedding["triple"][q], fact[i])
        np.testing.assert_array_equal(rag.query_to_embedding["passage"][q], passage[i])


def test_the_route_by_name():
    name = nv.route_name(SIZES, seed=7)
    assert nv.parse_name(name) == (SIZES, 7)
    assert nv.parse_name("NV-Embed-v2/random") == (nv.PUBLISHED, 0)
    with pytest.raises(ValueError):
        nv.parse_name("NV-Embed-v2/random-hidden=64")
    model = get_embedding_model(BaseConfig(embedding_model_name=name, embedding_model_dtype="float32"), device="cpu")
    assert isinstance(model, nv.NVEmbedV2DeviceEmbeddingModel) and model.embedding_dim == TINY["hidden_size"]
    assert model.compute_dtype == "float32" and model.encoder.layers[0].qkv_w.dtype == torch.float32
    assert len(model.encoder.layers) == TINY["num_hidden_layers"]
    assert tuple(model.encoder.lat_k.shape) == (TINY["num_cross_heads"], TINY["num_latents"], TINY["cross_dim_head"])
    again = get_embedding_model(BaseConfig(embedding_model_name=name, embedding_model_dtype="float32"), device="cpu")
    other = get_embedding_model(BaseConfig(embedding_model_name=nv.route_name(SIZES, seed=8),
                                           embedding_model_dtype="float32"), device="cpu")
    rows = [m.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[0]) for m in (model, again, other)]
    np.testing.assert_array_equal(rows[0], rows[1])
    assert _err(rows[0], rows[2]) > 0.1
    # a checkpoint name still goes to the Hugging Face route, which loads nothing until it encodes
    assert isinstance(get_embedding_model(BaseConfig(embedding_model_name="nvidia/NV-Embed-v2")),
                      NVEmbedV2EmbeddingModel)


def test_the_published_sizes():
    """NV-Embed-v2's 7.85 B parameters: 7.11 B in the decoder, 0.74 B in the pooling."""
    shapes = nv.param_shapes(nv.PUBLISHED)
    layers = sum(int(np.prod(s)) for layer in shapes["layers"] for s in layer.values())
    top = {k: int(np.prod(s)) for k, s in shapes.items() if k != "layers"}
    decoder = layers + top["embed"] + top["norm"]
    pooling = sum(v for k, v in top.items() if k not in ("embed", "norm"))
    assert len(shapes["layers"]) == 32 and shapes["layers"][0]["k_w"] == (4096, 8 * 128)
    assert round(decoder / 1e9, 2) == 7.11 and round(pooling / 1e9, 2) == 0.74
    assert round((decoder + pooling) / 1e9, 2) == 7.85


def test_batch_encode_caches_each_instruction_under_its_own_key(tmp_path, monkeypatch):
    model = _model(SEEDS[2])
    model.attach_cache(str(tmp_path / "cache.sqlite"))
    calls = []
    encode = model._encode_batch
    monkeypatch.setattr(model, "_encode_batch", lambda texts: calls.append(list(texts)) or encode(texts))
    fact = model.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[0], norm=True)
    passage = model.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[1], norm=True)
    assert len(calls) == 2 and _err(fact, passage) > 0.05
    np.testing.assert_array_equal(model.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[0], norm=True), fact)
    np.testing.assert_array_equal(model.batch_encode(QUESTIONS, instruction=INSTRUCTIONS[1], norm=True), passage)
    assert len(calls) == 2  # both served from the cache, each under its instruction


def test_the_counters_on_the_open_span():
    model = _model(SEEDS[0], batch=3)
    instruction = INSTRUCTIONS[1]
    prefix = len(f"Instruct: {instruction}\nQuery: ".split())
    lengths = [1 + prefix + len(q.split()) + 1 for q in QUESTIONS]
    with recording() as rec:
        with span("retrieve/embed"):
            model.batch_encode(QUESTIONS, instruction=instruction, norm=True)
    (embed,) = [s for s in rec.spans() if s.name == "retrieve/embed"]
    assert embed.attrs == {
        "texts": 4, "forwards": 2, "tokens": sum(lengths), "pooled": sum(n - prefix for n in lengths),
        "padded_tokens": 3 * max(lengths[:3]) + lengths[3],
    }


def _no_rope(fn):
    return lambda x, cos, sin: x


def _interleaved_heads():
    """Query head h reads key/value head h % kv_heads, in place of h // repeats."""
    def group(q, kv_heads):
        b, h, l, hd = q.shape
        return q.reshape(b, h // kv_heads, kv_heads, l, hd).transpose(1, 2).reshape(b * kv_heads, -1, hd)

    def ungroup(ctx, b, heads):
        kv = ctx.shape[0] // b
        return ctx.reshape(b, kv, heads // kv, -1, ctx.shape[-1]).transpose(1, 2).reshape(b, heads, -1, ctx.shape[-1])
    return {"_group_queries": group, "_ungroup": ungroup}


def _no_pooling_residual(fn):
    return lambda x, enc: fn(x, enc) - x


FAULTS = {
    "instruction_pooled": lambda: {"NVEmbedV2DeviceEmbeddingModel._masked_positions": lambda self, instruction: 0},
    "rope_off": lambda: {"_rope": _no_rope(nv._rope)},
    "kv_heads_mismapped": _interleaved_heads,
    "pooling_residual_dropped": lambda: {"_latent_attention": _no_pooling_residual(nv._latent_attention)},
}


@pytest.mark.parametrize("fault", [*FAULTS, "final_norm_skipped"])
def test_a_fault_in_the_forward_fails_the_comparison(monkeypatch, fault):
    seed, instruction = SEEDS[0], INSTRUCTIONS[0]
    model = _model(seed)
    if fault == "final_norm_skipped":
        rms = nv._rms_norm
        final = model.encoder.norm
        monkeypatch.setattr(nv, "_rms_norm", lambda x, scale, eps: x if scale is final else rms(x, scale, eps))
    else:
        for name, broken in FAULTS[fault]().items():
            owner, _, attr = name.rpartition(".")
            monkeypatch.setattr(getattr(nv, owner) if owner else nv, attr, broken)
    got = model.batch_encode(QUESTIONS, instruction=instruction, norm=True)
    assert _err(got, _reference(seed, instruction)) > 100 * F32_TOL
