"""The ``gritlm`` pair in its cell, ``gritlm-8x7b-musique.batch``, cut to the
module's tiny sizes on the CPU: a run is correct and reports ``embed_err``;
faults in the program are caught by it; the control lies above its limit;
the encoder's work, the MoE layer's least time and the cell's readers by
hand; each MoE op's plain version against the reference's MoE block."""

from __future__ import annotations

import time

import pytest
import torch

from tiny import manifest, tiny_spec

from hipporag_tpu_torch.embedding.gritlm_encoder import PUBLISHED as ROUTE_SIZES

from perfbench import roofline, run
from perfbench.encoders import gritlm
from perfbench.encoders.gritlm import TINY, TINY_LIMITS
from perfbench.reference.encoders import gritlm as plain

CELL = "gritlm-8x7b-musique.batch"
SEED = 2**31 + 2121
NEW_METRICS = ("embed_ms.grit", "encoder_roofline.grit", "moe_roofline.grit", "moe_load_ratio.grit",
               "step_mfu.grit")


def _run(trace=False):
    return run.execute(manifest(), CELL, SEED, 2.0 if trace else 0.5, trace, torch.device("cpu"),
                       time.perf_counter(), spec=tiny_spec(CELL))


def test_the_cell_runs_correct_at_the_tiny_sizes():
    result, rows = _run()
    numbers = {name: value for name, value, _limit in rows}
    assert result["correct"], rows
    assert 0 <= numbers["embed_err"] <= TINY_LIMITS["embed_err"] / 5
    assert numbers["malformed"] == 0 and numbers["fact_gap"] <= 1e-6 and numbers["rank_gap"] <= 1e-6
    assert result["checks"]["embed_err"]["limit"] == TINY_LIMITS["embed_err"]


def _second_expert_dropped(monkeypatch):
    from hipporag_tpu_torch.ops import moe

    route = moe.moe_route_plain

    def dropped(logits, lengths, top_k, stats=None):
        r = route(logits, lengths, top_k, stats)
        return r._replace(gates=torch.cat([r.gates[:, :1], torch.zeros_like(r.gates[:, 1:])], 1))
    monkeypatch.setattr(moe, "moe_route_plain", dropped)


def _instruction_pooled(monkeypatch):
    from hipporag_tpu_torch.embedding import gritlm_encoder

    monkeypatch.setattr(gritlm_encoder.GritLMDeviceEmbeddingModel, "_masked_positions", lambda self, instruction: 0)


@pytest.mark.parametrize("fault", [_second_expert_dropped, _instruction_pooled], ids=lambda f: f.__name__.strip("_"))
def test_a_broken_program_is_caught_by_embed_err(monkeypatch, fault):
    fault(monkeypatch)
    result, rows = _run()
    assert not result["correct"], rows
    assert result["checks"]["embed_err"]["value"] > TINY_LIMITS["embed_err"], rows


def test_the_control_lies_above_the_tiny_limit():
    from perfbench import control

    _cell, config, params, limits = tiny_spec(CELL)
    numbers = control.control_numbers(config, params, SEED, 40, torch.device("cpu"))
    assert set(limits) <= set(numbers)
    assert numbers["embed_err"] > limits["embed_err"] == TINY_LIMITS["embed_err"]


def test_the_work_by_hand():
    """Two texts of 3 and 5 tokens through one layer of width 8 (2 query
    heads of 4 sharing 1 key/value head) with 4 experts of 16, top 2, in
    bf16: per token the attention's four products, the router and two
    experts' three products; every weight read once, all four experts."""
    config = {"hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2, "num_key_value_heads": 1,
              "head_dim": 4, "intermediate_size": 16, "num_local_experts": 4, "num_experts_per_tok": 2,
              "torch_dtype": "bfloat16"}
    flops, nbytes, precision = gritlm.work(config, [3, 5])
    attention = 8 * 8 + 8 * 4 * 2 + 8 * 8  # q, k and v, o
    per_token = attention + 8 * 4 + 2 * 3 * 8 * 16  # the router, two experts' gate, up and down
    assert flops == 2 * 8 * per_token + 4 * (9 + 25) * 2 * 4
    assert nbytes == 2 * (attention + 8 * 4 + 4 * 3 * 8 * 16 + 8 * 8) + 4 * 8 + 4 * 8 * 2
    assert precision == "bf16" and gritlm.work(dict(config, torch_dtype="float32"), [3, 5])[2] == "tf32"


def test_the_published_work_per_token_and_call():
    """About 12.6 GFLOP per token over the 16 layers held (the attention's
    products 1.34 of it, two experts' 11.27, the router 0.001) and the 16
    layers' 46.44 GB of weights a call (the embedding's rows as read)."""
    config = gritlm.cell_config()
    flops, nbytes, _precision = gritlm.work(config, [1])
    assert 12.6e9 < flops < 12.7e9 and 46.44e9 < nbytes < 46.45e9


def test_the_moe_least_time_by_hand():
    """One forward of 352 tokens at the published widths, 16 layers: 11,264
    pairs routed. The experts' 45.10 GB and the combine's 0.28 GB bound it
    (13.54 ms), over its 3.97 TFLOP (4.01 ms)."""
    config = gritlm.cell_config()
    routed = 352 * 2 * 16
    weights = 16 * 8 * 3 * 4096 * 14336 * 2
    combine = 4 * 4096 * (routed + routed // 2)
    want = (weights + combine) / roofline.HBM_BYTES_PER_S
    assert gritlm.moe_least_s(config, routed, 1) == pytest.approx(want)
    assert 13.5e-3 < want < 13.6e-3 and 6.0 * 4096 * 14336 * routed / roofline.PEAK_FLOPS["bf16"] < 4.1e-3
    assert gritlm.moe_least_s(config, 2 * routed, 2) == pytest.approx(2 * want)


def test_a_traced_run_reads_the_cells_metrics():
    """On the CPU the trace has no kernel, so the two roofline shares are
    left out; the other three new metrics read the profiled call."""
    result, _rows = _run(trace=True)
    assert result["correct"]
    got = {name: m["value"] for name, m in result["metrics"].items()}
    assert set(got) & set(NEW_METRICS) == {"embed_ms.grit", "moe_load_ratio.grit", "step_mfu.grit"}
    assert got["step_mfu.grit"] > 0 and got["embed_ms.grit"] > 0 and 1.0 <= got["moe_load_ratio.grit"] < 8.0


def test_the_readers_by_hand(monkeypatch):
    import hipporag_tpu_torch.utils.timing as timing
    from perfbench.spans import ROOT_SPAN

    def sp(name, sid, parent, attrs, ms=4.0):
        return timing.Span(name, sid, parent, 1, 0, int(ms * 1e6), attrs)

    log = [sp(ROOT_SPAN, 1, None, {}),
           sp("retrieve/embed", 2, 1, {"texts": 32, "tokens": 640, "padded_tokens": 704, "forwards": 2,
                                        "routed": 2 * 11264, "expert_rows_max": 2 * 16 * 110})]
    kernels = [("moe_gate_up_kernel", 0.012, False), ("moe_down_kernel", 0.006, False),
               ("moe_route_kernel", 0.001, False), ("moe_combine_kernel", 0.001, False),
               ("swiglu_kernel", 0.002, False), ("scan_kernel", 0.5, True)]
    ctx = run.Context(trace={"range_device_s": {"retrieve/embed": 0.5}, "kernels": kernels}, counters={},
                      window_s=1.0, stages=[{"encode": 0.1}], traced_stages=[{"encode": 0.1}, {"encode": 0.2}])
    monkeypatch.setattr(timing, "spans", lambda: log)
    least = gritlm.moe_least_s(gritlm.cell_config(), 2 * 11264, 2)
    assert run.read_metric("moe_roofline.grit", ctx) == pytest.approx(100.0 * least / 0.020)
    assert run.read_metric("moe_load_ratio.grit", ctx) == pytest.approx(110 * 8 / 704)
    assert run.read_metric("embed_ms.grit", ctx) == pytest.approx(4.0)
    assert run.read_metric("encoder_roofline.grit", ctx) == pytest.approx(60.0)
    assert run.read_metric("step_mfu.grit", ctx) == pytest.approx(10.0)
    # a program without the MoE counters (the parent's) reads nothing
    log[1] = sp("retrieve/embed", 2, 1, {"texts": 32, "forwards": 2})
    assert run.read_metric("moe_roofline.grit", ctx) is None and run.read_metric("moe_load_ratio.grit", ctx) is None


def test_the_tiny_cut_is_the_modules():
    _cell, config, _params, limits = tiny_spec(CELL)
    assert {k: config[k] for k in TINY} == TINY and config["query_encoder"] == "gritlm"
    assert config["index_vectors"]["dim"] == config["hipporag"]["embedding_dim"] == TINY["hidden_size"]
    assert limits["embed_err"] == TINY_LIMITS["embed_err"]
    full = run.cell_spec(manifest(), CELL)[1]
    assert full == gritlm.cell_config()
    published = dict(ROUTE_SIZES, max_position_embeddings=gritlm.MAX_POSITIONS, torch_dtype="bfloat16")
    assert {k: full[k] for k in published if k != "num_hidden_layers"} == {
        k: v for k, v in published.items() if k != "num_hidden_layers"}
    assert set(published) == set(TINY)
    assert full["num_hidden_layers"] == 16 and full["published"]["num_hidden_layers"] == 32
    assert gritlm.embedding_name(full) == "GritLM/random-num_hidden_layers=16"
    assert TINY["num_local_experts"] == 8 and TINY["num_experts_per_tok"] == 2 and TINY["num_hidden_layers"] >= 2


@pytest.mark.parametrize("top_k", [2, 8])
def test_the_moe_ops_plain_versions_are_the_references_block(top_k):
    """Route, gate/up, the decoder's SwiGLU, down and combine, each the plain
    version of its kernel, give the reference's MoE block on every real
    token; padded tokens get 0."""
    from hipporag_tpu_torch.embedding import nvembed_encoder as nv
    from hipporag_tpu_torch.ops import moe

    config = dict(TINY, num_experts_per_tok=top_k)
    layer = plain.weights(config, SEED, "cpu")["layers"][0]
    gen = torch.Generator().manual_seed(9)
    b, seq, d = 3, 7, TINY["hidden_size"]
    y = torch.randn(b * seq, d, generator=gen)
    lengths = torch.tensor([7, 4, 6])
    r = moe.moe_route_plain(y @ layer["router_w"], lengths, top_k)
    h = nv.swiglu_plain(moe.moe_gate_up_plain(y, layer["gate_w"], layer["up_w"], r), torch.float32)
    got = moe.moe_combine_plain(moe.moe_down_plain(h, layer["down_w"], r), r).view(b, seq, d)
    want = plain._moe(y.view(b, seq, d), layer, config, lambda x, w: x @ w)
    real = torch.arange(seq)[None, :] < lengths[:, None]
    torch.testing.assert_close(got[real], want[real], rtol=1e-5, atol=1e-6)
    assert (got[~real] == 0).all()
