"""The ``nvembed2`` pair in its cell, ``nvembed2-7b-musique.batch``, cut to
the module's tiny sizes on the CPU: a run is correct and reports
``embed_err``; faults in the program are caught by it; the control lies
above its limit; the encoder's work and the cell's readers by hand."""

from __future__ import annotations

import time

import pytest
import torch

from tiny import manifest, tiny_spec

from perfbench import run
from perfbench.encoders import nvembed2
from perfbench.encoders.nvembed2 import TINY, TINY_LIMITS

CELL = "nvembed2-7b-musique.batch"
SEED = 2**31 + 1919
NEW_METRICS = ("step_mfu.nv7b", "embed_ms.nv7b", "encoder_roofline.nv7b", "embed_pad_share.nv7b")


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


def _instruction_pooled(module):
    return module.NVEmbedV2DeviceEmbeddingModel, "_masked_positions", lambda self, instruction: 0


def _residual_in_bf16(module):
    mlp = module._mlp
    return module, "_mlp", lambda x, layer, enc: mlp(x, layer, enc).to(torch.bfloat16).float()


@pytest.mark.parametrize("fault", [_instruction_pooled, _residual_in_bf16], ids=lambda f: f.__name__)
def test_a_broken_program_is_caught_by_embed_err(monkeypatch, fault):
    from hipporag_tpu_torch.embedding import nvembed_encoder

    monkeypatch.setattr(*fault(nvembed_encoder))
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
    heads of 4 sharing 1 key/value head, MLP 16) and a pooling of 2 cross
    heads of 8 over 3 latents with an MLP of 2 widths, in bf16."""
    config = {"hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2, "num_key_value_heads": 1,
              "head_dim": 4, "intermediate_size": 16, "num_latents": 3, "num_cross_heads": 2, "cross_dim_head": 8,
              "latent_mlp_mult": 2, "torch_dtype": "bfloat16"}
    flops, nbytes, precision = nvembed2.work(config, [3, 5])
    layer = 8 * 8 + 8 * 4 * 2 + 8 * 8 + 3 * 8 * 16  # q, k and v, o, gate, up and down
    pool = 8 * 16 + 16 * 8 + 8 * 32 + 16 * 8  # to_q, to_out, the GEGLU's in and out
    latents = 2 * 3 * 16  # QK^T and PV over the latents, per token
    assert flops == 2 * 8 * (layer + pool + latents) + 4 * (9 + 25) * 2 * 4
    assert nbytes == 2 * (layer + pool + 2 * 3 * 16 + 8 * 8) + 4 * 8 + 4 * 8 * 2
    assert precision == "bf16" and nvembed2.work(dict(config, torch_dtype="float32"), [3, 5])[2] == "tf32"


def test_the_published_work_per_token():
    """About 15 GFLOP per token at the published sizes: 13.96 in the
    decoder's products, 1.0 in the pooling's; 15 GB of weights read."""
    flops, nbytes, _precision = nvembed2.work(nvembed2.PUBLISHED, [1])
    assert 14.9e9 < flops < 15.0e9 and 14.9e9 < nbytes < 15.1e9


def test_a_traced_run_reads_the_cells_metrics():
    """On the CPU the trace has no kernel, so the encoder's roofline share is
    left out; the other three new metrics read the profiled call."""
    result, _rows = _run(trace=True)
    assert result["correct"]
    got = {name: m["value"] for name, m in result["metrics"].items()}
    assert set(got) & set(NEW_METRICS) == {"step_mfu.nv7b", "embed_ms.nv7b", "embed_pad_share.nv7b"}
    assert got["step_mfu.nv7b"] > 0 and got["embed_ms.nv7b"] > 0 and 0 <= got["embed_pad_share.nv7b"] < 50


def test_the_readers_by_hand(monkeypatch):
    import hipporag_tpu_torch.utils.timing as timing
    from perfbench.spans import ROOT_SPAN

    def sp(name, sid, parent, attrs, ms=4.0):
        return timing.Span(name, sid, parent, 1, 0, int(ms * 1e6), attrs)

    log = [sp(ROOT_SPAN, 1, None, {}),
           sp("retrieve/embed", 2, 1, {"texts": 4, "tokens": 75, "pooled": 35, "padded_tokens": 100, "forwards": 2})]
    ctx = run.Context(trace={"range_device_s": {"retrieve/embed": 0.5}}, counters={}, window_s=1.0,
                      stages=[{"encode": 0.1}], traced_stages=[{"encode": 0.1}, {"encode": 0.2}])
    monkeypatch.setattr(timing, "spans", lambda: log)
    assert run.read_metric("embed_pad_share.nv7b", ctx) == pytest.approx(25.0)
    assert run.read_metric("embed_ms.nv7b", ctx) == pytest.approx(4.0)
    assert run.read_metric("encoder_roofline.nv7b", ctx) == pytest.approx(60.0)
    assert run.read_metric("step_mfu.nv7b", ctx) == pytest.approx(10.0)


def test_the_tiny_cut_is_the_modules():
    _cell, config, _params, limits = tiny_spec(CELL)
    assert {k: config[k] for k in TINY} == TINY and config["query_encoder"] == "nvembed2"
    assert config["index_vectors"]["dim"] == config["hipporag"]["embedding_dim"] == TINY["hidden_size"]
    assert limits["embed_err"] == TINY_LIMITS["embed_err"]
    full = run.cell_spec(manifest(), CELL)[1]
    assert {k: full[k] for k in nvembed2.PUBLISHED} == nvembed2.PUBLISHED
    assert nvembed2.embedding_name(full) == "NV-Embed-v2/random"
