"""The fixtures of ``chip_smoke.py`` phases 4 and 5, from the JAX package.

- ``tests/fixtures/torch_port_encoder_768x12.npz``: 16 texts whose token
  counts fill every bucket from 16 to 512 (and one past 512 positions),
  each encoded alone by the JAX package's ``jax/random-768x12`` (BERT-base
  width) on the CPU in f32 and bf16 compute, with the bounds of
  ``tests/test_torch_encoder.py`` the card is held to.
- ``tests/fixtures/torch_port_encoder_sample_expected.json``: every dense
  entry point (``chip_smoke.entry_point_record``) of the JAX package on the
  sample corpus with ``jax/random-768x12`` in f32 and the mock LLM.

Both are regenerated here and must be unchanged; the port at 768x12 on the
CPU is held to the first. ``python tests/test_torch_encoder_fixtures.py``
rewrites them.
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

import hipporag_tpu
from hipporag_tpu.datasets import load_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

ENCODER_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_encoder_768x12.npz")
ENTRY_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_encoder_sample_expected.json")
ENTRY_CONFIG = {"llm_name": "mock", "embedding_model_name": "jax/random-768x12",
                "embedding_model_dtype": "float32", "vector_store_type": "memory"}
# word counts of the encoder fixture's texts: every bucket from 16 to 512 and
# a text past 512 positions (cut after tokenizing, losing [SEP])
FIXTURE_WORDS = (0, 3, 14, 15, 30, 31, 62, 63, 126, 127, 254, 255, 400, 510, 511, 600)


def fixture_texts(seed=0):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(letters[rng.integers(0, 26, rng.integers(2, 9))]) for _ in range(2000)]
    return [" ".join(rng.choice(vocab, n)) for n in FIXTURE_WORDS]


def record_encoder_fixture():
    """Each text encoded alone (its own bucket) by the JAX package at
    768x12, in bf16 and f32 compute, with the CPU test's bounds."""
    from hipporag_tpu.embedding.jax_encoder import JaxEncoderEmbeddingModel
    from test_torch_encoder import BF16_MAX_ABS, BF16_MIN_COS, F32_MAX_ABS

    texts = fixture_texts()
    out = {"texts": np.array(texts), "f32_max_abs": F32_MAX_ABS, "bf16_max_abs": BF16_MAX_ABS,
           "bf16_min_cos": BF16_MIN_COS}
    for dt in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as tmp:
            model = JaxEncoderEmbeddingModel(hipporag_tpu.BaseConfig(
                embedding_model_name="jax/random-768x12", embedding_model_dtype=dt, save_dir=tmp))
        tokenized = [model.pretokenize([t]) for t in texts]
        out[f"embeddings_{dt}"] = np.stack(
            [np.asarray(model.encode_pretokenized(ids, mask))[0] for ids, mask in tokenized])
        out["buckets"] = np.array([ids.shape[1] for ids, _ in tokenized])
    return out


def record_entry_fixture():
    with tempfile.TemporaryDirectory() as tmp:
        record, _ = chip_smoke.entry_point_record(
            hipporag_tpu.HippoRAG(hipporag_tpu.BaseConfig(save_dir=os.path.join(tmp, "h"), **ENTRY_CONFIG)),
            hipporag_tpu.StandardRAG(hipporag_tpu.BaseConfig(save_dir=os.path.join(tmp, "s"), **ENTRY_CONFIG)),
            load_dataset("sample", os.path.join(ROOT, "data")),
        )
    return {"config": ENTRY_CONFIG, "record": record}


def test_encoder_fixture_unchanged():
    recorded = np.load(ENCODER_FIXTURE)
    fresh = record_encoder_fixture()
    assert sorted(recorded.files) == sorted(fresh)
    assert list(recorded["texts"]) == list(fresh["texts"])
    np.testing.assert_array_equal(recorded["buckets"], fresh["buckets"])
    assert set(fresh["buckets"]) == {16, 32, 64, 128, 256, 512}
    for key in ("f32_max_abs", "bf16_max_abs", "bf16_min_cos"):
        assert float(recorded[key]) == fresh[key]
    for dt in ("float32", "bfloat16"):
        np.testing.assert_allclose(recorded[f"embeddings_{dt}"], fresh[f"embeddings_{dt}"], atol=1e-6)


def test_entry_fixture_unchanged():
    with open(ENTRY_FIXTURE) as fh:
        recorded = json.load(fh)
    fresh = record_entry_fixture()
    assert recorded["config"] == fresh["config"]
    chip_smoke.compare_records(fresh["record"], recorded["record"], score_atol=1e-6)


def test_port_matches_encoder_fixture():
    """What phase 4a checks on the card, on the CPU: the port at 768x12 in
    its own bucket per text, held to the fixture within the stated bounds."""
    recorded = np.load(ENCODER_FIXTURE)
    bounds = {k: float(recorded[k]) for k in ("f32_max_abs", "bf16_max_abs", "bf16_min_cos")}
    texts = [str(t) for t in recorded["texts"]]
    with tempfile.TemporaryDirectory() as tmp:
        for dt in ("float32", "bfloat16"):
            model = chip_smoke.encoder_model("cpu", dt, tmp)
            got = chip_smoke.encode_each(model, texts)
            chip_smoke.check_bounds(got, recorded[f"embeddings_{dt}"], bounds, dt, dt)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    enc = record_encoder_fixture()
    np.savez_compressed(ENCODER_FIXTURE, **enc)
    with open(ENTRY_FIXTURE, "w") as fh:
        json.dump(record_entry_fixture(), fh, indent=1)
        fh.write("\n")
    print("wrote", ENCODER_FIXTURE, ENTRY_FIXTURE)
