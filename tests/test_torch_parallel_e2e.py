"""The port's multi-device entry points against the JAX package's, and the
float32 pin.

- ``HippoRAG`` with ``mesh_shape=(2, 4)`` on the sample corpus (mock LLM and
  embedder; the port on 8 CPU virtual shards, the JAX package on its
  8-device CPU mesh) ranks exactly as the JAX package's ``(2, 4)`` run and
  as the port's single-device run, before and after a ``delete`` (which
  re-shards); doc scores within rtol 1e-5 / atol 1e-7, as
  ``tests/test_torch_e2e.py`` holds the single-device run. ``retrieve_dpr``
  and ``dense_passage_retrieval`` go through the sharded passage matrix.
- The ``jax/`` encoder with a mesh splits each batch over the mesh devices;
  its embeddings equal the unsharded encoder's and the JAX package's
  batch-sharded encoder's within ``tests/test_torch_encoder.py``'s bounds.
- ``utils/precision.full_f32`` pins TF32 off and restores the caller's
  flags, and ``retrieve`` under a caller's ``"high"`` precision runs its
  products at ``"highest"`` and ranks as under ``"highest"``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import hipporag_tpu
import hipporag_tpu_torch
from hipporag_tpu.config import BaseConfig as RefConfig
from hipporag_tpu.datasets import load_dataset
from hipporag_tpu.embedding import jax_encoder as ref_encoder
from hipporag_tpu_torch.config import BaseConfig
from hipporag_tpu_torch.embedding import encoder as port_encoder
from hipporag_tpu_torch.parallel.backend import ShardedBackend
from hipporag_tpu_torch.utils.precision import full_f32

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-7
F32_MAX_ABS, BF16_MAX_ABS, BF16_MIN_COS = 1e-5, 5e-3, 0.9995


def _config(save_dir, pkg=hipporag_tpu_torch, **kw):
    return pkg.BaseConfig(llm_name="mock", embedding_model_name="mock", vector_store_type="memory",
                          save_dir=str(save_dir), **kw)


def _assert_same_ranking(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.question == w.question and g.docs == w.docs
        np.testing.assert_allclose(g.doc_scores, w.doc_scores, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def _mesh(rag):
    """The mesh a HippoRAG of either package retrieves on, or None."""
    if isinstance(rag, hipporag_tpu.HippoRAG):
        return rag._mesh
    return rag._backend.mesh if isinstance(rag._backend, ShardedBackend) else None


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    docs, queries, _, _ = load_dataset("sample", os.path.join(ROOT, "data"))
    runs = {}
    for name, pkg, shape in (("jax_mesh", hipporag_tpu, (2, 4)), ("port_mesh", hipporag_tpu_torch, (2, 4)),
                             ("port_single", hipporag_tpu_torch, (1, 1))):
        cfg = _config(tmp_path_factory.mktemp(name), pkg, mesh_shape=shape)
        rag = pkg.HippoRAG(cfg) if pkg is hipporag_tpu else pkg.HippoRAG(cfg, device="cpu")
        rag.index(docs)
        run = {"retrieve": rag.retrieve(queries), "mesh": _mesh(rag)}
        if pkg is hipporag_tpu_torch:
            run["dpr"] = rag.retrieve_dpr(queries)
            run["dense"] = rag.dense_passage_retrieval(queries[1])
        rag.delete(docs[:2])
        run["after_delete"] = rag.retrieve(queries)
        run["after_delete_mesh"] = _mesh(rag)
        runs[name] = run
    return runs


def test_mesh_retrieve_ranks_as_jax_mesh_and_single_device(mesh_runs):
    port, ref, single = mesh_runs["port_mesh"], mesh_runs["jax_mesh"], mesh_runs["port_single"]
    assert port["mesh"] is not None and ref["mesh"] is not None and single["mesh"] is None
    assert (port["mesh"].dp, port["mesh"].corpus) == (2, 4)
    assert all(d == torch.device("cpu") for d in port["mesh"].devices.flat)
    _assert_same_ranking(port["retrieve"], ref["retrieve"])
    _assert_same_ranking(port["retrieve"], single["retrieve"])


def test_mesh_delete_reshards(mesh_runs):
    port, ref, single = mesh_runs["port_mesh"], mesh_runs["jax_mesh"], mesh_runs["port_single"]
    assert port["after_delete_mesh"] is not None
    _assert_same_ranking(port["after_delete"], ref["after_delete"])
    _assert_same_ranking(port["after_delete"], single["after_delete"])
    assert port["after_delete"][0].docs != port["retrieve"][0].docs


def test_mesh_dense_retrieval_matches_single_device(mesh_runs):
    port, single = mesh_runs["port_mesh"], mesh_runs["port_single"]
    _assert_same_ranking(port["dpr"], single["dpr"])
    np.testing.assert_array_equal(port["dense"][0], single["dense"][0])
    np.testing.assert_allclose(port["dense"][1], single["dense"][1], rtol=SCORE_RTOL, atol=SCORE_ATOL)


def _texts(seed=0):
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefghij"), rng.integers(1, 7))) for _ in range(300)]
    return [" ".join(rng.choice(words, n)) for n in (0, 5, 60, 300, 7, 40, 11)]


def _within(got, want, compute_dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    if compute_dtype == "float32":
        assert err <= F32_MAX_ABS, err
    else:
        assert err <= BF16_MAX_ABS, err
        real = np.linalg.norm(want, axis=1) > 0
        cos = (got * want).sum(1)[real] / (np.linalg.norm(got, axis=1)[real] * np.linalg.norm(want, axis=1)[real])
        assert cos.min() >= BF16_MIN_COS, cos.min()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_encoder_batch_sharding_matches_unsharded_and_jax(tmp_path, compute_dtype):
    kw = dict(embedding_model_name="jax/random-64x2", save_dir=str(tmp_path), embedding_model_dtype=compute_dtype,
              embedding_batch_size=8)
    sharded = port_encoder.TorchEncoderEmbeddingModel(BaseConfig(mesh_shape=(2, 4), **kw), device="cpu")
    plain = port_encoder.TorchEncoderEmbeddingModel(BaseConfig(**kw), device="cpu")
    assert len(sharded._shard_encoders) == 8 and all(e is sharded.encoder for e in sharded._shard_encoders)
    assert plain._shard_encoders is None
    texts = _texts()  # 7 texts: the batch pads to 8 with a fully masked row
    got = sharded.batch_encode(texts, norm=True)
    _within(got, plain.batch_encode(texts, norm=True), compute_dtype)
    assert len(jax.devices()) == 8
    want = ref_encoder.JaxEncoderEmbeddingModel(RefConfig(mesh_shape=(2, 4), **kw)).batch_encode(texts, norm=True)
    _within(got, want, compute_dtype)
    # the full-mask path (a hole mid-row) through the shards
    ids, mask = sharded.pretokenize(texts[1:4])
    mask = mask.copy()
    mask[0, 1] = 0
    _within(sharded.encode_pretokenized(ids, mask).numpy(), plain.encode_pretokenized(ids, mask).numpy(),
            compute_dtype)


# ---------------------------------------------------------------------------
# The float32 pin
# ---------------------------------------------------------------------------

def _flags():
    return (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture()
def caller_precision():
    before = _flags()
    yield
    torch.set_float32_matmul_precision(before[0])
    torch.backends.cudnn.allow_tf32 = before[2]


def test_full_f32_pins_and_restores(caller_precision):
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    caller = _flags()
    assert caller == ("high", True, True)
    with full_f32():
        assert _flags() == ("highest", False, False)
        with full_f32():
            assert _flags() == ("highest", False, False)
        assert _flags() == ("highest", False, False)  # an inner block does not restore early
    assert _flags() == caller
    with pytest.raises(KeyError):
        with full_f32():
            assert _flags() == ("highest", False, False)
            raise KeyError("boom")
    assert _flags() == caller
    torch.set_float32_matmul_precision("medium")
    with full_f32():
        assert _flags()[0] == "highest"
    assert _flags()[0] == "medium"


def test_retrieve_pins_full_f32_under_a_high_caller(tmp_path, monkeypatch, caller_precision):
    from hipporag_tpu_torch import hipporag as port_hipporag

    docs, queries, _, _ = load_dataset("sample", os.path.join(ROOT, "data"))
    rag = hipporag_tpu_torch.HippoRAG(_config(tmp_path), device="cpu")
    rag.index(docs)
    want = rag.retrieve(queries)

    seen = []
    plain = port_hipporag.fact_topk

    def recording(*args, **kw):
        seen.append(_flags())
        return plain(*args, **kw)

    monkeypatch.setattr(port_hipporag, "fact_topk", recording)
    torch.set_float32_matmul_precision("high")
    got = rag.retrieve(queries)
    assert seen and all(f == ("highest", False, False) for f in seen), seen
    assert torch.get_float32_matmul_precision() == "high"
    for g, w in zip(got, want):
        assert g.docs == w.docs
        np.testing.assert_array_equal(g.doc_scores, w.doc_scores)
