"""The port's on-device encoder against the JAX package's (``jax_encoder.py``).

Both packages encode the same numpy inputs on the CPU. Bounds on the
unit-norm embeddings:

- float32: max |port - JAX| <= 1e-5 (both sum exact float32 products, in
  different orders; measured <= 1.1e-7 at 768x12).
- bfloat16: per-row cosine >= 0.9995 and max |port - JAX| <= 5e-3. Both
  round the same operands to bf16, so the products agree; but a sum that
  differs in the last float32 place can round an activation to the
  neighbouring bf16 value (2^-8 relative) before the next product, and such
  flips compound over the layers (measured: max 4.3e-4, cosine 0.99999 at
  768x12; about 1e-6 at the widths below).

``chip_smoke.py`` holds the card's 768x12 embeddings to the same bounds
(stored in ``tests/fixtures/torch_port_encoder_768x12.npz``, which
``tests/test_torch_encoder_fixtures.py`` regenerates from the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipporag_tpu.config import BaseConfig as RefConfig
from hipporag_tpu.embedding import jax_encoder as ref
from hipporag_tpu_torch.config import BaseConfig
from hipporag_tpu_torch.convert import encoder_params_from_jax
from hipporag_tpu_torch.embedding import encoder as port
from hipporag_tpu_torch.embedding import get_embedding_model

torch.set_num_threads(1)

F32_MAX_ABS = 1e-5
BF16_MAX_ABS = 5e-3
BF16_MIN_COS = 0.9995


def assert_within_bounds(got, want, compute_dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    if compute_dtype == "float32":
        assert err <= F32_MAX_ABS, err
    else:
        assert err <= BF16_MAX_ABS, err
        real = np.linalg.norm(want, axis=1) > 0
        cos = (got * want).sum(1)[real] / (
            np.linalg.norm(got, axis=1)[real] * np.linalg.norm(want, axis=1)[real])
        assert cos.min() >= BF16_MIN_COS, cos.min()


def _ids_and_lengths(vocab, b=4, l=32, seed=0):
    """A full row, a ragged row, a zero-length row and a one-token row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, vocab, (b, l)).astype(np.int32)
    lengths = np.array([l, l // 2 - 3, 0, 1], np.int32)[:b]
    ids[np.arange(l)[None, :] >= lengths[:, None]] = 0
    return ids, lengths


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,layers", [(64, 2), (128, 2)])
def test_forward_matches_jax(dim, layers, compute_dtype):
    params, heads = ref.params_random(dim, layers)
    enc = encoder_params_from_jax(params, heads, compute_dtype, "cpu")
    ids, lengths = _ids_and_lengths(30522)
    mask = (np.arange(ids.shape[1])[None, :] < lengths[:, None]).astype(np.int32)
    want = np.asarray(ref.encode_forward(params, jnp.asarray(ids), jnp.asarray(mask), heads, compute_dtype))
    want_wire = np.asarray(
        ref.encode_forward_wire(params, jnp.asarray(ids), jnp.asarray(lengths), heads, compute_dtype))
    got = enc.encode_forward(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    got_wire = enc.encode_forward_wire(torch.from_numpy(ids), torch.from_numpy(lengths)).numpy()
    assert_within_bounds(got, want, compute_dtype)
    assert_within_bounds(got_wire, want_wire, compute_dtype)
    np.testing.assert_array_equal(got, got_wire)
    # the zero-length row pools to zeros, not NaN, in both packages
    assert (got[2] == 0).all() and (want[2] == 0).all()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_non_monotone_mask_matches_jax(tmp_path, compute_dtype):
    cfg = BaseConfig(embedding_model_name="jax/random-64x2", save_dir=str(tmp_path),
                     embedding_model_dtype=compute_dtype)
    model = port.TorchEncoderEmbeddingModel(cfg, device="cpu")
    ids, mask = model.pretokenize(["hello world one two", "a much longer sentence " * 3])
    mask = mask.copy()
    mask[0, 1] = 0  # a hole mid-row: the full-mask path
    params, heads = ref.params_random(64, 2)
    want = np.asarray(ref.encode_forward(params, jnp.asarray(ids), jnp.asarray(mask), heads, compute_dtype))
    got = model.encode_pretokenized(ids, mask).numpy()
    assert_within_bounds(got, want, compute_dtype)
    right_padded = model.encode_pretokenized(ids, (np.arange(ids.shape[1]) < mask.sum(1)[:, None]))
    assert np.abs(got[0] - right_padded[0].numpy()).max() > 1e-6  # the hole mattered


@pytest.mark.parametrize("dim,layers", [(64, 2), (128, 3)])
def test_params_random_bit_equal(dim, layers):
    want, want_heads = ref.params_random(dim, layers, vocab=5000, max_len=128, seed=3)
    got, got_heads = port.params_random(dim, layers, vocab=5000, max_len=128, seed=3)
    assert got_heads == want_heads
    flat_want, tree_want = jax.tree_util.tree_flatten(want)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    assert tree_got == tree_want
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


def _texts(seed=0):
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdefghij"), rng.integers(1, 7))) for _ in range(300)]
    return [" ".join(rng.choice(words, n)) for n in (0, 5, 60, 300, 600)] + ["Hello, World! MiXeD case"]


@pytest.mark.parametrize("max_seq_len", [2048, 100])
def test_hash_tokenizer_and_buckets_equal(tmp_path, max_seq_len):
    """Id for id, with the cut to 512 positions after the tokenizer's
    truncation (a 600-word text keeps 512 ids and loses [SEP])."""
    kw = dict(embedding_model_name="jax/random-64x2", save_dir=str(tmp_path), embedding_max_seq_len=max_seq_len)
    jax_model = ref.JaxEncoderEmbeddingModel(RefConfig(**kw))
    model = port.TorchEncoderEmbeddingModel(BaseConfig(**kw), device="cpu")
    texts = _texts()
    for batch in (texts, texts[:2], texts[3:4], texts[4:]):
        want_ids, want_mask = jax_model.pretokenize(batch)
        got_ids, got_mask = model.pretokenize(batch)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_mask, want_mask)
    ids, mask = model.pretokenize(texts[4:5])
    assert ids.shape == (1, min(512, max_seq_len)) and mask.all()
    if max_seq_len == 2048:
        assert 102 not in ids[0]  # [SEP] was cut with the 600-word tail
    assert [model._pad_bucket(n) for n in (1, 16, 17, 300, 513)] == [
        jax_model._pad_bucket(n) for n in (1, 16, 17, 300, 513)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_embedding_model_matches_jax_model(tmp_path, compute_dtype):
    kw = dict(embedding_model_name="jax/random-64x2", save_dir=str(tmp_path),
              embedding_model_dtype=compute_dtype, embedding_batch_size=4)
    want = ref.JaxEncoderEmbeddingModel(RefConfig(**kw)).batch_encode(_texts(), norm=True)
    model = get_embedding_model(BaseConfig(**kw), device="cpu")
    assert isinstance(model, port.TorchEncoderEmbeddingModel)
    got = model.batch_encode(_texts(), norm=True)
    assert got.dtype == np.float32 and model.embedding_dim == 64
    assert_within_bounds(got, want, compute_dtype)


def test_bucket_padding_consistency(tmp_path):
    """The same text embeds the same whatever else is in its batch."""
    cfg = BaseConfig(embedding_model_name="jax/random-64x1", save_dir=str(tmp_path),
                     embedding_model_dtype="float32")
    model = port.TorchEncoderEmbeddingModel(cfg, device="cpu")
    short = "hello world"
    solo = model.batch_encode([short])
    mixed = model.batch_encode([short, "word " * 40])
    np.testing.assert_allclose(solo[0], mixed[0], atol=1e-5)


@pytest.mark.parametrize(
    "dtype,expected", [("auto", "bfloat16"), ("bfloat16", "bfloat16"), ("float32", "float32"),
                       ("float16", "float32")])
def test_compute_dtype_mapping(tmp_path, dtype, expected):
    kw = dict(embedding_model_name="jax/random-64x1", save_dir=str(tmp_path), embedding_model_dtype=dtype)
    model = port.TorchEncoderEmbeddingModel(BaseConfig(**kw), device="cpu")
    assert model.compute_dtype == ref.JaxEncoderEmbeddingModel(RefConfig(**kw)).compute_dtype == expected
    # linear weights are held once as product operands: bf16-rounded float32 on the CPU
    w = model.encoder.layers[0].q_w
    assert w.dtype == torch.float32
    assert torch.equal(w, w.to(torch.bfloat16).float()) == (expected == "bfloat16")


def test_non_jax_names_go_to_the_host_factory(tmp_path):
    from hipporag_tpu_torch.embedding.mock import MockEmbeddingModel

    cfg = BaseConfig(embedding_model_name="mock", save_dir=str(tmp_path))
    assert isinstance(get_embedding_model(cfg, device="cpu"), MockEmbeddingModel)


def test_mesh_shards_the_batch(tmp_path):
    """``mesh_shape=(1, 2)`` splits each batch over two CPU virtual shards
    (one copy of the weights); the embeddings equal the unsharded model's."""
    kw = dict(embedding_model_name="jax/random-64x1", save_dir=str(tmp_path), embedding_model_dtype="float32")
    model = port.TorchEncoderEmbeddingModel(BaseConfig(mesh_shape=(1, 2), **kw), device="cpu")
    assert [enc is model.encoder for enc in model._shard_encoders] == [True, True]
    texts = _texts()
    assert_within_bounds(model.batch_encode(texts, norm=True),
                         port.TorchEncoderEmbeddingModel(BaseConfig(**kw), device="cpu").batch_encode(texts, norm=True),
                         "float32")


def test_host_array_on_cpu():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    arr = port._HostArray(x)
    np.testing.assert_array_equal(np.asarray(arr), x.numpy())
    assert np.asarray(arr, dtype=np.float64).dtype == np.float64


def _tiny_bert(tmp_path, transformers):
    cfg = transformers.BertConfig(
        vocab_size=200, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, max_position_embeddings=64,
    )
    torch.manual_seed(0)
    model = transformers.BertModel(cfg)
    model.eval()
    path = tmp_path / "tiny-bert"
    model.save_pretrained(path)
    return model, str(path)


def test_hf_state_dict_loader_matches_jax_loader(tmp_path):
    transformers = pytest.importorskip("transformers")
    model, path = _tiny_bert(tmp_path, transformers)
    want, want_heads = ref.params_from_hf_bert(path)
    got, got_heads = port.params_from_hf_bert(path)
    assert got_heads == want_heads == 4
    from_sd = port.params_from_state_dict(model.state_dict(), 2)
    for tree in (got, from_sd):
        flat_got, tree_got = jax.tree_util.tree_flatten(tree)
        flat_want, tree_want = jax.tree_util.tree_flatten(want)
        assert tree_got == tree_want
        for g, w in zip(flat_got, flat_want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 200, size=(3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 8:] = 0
    want_emb = np.asarray(ref.encode_forward(want, jnp.asarray(ids), jnp.asarray(mask), 4, "float32"))
    enc = port.BertEncoder(got, got_heads, "float32", "cpu")
    got_emb = enc.encode_forward(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert_within_bounds(got_emb, want_emb, "float32")
