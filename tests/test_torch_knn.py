"""The port's synonymy kNN against the JAX package's ``retrieve_knn_pairs``.

Pair sets (row, col) must be equal and scores agree to 1e-6, on
L2-normalized vectors with planted near-duplicates (so some pairs clear
the threshold) and on hashing-embedder entity vectors.

``retrieve_knn`` keeps the reference's interface (``tests/test_ops.py``'s
twin): ``{query_id: ([key ids best-first], [scores])}``. On the same
numpy-seeded unit vectors, ``retrieve_knn_arrays`` and
``streaming_topk_scores`` return the JAX package's indices exactly and
its scores to 1e-6, with padded key rows masked and ties to the lower key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipporag_tpu.config import BaseConfig
from hipporag_tpu.embedding.hashing import HashingNgramEmbeddingModel
from hipporag_tpu.ops import knn as ref
from hipporag_tpu_torch.ops import knn

torch.set_num_threads(1)


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n // 4, d))
    x = centers[rng.integers(0, len(centers), n)] + 0.3 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _pairs(rows, cols, scores):
    return {(int(r), int(c)): float(s) for r, c, s in zip(rows, cols, scores)}


def _check_equal(got, want):
    g, w = _pairs(*got), _pairs(*want)
    assert set(g) == set(w)
    for key in w:
        assert abs(g[key] - w[key]) <= 1e-6
    # row-major order, descending score within a row
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("qbs,kbs", [(1000, 10000), (7, 13)])
@pytest.mark.parametrize("k", [5, 400])
def test_shared_queries_keys_pairs_match_jax(qbs, kbs, k):
    x = _clustered(150, 32, seed=k)
    got = knn.retrieve_knn_pairs(x, x, 150, k, 0.8, query_batch_size=qbs, key_batch_size=kbs, device="cpu")
    want = ref.retrieve_knn_pairs(x, x, 150, k, 0.8, query_batch_size=qbs, key_batch_size=kbs)
    assert len(want[0]) > 150  # self pairs plus planted neighbours
    _check_equal(got, want)


def test_separate_keys_with_padding_rows_match_jax():
    q = _clustered(40, 16, seed=1)
    keys = np.concatenate([_clustered(60, 16, seed=1), np.zeros((4, 16), np.float32)])
    got = knn.retrieve_knn_pairs(q, keys, 60, 10, 0.5, query_batch_size=16, key_batch_size=32, device="cpu")
    want = ref.retrieve_knn_pairs(q, keys, 60, 10, 0.5, query_batch_size=16, key_batch_size=32)
    _check_equal(got, want)


def test_hashing_embedder_entity_vectors_match_jax():
    names = ["port ellery", "port ellery town", "calder county", "calder", "mira voss",
             "mira voss biologist", "meridian opera house", "opera house", "juniper labs",
             "juniper laboratories"]
    model = HashingNgramEmbeddingModel(BaseConfig(embedding_model_name="hashing"))
    x = np.asarray(model.batch_encode(names, norm=True), np.float32)
    got = knn.retrieve_knn_pairs(x, x, len(names), 108, 0.3, device="cpu")
    want = ref.retrieve_knn_pairs(x, x, len(names), 108, 0.3)
    _check_equal(got, want)


def test_streaming_topk_ties_keep_the_lower_key():
    q = np.ones((2, 8), np.float32)
    keys = np.ones((20, 8), np.float32)
    vals, idx = knn._streaming_topk(torch.from_numpy(q), torch.from_numpy(keys), 20, 5, key_chunk=6)
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(5), (2, 1)))
    np.testing.assert_array_equal(vals.numpy(), 8.0)


def _vecs(n, d, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_retrieve_knn_interface():
    vecs = _vecs(20, 8, 3)
    ids = [f"e{i}" for i in range(20)]
    out = knn.retrieve_knn(ids, ids, vecs, vecs, k=4, query_batch_size=6, key_batch_size=7, device="cpu")
    assert set(out.keys()) == set(ids)
    for qid, (nbrs, scores) in out.items():
        assert len(nbrs) == 4
        assert nbrs[0] == qid  # self-similarity = 1.0 is always the top hit
        assert scores == sorted(scores, reverse=True)
    want = ref.retrieve_knn(ids, ids, vecs, vecs, k=4, query_batch_size=6, key_batch_size=7)
    for qid in ids:
        assert out[qid][0] == want[qid][0]
        np.testing.assert_allclose(out[qid][1], want[qid][1], atol=1e-6)
    assert knn.retrieve_knn(["q"], [], vecs[:1], vecs[:0], device="cpu") == {"q": ([], [])}


def test_retrieve_knn_arrays_matches_jax_with_ties():
    keys = _vecs(300, 16, 4)
    keys[150] = keys[20]  # an exact tie: the lower key comes first
    queries = np.concatenate([_vecs(37, 16, 5), keys[20:21]])
    vals, idxs = knn.retrieve_knn_arrays(queries, keys, 290, 9, query_batch_size=16,
                                          key_batch_size=64, device="cpu")
    want_vals, want_idxs = ref.retrieve_knn_arrays(queries, keys, 290, 9, query_batch_size=16,
                                                   key_batch_size=64)
    np.testing.assert_array_equal(idxs, want_idxs)
    np.testing.assert_allclose(vals, want_vals, atol=1e-6)
    assert (idxs < 290).all() and list(idxs[-1, :2]) == [20, 150]


def test_streaming_topk_scores_matches_jax():
    keys = np.concatenate([_vecs(100, 12, 6), np.zeros((28, 12), np.float32)])  # padded rows
    queries = _vecs(5, 12, 7)
    vals, idxs = knn.streaming_topk_scores(torch.from_numpy(queries), torch.from_numpy(keys), 100, 7,
                                            key_chunk=32)
    want_vals, want_idxs = ref.streaming_topk_scores(jnp.asarray(queries), jnp.asarray(keys),
                                                     jnp.asarray(100, jnp.int32), 7, key_chunk=32)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(want_idxs))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), atol=1e-6)


def test_ops_exports_match_jax():
    import hipporag_tpu.ops as ref_ops
    import hipporag_tpu_torch.ops as port_ops

    assert sorted(port_ops.__all__) == sorted(ref_ops.__all__)
    assert all(callable(getattr(port_ops, name)) for name in port_ops.__all__)
