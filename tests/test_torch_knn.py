"""The port's synonymy kNN against the JAX package's ``retrieve_knn_pairs``.

Pair sets (row, col) must be equal and scores agree to 1e-6, on
L2-normalized vectors with planted near-duplicates (so some pairs clear
the threshold) and on hashing-embedder entity vectors.
"""

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
