"""The port's result building (``hipporag.build_results``, which
``HippoRAG._build_results`` and ``StandardRAG.retrieve`` call).

- Parity: the bucket-level builder against the per-question loop it
  replaced, kept here as the reference, over random buckets with -inf
  padding, order entries at or above the passage count, rows with no valid
  passage, ``k`` of 1 and above the passage count, padding rows, and
  passages with and without metadata. Each result owns its arrays, lists
  and metadata dicts.
- Lifecycle: retrieve, ``index`` passages with metadata, retrieve,
  ``delete``, retrieve; each retrieve returns the current contents and
  metadata, so the passage-aligned tables follow the stores. On the single
  device and on a ``mesh_shape=(1, 2)`` index of CPU virtual shards,
  through ``retrieve`` and ``retrieve_dpr``, and through
  ``StandardRAG.retrieve`` on the single device (its results carry no
  graph seeds).
"""

import copy
import os

import numpy as np
import pytest
import torch

import hipporag_tpu_torch
from hipporag_tpu_torch.datasets import load_dataset
from hipporag_tpu_torch.parallel.backend import ShardedBackend
from hipporag_tpu_torch.utils.misc import Chunk, QuerySolution

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEW_PASSAGES = [
    Chunk(content="Lena Marsh is a violinist. Lena Marsh was born in Port Ellery.",
          source_id="doc-lena", metadata={"title": "Lena Marsh", "year": 1990}),
    Chunk(content="Orin Bay is a fishing village. Orin Bay is located in Calder County.",
          metadata={"title": "Orin Bay", "tags": ["village"]}),
    Chunk(content="Tess Quill wrote a novel about Orin Bay.", source_id="doc-tess"),
]


def _config(save_dir, **kw):
    return hipporag_tpu_torch.BaseConfig(
        llm_name="mock", embedding_model_name="mock", vector_store_type="memory",
        save_dir=str(save_dir), **kw,
    )


def _sample():
    docs, queries, _, _ = load_dataset("sample", os.path.join(ROOT, "data"))
    return docs, queries


def _reference(rag, queries, order, scores, graph_seeds):
    """The per-question loop that built a bucket's results before the
    bucket-level builder."""
    num_passages = len(rag.passage_node_keys)
    out = []
    for i, query in enumerate(queries):
        top_n = [int(j) for j, v in zip(order[i], scores[i]) if j < num_passages and v > -np.inf]
        keys = [rag.passage_node_keys[j] for j in top_n]
        out.append(QuerySolution(
            question=query,
            docs=[rag.chunk_embedding_store.get_row(k)["content"] for k in keys],
            doc_scores=np.asarray(scores[i][: len(top_n)], dtype=np.float64),
            doc_metadata=[dict(rag.chunk_metadata.get(k, {})) for k in keys],
            graph_seeds=list(graph_seeds[i]),
        ))
    return out


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """An index of the sample corpus plus passages with metadata, prepared."""
    rag = hipporag_tpu_torch.HippoRAG(_config(tmp_path_factory.mktemp("parity")), device="cpu")
    rag.index(_sample()[0] + NEW_PASSAGES)
    rag.prepare_retrieval_objects()
    return rag


def _bucket(rng, num_passages, b, b_pad, k):
    """A random ranking as the device hands it over: rows sorted best
    first, -inf padding at the tail (the last question's row, and others at
    random, all padding), indices of padding slots at or above
    ``num_passages`` with finite and -inf scores; the first question's best
    entry a real passage."""
    order = rng.integers(0, num_passages + 8, size=(b_pad, k))
    scores = np.sort(rng.standard_normal((b_pad, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    for i in range(b_pad):
        scores[i, rng.integers(0, k + 1):] = -np.inf
    scores[rng.random(b_pad) < 0.2] = -np.inf
    if b > 1:
        scores[b - 1] = -np.inf
    order[0, 0] %= num_passages
    scores[0, 0] = max(scores[0, 0], 0.0)
    seeds = [[("subject", f"rel{i}", f"object{j}") for j in range(i % 3)] for i in range(b_pad)]
    return [f"question {i}" for i in range(b)], order, scores, seeds


@pytest.mark.parametrize("k", [1, 3, 40])
@pytest.mark.parametrize("seed", range(4))
def test_bucket_builder_matches_the_per_question_loop(prepared, seed, k):
    rag = prepared
    num_passages = len(rag.passage_node_keys)
    assert 3 < num_passages < 40
    assert any(rag.chunk_metadata.get(key) for key in rag.passage_node_keys)
    assert any(not rag.chunk_metadata.get(key) for key in rag.passage_node_keys)
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 9))
    queries, order, scores, seeds = _bucket(rng, num_passages, b, b + int(rng.integers(0, 3)), k)
    metadata_before = copy.deepcopy(rag.chunk_metadata)

    got = rag._build_results(queries, order, scores, seeds)
    want = _reference(rag, queries, order, scores, seeds)

    assert len(got) == len(want) == b
    assert sum(len(r.docs) for r in got) > 0
    for g, w, s in zip(got, want, seeds):
        assert g.question == w.question
        assert g.docs == w.docs
        assert g.doc_metadata == w.doc_metadata
        assert g.doc_scores.dtype == np.float64
        np.testing.assert_array_equal(g.doc_scores, w.doc_scores)
        assert g.graph_seeds == w.graph_seeds and g.graph_seeds is not s

    # each result owns its scores and metadata: writes to one change
    # neither the index's metadata nor any other result
    tables = {id(m) for m in rag.chunk_metadata.values()}
    dicts = [id(m) for r in got for m in r.doc_metadata]
    assert len(set(dicts)) == len(dicts) and not tables & set(dicts)
    for r in got:
        assert r.doc_scores.flags.owndata and not np.shares_memory(r.doc_scores, scores)
    snapshot = copy.deepcopy(got)
    written = next(i for i, r in enumerate(got) if r.docs)
    got[written].doc_metadata[0]["written"] = True
    got[written].doc_scores[:] = 7.0
    assert rag.chunk_metadata == metadata_before
    for i, (r, s) in enumerate(zip(got, snapshot)):
        if i != written:
            assert r.doc_metadata == s.doc_metadata
            np.testing.assert_array_equal(r.doc_scores, s.doc_scores)


def _expected_metadata(chunk):
    meta = dict(chunk.metadata)
    if chunk.source_id is not None:
        meta["source_id"] = chunk.source_id
    return meta


RETRIEVE_CASES = [((1, 1), "retrieve"), ((1, 1), "retrieve_dpr"), ((1, 2), "retrieve"), ((1, 2), "retrieve_dpr"),
                  ((1, 1), "standard_rag.retrieve")]


@pytest.mark.parametrize("mesh_shape,entry", RETRIEVE_CASES,
                         ids=[f"{'single' if m == (1, 1) else 'sharded'}-{e}" for m, e in RETRIEVE_CASES])
def test_each_retrieve_returns_the_current_contents_and_metadata(tmp_path, mesh_shape, entry):
    docs, queries = _sample()
    standard = entry.startswith("standard_rag.")
    cls = hipporag_tpu_torch.StandardRAG if standard else hipporag_tpu_torch.HippoRAG
    rag = cls(_config(tmp_path, mesh_shape=mesh_shape), device="cpu")
    rag.index(docs)
    corpus = {d: {} for d in docs}

    def check():
        results = getattr(rag, entry.rsplit(".", 1)[-1])(queries)
        if standard:
            assert all(r.graph_seeds is None for r in results)
        else:
            assert isinstance(rag._backend, ShardedBackend) == (mesh_shape != (1, 1))
        for r in results:
            # retrieval_top_k (200) is above the passage count: every
            # passage comes back, once, with its own metadata
            assert sorted(r.docs) == sorted(corpus)
            assert r.doc_metadata == [corpus[d] for d in r.docs]
            assert r.doc_scores.dtype == np.float64 and len(r.doc_scores) == len(corpus)

    check()
    rag.index(NEW_PASSAGES)
    corpus.update({c.content: _expected_metadata(c) for c in NEW_PASSAGES})
    check()
    gone = [docs[0], NEW_PASSAGES[0].content]
    rag.delete(gone)
    for d in gone:
        del corpus[d]
    check()
