"""The benchmark's inputs come from the seed alone."""

from __future__ import annotations

import numpy as np
import torch

from tiny import manifest  # noqa: F401  (puts the repository root on sys.path)

from perfbench.corpus import Corpus, QuestionStream
from perfbench.vectors import embed_texts

SHAPE = {"passages": 120, "pool_per_passage": 3, "zipf_s": 0.5, "variants": 3, "variant_share": 0.8,
         "sentences": [3, 6], "words": [10, 25], "entities": [2, 4]}
BIG_SEED = 2**31 + 12_345


def test_corpus_and_openie_repeat_for_a_seed():
    a, b = Corpus(BIG_SEED, SHAPE), Corpus(BIG_SEED, SHAPE)
    assert a.docs == b.docs and a.openie() == b.openie()
    assert Corpus(BIG_SEED + 1, SHAPE).docs != a.docs
    qa, qb = QuestionStream(a, BIG_SEED), QuestionStream(b, BIG_SEED)
    assert qa.take(50) == qb.take(50)


def test_corpus_shape():
    c = Corpus(7, SHAPE)
    assert len(c.docs) == SHAPE["passages"] and len(set(c.docs)) == len(c.docs)
    for doc, ents, triples in zip(c.docs, c.entities, c.triples):
        title, body = doc.split("\n")
        assert ents[0] == title and 3 <= body.count(".") <= 6
        for s, rel, o in triples:
            assert s in doc and o in doc and rel and rel == rel.lower()
        assert len({tuple(t) for t in triples}) == len(triples)


def test_name_variants_are_synonyms_of_their_name():
    """A name's surface forms land above the synonymy threshold of one
    another; the forms of different names do not."""
    from perfbench.corpus import VARIANT_SUFFIXES

    c = Corpus(11, SHAPE)
    names = c.pool[:40]
    forms = [[n] + [f"{n} {s}" for s in VARIANT_SUFFIXES[:SHAPE["variants"]]] for n in names]
    vec = embed_texts([f.lower() for group in forms for f in group], 4096, "cpu")
    sim = (vec @ vec.T).reshape(len(names), len(forms[0]), len(names), len(forms[0]))
    own = torch.stack([sim[i, :, i, :] for i in range(len(names))])
    assert own.min() >= 0.8
    others = sim.clone()
    for i in range(len(names)):
        others[i, :, i, :] = 0
    assert others.max() < 0.8
    mentioned = {e for ents in c.entities for e in ents}
    assert any(f"{n} {s}" in mentioned for n in names for s in VARIANT_SUFFIXES)


def test_questions_never_repeat():
    c = Corpus(3, SHAPE)
    stream = QuestionStream(c, 3)
    qs = stream.take(200) + stream.take(200)
    assert len(set(qs)) == 400
    assert all(q.startswith(("Tell me about ", "What connects ")) for q in qs)


def test_vectors_equal_the_ports_hashing_embedder():
    from hipporag_tpu_torch.config import BaseConfig
    from hipporag_tpu_torch.embedding.hashing import HashingNgramEmbeddingModel

    c = Corpus(5, SHAPE)
    texts = c.docs[:20] + [e.lower() for e in c.entities[0]] + ["", "Tell me about Kalo Vemi."]
    port = HashingNgramEmbeddingModel(BaseConfig(embedding_dim=256, embedding_model_name="hashing"))
    want = port._encode_batch(texts)
    got = embed_texts(texts, 256, "cpu").numpy()
    np.testing.assert_allclose(got, want, atol=2e-7)
    assert torch.all(torch.isfinite(torch.from_numpy(got)))
