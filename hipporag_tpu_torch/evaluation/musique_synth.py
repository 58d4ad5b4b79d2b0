"""Third-dataset quality harness: musique SCHEMA (``paragraphs``).

The port's copy of ``hipporag_tpu/evaluation/musique_synth.py``, driving the
port's ``HippoRAG`` on an explicit ``device``.

The quality story already runs through two of ``datasets.py``'s gold-doc
schema branches — hotpotqa ``supporting_facts``/``context``
(:mod:`.hotpot_synth`) and the corpus-only 2wiki synthesis
(:mod:`.twiki`). This module covers the third retrieval schema the
reference's experiment CLI handles (reference main.py:17-53): musique's
``paragraphs`` list, where each sample carries ~20 paragraphs and only
the ``is_supporting`` ones are gold. The distinctive behavior under test
is the loader's distractor FILTER: a bug that kept non-supporting
paragraphs (or dropped supporting ones) would silently corrupt Recall@k
denominators, and no other harness can see it because their schemas
carry gold docs only.

The same samples are also emitted in the ``contexts``/``is_supporting``
variant (2wiki's real released format, reference main.py:24-27) and the
two loader branches are asserted to reconstruct IDENTICAL gold documents
— so all three retrieval schema branches are exercised against each
other on every run.

Question phrasing is musique-like (a single compositional question whose
bridge mention is blanked from the surface), distinct from both the
2wiki connective and the hotpot bridge/comparison mix. Everything is
deterministic (mock OpenIE + hashing embedder, the r3 calibration
constants shared with the other synthetic harnesses).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from ..utils.logging import get_logger
from .twiki import load_corpus

logger = get_logger(__name__)

DATASET_NAME = "musique_synth"

# musique samples carry 20 paragraphs: the supporting ones plus
# distractors drawn from the same corpus
PARAGRAPHS_PER_SAMPLE = 20


def synthesize_musique_samples(
    corpus: List[Dict[str, str]], max_queries: int = 10**9
) -> List[dict]:
    """Deterministic musique-``paragraphs`` samples with distractors.

    Pair discovery reuses the 2wiki harness (A's text mentions B's title
    verbatim); each sample packs the two supporting paragraphs plus
    deterministic distractor paragraphs (``is_supporting: false``) up to
    :data:`PARAGRAPHS_PER_SAMPLE`, shuffled by a fixed stride so the
    supporting docs are not positionally first. Paragraph text uses
    musique's ``paragraph_text`` field name (exercising the loader's
    ``p.get("text") or p["paragraph_text"]`` fallback).
    """
    from .twiki import synthesize_multihop_queries

    by_title = {item["title"]: item for item in corpus}
    samples: List[dict] = []
    n = len(corpus)
    for qi, (_, gold, bridge) in enumerate(
        synthesize_multihop_queries(corpus, max_queries=max_queries)
    ):
        a_title = gold[0].split("\n", 1)[0]
        a_item = by_title.get(a_title)
        b_item = by_title.get(bridge)
        if a_item is None or b_item is None:
            continue

        # deterministic distractors: stride through the corpus from a
        # per-query offset, skipping the supporting titles
        distractors: List[Dict[str, str]] = []
        pos = (qi * 7919 + 13) % n
        # one full corpus cycle bounds the scan: candidates are deduped
        # by TITLE, so a corpus with duplicate titles can have fewer
        # than n-2 usable distractors — an unbounded while on the count
        # alone would spin forever skipping already-taken titles
        for _ in range(n):
            if len(distractors) >= PARAGRAPHS_PER_SAMPLE - 2:
                break
            cand = corpus[pos % n]
            pos += 1
            if cand["title"] in (a_item["title"], bridge):
                continue
            if any(d["title"] == cand["title"] for d in distractors):
                continue
            distractors.append(cand)

        items = [a_item, b_item] + distractors
        # fixed rotation so gold paragraphs land mid-list, like real
        # musique samples (position must not leak supportingness)
        rot = (qi * 5 + 3) % len(items)
        items = items[rot:] + items[:rot]
        paragraphs = [
            {
                "title": it["title"],
                "paragraph_text": it["text"],
                "is_supporting": it["title"] in (a_item["title"], bridge),
            }
            for it in items
        ]

        # compositional musique-like phrasing, bridge mention blanked
        lead = " ".join(a_item["text"].replace(bridge, " ").split()[:20])
        samples.append(
            {
                "question": (
                    f'Regarding the subject referenced by the passage "'
                    f'{lead}", what further information does the corpus '
                    "give about it?"
                ),
                "answer": bridge,
                "paragraphs": paragraphs,
            }
        )
        if len(samples) >= max_queries:
            break
    return samples


def to_contexts_schema(sample: dict) -> dict:
    """The same sample in the ``contexts``/``is_supporting`` schema
    (2wiki's released format) for the loader cross-check."""
    return {
        "question": sample["question"],
        "answer": sample["answer"],
        "contexts": [
            {
                "title": p["title"],
                "text": p["paragraph_text"],
                "is_supporting": p["is_supporting"],
            }
            for p in sample["paragraphs"]
        ],
    }


def write_musique_files(
    corpus: List[Dict[str, str]], samples: List[dict], out_dir: str
) -> str:
    """Write ``<out_dir>/musique_synth{_corpus,}.json``; returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{DATASET_NAME}_corpus.json"), "w") as f:
        json.dump(corpus, f)
    with open(os.path.join(out_dir, f"{DATASET_NAME}.json"), "w") as f:
        json.dump(samples, f)
    return out_dir


def run_musique_eval(
    corpus_path: str,
    save_dir: str,
    n_docs: int | None = None,
    n_queries: int = 0,
    top_k: int = 20,
    config_overrides: Dict | None = None,
    device="cuda",
) -> Dict:
    """Synthesize, write, LOAD THROUGH datasets.py's ``paragraphs``
    branch, cross-check the ``contexts`` branch, index, and compare graph
    vs dense with paired stats. ``n_queries=0`` = every synthesizable
    sample."""
    from ..config import BaseConfig
    from ..datasets import get_gold_docs, load_dataset
    from ..hipporag import HippoRAG
    from .harness import graph_vs_dense_eval

    corpus = load_corpus(corpus_path)
    if n_docs:
        corpus = corpus[:n_docs]
    samples = synthesize_musique_samples(
        corpus, max_queries=n_queries or 10**9
    )
    if not samples:
        raise ValueError("no musique-schema samples could be synthesized")
    data_dir = os.path.join(save_dir, "musique_data")
    write_musique_files(corpus, samples, data_dir)

    # the production loader path: musique `paragraphs` branch
    docs, questions, gold_docs, _gold_answers = load_dataset(
        DATASET_NAME, data_dir
    )
    assert gold_docs is not None

    # the distractor filter IS the behavior under test: every query must
    # reconstruct exactly its two supporting docs, all present in the
    # indexed corpus, none of the distractors
    doc_set = set(docs)
    for g in gold_docs:
        if len(g) != 2:
            raise AssertionError(
                f"paragraphs branch kept {len(g)} docs (expected the 2 "
                "supporting ones) — distractor filter broken"
            )
        missing = [d for d in g if d not in doc_set]
        if missing:
            raise AssertionError(
                f"gold doc not reconstructible from corpus: {missing[0][:80]!r}"
            )

    # contexts-schema cross-check: the 2wiki released format must
    # reconstruct the SAME gold docs from the same samples
    ctx_gold = get_gold_docs(
        [to_contexts_schema(s) for s in samples], DATASET_NAME
    )
    if ctx_gold != gold_docs:
        raise AssertionError(
            "contexts and paragraphs loader branches disagree on gold docs"
        )

    cfg_kw = dict(
        llm_name="mock",
        embedding_model_name="hashing",
        save_dir=save_dir,
        embedding_dim=1024,
        retrieval_top_k=top_k,
        embedding_batch_size=256,
        dataset=None,
        # r3-swept harness calibration, shared with twiki.run_2wiki_eval
        passage_node_weight=0.1,
        linking_top_k=3,
    )
    cfg_kw.update(config_overrides or {})
    rag = HippoRAG(global_config=BaseConfig(**cfg_kw), device=device)

    out = graph_vs_dense_eval(rag, docs, questions, gold_docs)
    out.pop("results")
    out.pop("dense_results")
    out["distractors_per_query"] = PARAGRAPHS_PER_SAMPLE - 2
    out["schemas_cross_checked"] = ["paragraphs", "contexts"]
    logger.info("musique-schema eval: %s", out)
    return out
