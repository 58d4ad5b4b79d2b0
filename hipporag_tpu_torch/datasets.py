"""Experiment dataset loading.

Supports the reference's dataset layout (``<dir>/<name>_corpus.json`` +
``<dir>/<name>.json``) and its four gold-document schemas
(reference main.py:17-53): hotpotqa ``supporting_facts``/``context``,
musique-style ``paragraphs``, ``contexts`` with ``is_supporting``, and
popqa-style object fields for answers.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from .utils.logging import get_logger

logger = get_logger(__name__)


def get_gold_docs(samples: List[dict], dataset_name: Optional[str] = None) -> List[List[str]]:
    gold_docs = []
    for sample in samples:
        if "supporting_facts" in sample:
            gold_titles = {item[0] for item in sample["supporting_facts"]}
            supporting = [c for c in sample["context"] if c[0] in gold_titles]
            sep = "" if (dataset_name or "").startswith("hotpotqa") else " "
            docs = [title + "\n" + sep.join(sents) for title, sents in supporting]
        elif "contexts" in sample:
            docs = [
                c["title"] + "\n" + c["text"]
                for c in sample["contexts"]
                if c.get("is_supporting")
            ]
        elif "paragraphs" in sample:
            paragraphs = [p for p in sample["paragraphs"] if p.get("is_supporting", True)]
            docs = [
                p["title"] + "\n" + (p.get("text") or p["paragraph_text"])
                for p in paragraphs
            ]
        else:
            raise KeyError(
                "Sample has no supporting_facts/contexts/paragraphs; "
                "disable retrieval evaluation"
            )
        gold_docs.append(sorted(set(docs)))
    return gold_docs


def get_gold_answers(samples: List[dict]) -> List[List[str]]:
    gold_answers = []
    for sample in samples:
        if "answer" in sample or "gold_ans" in sample:
            answer = sample.get("answer", sample.get("gold_ans"))
        elif "reference" in sample:
            answer = sample["reference"]
        elif "obj" in sample:
            answer = [sample["obj"], sample.get("o_wiki_title", "")]
            for field in ("possible_answers", "o_aliases"):
                value = sample.get(field, [])
                answer.extend(value if isinstance(value, list) else [value])
        else:
            raise ValueError("Each query sample must contain an answer field")
        # QA datasets carry scalar answers of any JSON type (strings, but
        # also numbers or null) — normalize everything to strings instead
        # of crashing on set(1898) / set(None)
        if isinstance(answer, (list, tuple, set)):
            answers = {str(a) for a in answer if a is not None}
        elif answer is None:
            answers = set()
        else:
            answers = {str(answer)}
        answers.update(str(a) for a in sample.get("answer_aliases", []))
        gold_answers.append(sorted(answers))
    return gold_answers


def load_dataset(
    dataset_name: str, data_dir: str = "data"
) -> Tuple[List[str], List[str], Optional[List[List[str]]], List[List[str]]]:
    """Return (docs, queries, gold_docs_or_None, gold_answers)."""
    corpus_path = os.path.join(data_dir, f"{dataset_name}_corpus.json")
    samples_path = os.path.join(data_dir, f"{dataset_name}.json")
    with open(corpus_path) as f:
        corpus = json.load(f)
    if not os.path.exists(samples_path):
        # corpus-only dataset (e.g. the reference ships the 2wiki corpus but
        # its query file is stripped): synthesize deterministic 2-hop
        # queries from real title cross-references (evaluation/twiki.py)
        from .evaluation.twiki import synthesize_multihop_queries

        synth = synthesize_multihop_queries(corpus, max_queries=600)
        if not synth:
            raise FileNotFoundError(samples_path)
        logger.warning(
            "%s not found; synthesized %d deterministic 2-hop queries "
            "from corpus title cross-references", samples_path, len(synth)
        )
        docs = [f"{doc['title']}\n{doc['text']}" for doc in corpus]
        queries = [q for q, _, _ in synth]
        gold_docs = [g for _, g, _ in synth]
        gold_answers = [[bridge] for _, _, bridge in synth]
        return docs, queries, gold_docs, gold_answers
    with open(samples_path) as f:
        samples = json.load(f)

    docs = [f"{doc['title']}\n{doc['text']}" for doc in corpus]
    queries = [s["question"] for s in samples]
    gold_answers = get_gold_answers(samples)
    try:
        gold_docs = get_gold_docs(samples, dataset_name)
    except (KeyError, AssertionError):
        logger.warning("Retrieval evaluation disabled: no supporting docs in dataset")
        gold_docs = None
    return docs, queries, gold_docs, gold_answers
