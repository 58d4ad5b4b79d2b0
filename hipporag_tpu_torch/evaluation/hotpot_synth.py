"""Second-dataset quality harness: hotpotqa SCHEMA.

The port's copy of ``hipporag_tpu/evaluation/hotpot_synth.py``, driving the
port's ``HippoRAG`` on an explicit ``device``.

The 2wiki harness (:mod:`.twiki`) measures quality on one dataset shape.
This module synthesizes a hotpotqa-format dataset — ``supporting_facts``
+ ``context`` sentence lists, the schema of reference main.py:17-32 —
writes it to disk, and loads it back through :func:`..datasets.load_dataset`
so the gold documents are reconstructed by the production
``get_gold_docs`` supporting-facts branch (title + ``"".join(sents)``,
hotpotqa's empty sentence separator). Score semantics overfit to the
2wiki shape would surface here.

The question mix is also hotpot-like, not a clone of the 2wiki harness:

- **bridge** questions: passage A mentions B's title; the question quotes
  A's lead with every bridge mention removed (dense retrieval lacks the
  hop), phrased differently from the 2wiki connective.
- **comparison** questions: both titles appear in the question ("Considering
  X and Y, ...") — the easy 2-doc case where graph retrieval must not LOSE
  to dense (the overfit check runs in both directions).

Everything is deterministic (mock OpenIE + hashing embedder, the r3
calibraton constants shared with the 2wiki harness).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

from ..utils.logging import get_logger
from .twiki import load_corpus

logger = get_logger(__name__)

DATASET_NAME = "hotpotqa_synth"


def split_sentences(text: str) -> List[str]:
    """Sentence pieces with EXACT reconstruction: ``"".join(out) == text``.

    get_gold_docs rebuilds each gold document as ``title + "\\n" +
    "".join(sents)`` (hotpotqa separator is empty) and Recall@k matches
    retrieved docs by string equality against the indexed corpus text —
    so the split must lose nothing, not even whitespace.
    """
    out, start = [], 0
    for m in re.finditer(r"[.!?]+\s+", text):
        out.append(text[start:m.end()])
        start = m.end()
    if start < len(text):
        out.append(text[start:])
    return out or [text]


def synthesize_hotpot_samples(
    corpus: List[Dict[str, str]], max_queries: int = 10**9
) -> List[dict]:
    """Deterministic hotpotqa-schema samples (bridge + comparison mix).

    Bridge pairs reuse the 2wiki harness's title-cross-reference discovery
    (A's text mentions B's title verbatim); comparison questions pair the
    same two documents but NAME both titles, hotpot's second question
    type. One bridge sample and one comparison sample per discovered pair,
    interleaved, capped at ``max_queries``.
    """
    from .twiki import synthesize_multihop_queries

    pairs = []  # (a_item, b_item, bridge_title)
    by_title = {item["title"]: item for item in corpus}
    for question, gold, bridge in synthesize_multihop_queries(
        corpus, max_queries=(max_queries + 1) // 2
    ):
        # recover the A item from the gold pair (gold[0] is doc_text(A))
        a_title = gold[0].split("\n", 1)[0]
        a_item = by_title.get(a_title)
        b_item = by_title.get(bridge)
        if a_item is None or b_item is None:
            continue
        pairs.append((a_item, b_item, bridge))

    samples: List[dict] = []
    for a_item, b_item, bridge in pairs:
        ctx = [
            [a_item["title"], split_sentences(a_item["text"])],
            [b_item["title"], split_sentences(b_item["text"])],
        ]
        sup = [[a_item["title"], 0], [b_item["title"], 0]]
        # bridge phrasing (distinct from the 2wiki connective): lead words
        # of A with the bridge mention blanked
        lead = a_item["text"].replace(bridge, " ").split()
        samples.append(
            {
                "question": (
                    "A passage opens: \"" + " ".join(lead[:20])
                    + "\" — identify the related subject and what is said about it."
                ),
                "answer": bridge,
                "supporting_facts": sup,
                "context": ctx,
                "type": "bridge",
            }
        )
        if len(samples) >= max_queries:
            break
        # comparison phrasing: both titles named (hotpot's second type)
        samples.append(
            {
                "question": (
                    f"Considering {a_item['title']} and {bridge}, "
                    "what connects these two subjects?"
                ),
                "answer": bridge,
                "supporting_facts": sup,
                "context": ctx,
                "type": "comparison",
            }
        )
        if len(samples) >= max_queries:
            break
    return samples


def write_hotpot_files(
    corpus: List[Dict[str, str]], samples: List[dict], out_dir: str
) -> str:
    """Write ``<out_dir>/hotpotqa_synth{_corpus,}.json``; returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    # corpus text must reconstruct from the context sentences exactly
    with open(os.path.join(out_dir, f"{DATASET_NAME}_corpus.json"), "w") as f:
        json.dump(corpus, f)
    with open(os.path.join(out_dir, f"{DATASET_NAME}.json"), "w") as f:
        json.dump(samples, f)
    return out_dir


def run_hotpot_eval(
    corpus_path: str,
    save_dir: str,
    n_docs: int | None = None,
    n_queries: int = 0,
    top_k: int = 20,
    config_overrides: Dict | None = None,
    device="cuda",
) -> Dict:
    """Synthesize, write, LOAD THROUGH datasets.py, index, and compare
    graph vs dense with paired stats — the 2wiki protocol on the second
    dataset schema. ``n_queries=0`` = every synthesizable sample."""
    from ..config import BaseConfig
    from ..datasets import load_dataset
    from ..hipporag import HippoRAG
    from .harness import graph_vs_dense_eval

    corpus = load_corpus(corpus_path)
    if n_docs:
        corpus = corpus[:n_docs]
    samples = synthesize_hotpot_samples(corpus, max_queries=n_queries or 10**9)
    if not samples:
        raise ValueError("no hotpot-schema samples could be synthesized")
    data_dir = os.path.join(save_dir, "hotpot_data")
    write_hotpot_files(corpus, samples, data_dir)

    # the production loader path: hotpotqa supporting_facts branch
    docs, questions, gold_docs, _gold_answers = load_dataset(
        DATASET_NAME, data_dir
    )
    assert gold_docs is not None
    types = [s["type"] for s in samples]

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
    results = out.pop("results")
    dense_results = out.pop("dense_results")

    # per-question-type recall (bridge must win on graph; comparison must
    # not lose) at k=5. per_query_recall is one value PER QUERY, so the
    # question-type index selects the right rows; doc_level_hits would be
    # one value per (query, gold doc) PAIR — 2n entries — and indexing it
    # with query indices scrambles the split (regression-pinned in
    # tests/test_hotpot_harness.py).
    from .stats import per_query_recall

    rec_g = per_query_recall(gold_docs, [r.docs for r in results], 5)
    rec_d = per_query_recall(gold_docs, [r.docs for r in dense_results], 5)
    by_type: Dict[str, Dict[str, float]] = {}
    for t in ("bridge", "comparison"):
        idx = [i for i, tt in enumerate(types) if tt == t]
        if idx:
            by_type[t] = {
                "graph_r5": round(float(rec_g[idx].mean()), 4),
                "dense_r5": round(float(rec_d[idx].mean()), 4),
                "n": len(idx),
            }

    out["by_type"] = by_type
    logger.info("hotpot-schema eval: %s", out)
    return out
