"""Shared graph-vs-dense evaluation scaffold (port's copy of
``hipporag_tpu/evaluation/harness.py``).

The quality harnesses run the same protocol on different inputs —
:mod:`.twiki` (synthetic 2wiki), :mod:`.hotpot_synth` (hotpotqa schema),
:mod:`.musique_synth` (musique schema), :mod:`.replay_quality` (real
extraction output replayed through the production provider path) — so the
index → warm → retrieve → dense → paired-stats flow lives here once.

Reference protocol this mirrors: HippoRAG.py:413-499 (Recall@k on
retrieve output) with the dense DPR baseline on the same index, plus the
paired error bars from :mod:`.stats` (this repo's addition).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

from ..utils.logging import get_logger

logger = get_logger(__name__)

RECALL_KS: Tuple[int, ...] = (1, 2, 5, 10, 20)
STATS_KS: Tuple[int, ...] = (2, 5, 20)


def graph_vs_dense_eval(
    rag,
    docs: Sequence[str],
    questions: List[str],
    gold_docs: List[List[str]],
    recall_ks: Tuple[int, ...] = RECALL_KS,
    stats_ks: Tuple[int, ...] = STATS_KS,
    warm: bool = True,
) -> Dict:
    """Index ``docs``, retrieve graph + dense on the SAME index, and
    return the common result dict every quality harness reports.

    ``warm=True`` runs one untimed batch first so ``retrieve_s`` reflects
    steady-state serving (retrieval-object prep, kernel builds and first
    launches are paid once in production).

    Returned keys: corpus_docs / num_queries / graph_nodes / graph_edges /
    index_s / retrieve_s / recall / dense_recall (dicts keyed by int k) /
    stats (:func:`.stats.paired_retrieval_stats` output), plus the raw
    ``results`` / ``dense_results`` solution lists for harness-specific
    post-processing (callers pop them before serializing).
    """
    from .stats import paired_retrieval_stats

    t0 = time.time()
    rag.index(list(docs))
    index_s = time.time() - t0
    info = rag.get_graph_info()
    logger.info("harness index: %.1fs, %s", index_s, info)

    if warm:
        warm_n = min(rag.global_config.ppr_batch_size, len(questions))
        rag.retrieve(questions[:warm_n])
    t0 = time.time()
    results, recall = rag.retrieve(questions, gold_docs=gold_docs)
    retrieve_s = time.time() - t0
    dense_results, dense_recall = rag.retrieve_dpr(
        questions, gold_docs=gold_docs
    )

    stats = paired_retrieval_stats(
        gold_docs,
        [r.docs for r in results],
        [r.docs for r in dense_results],
        k_list=stats_ks,
    )
    return {
        "corpus_docs": len(docs),
        "num_queries": len(questions),
        "graph_nodes": info["num_total_nodes"],
        "graph_edges": info["num_total_triples"],
        "index_s": round(index_s, 1),
        "retrieve_s": round(retrieve_s, 1),
        "recall": {k: recall[f"Recall@{k}"] for k in recall_ks},
        "dense_recall": {k: dense_recall[f"Recall@{k}"] for k in recall_ks},
        "stats": stats,
        "results": results,
        "dense_results": dense_results,
    }
