"""Paired significance statistics for retrieval-quality comparisons.

VERDICT r3 #2: the 2wiki graph-vs-dense Recall@2 gap (0.34pp on 600
queries) was narrated as a win while being statistically indistinguishable
from a tie. This module provides the error bars so bench.py can report
honestly:

- **Doc-level paired hits**: every (query, gold doc) pair is one Bernoulli
  trial — "was this gold doc retrieved in the top-k?". When every query has
  the same number of gold docs (2wiki: always 2), the mean over trials
  equals the pooled Recall@k exactly, so tests on these trials are tests on
  the reported metric.
- **Exact McNemar**: paired binomial test on the discordant trials
  (graph-only hits vs dense-only hits). Exact (scipy binomtest), not the
  chi-square approximation — discordant counts can be small.
- **Cluster bootstrap CI**: queries are resampled (not doc trials — the 2
  trials within a query share the question and are correlated), and the
  percentile interval of the mean per-query recall difference is returned.

Reference analog: the upstream repo reports point recall only
(HippoRAG.py:493, main.py:107-111); the error bars are this repo's
addition so small deltas are never over-claimed.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def doc_level_hits(
    gold_docs: Sequence[Sequence[str]],
    retrieved_docs: Sequence[Sequence[str]],
    k: int,
) -> np.ndarray:
    """Boolean [n_trials] array over (query, gold doc) pairs, in query
    order: True iff that gold doc appears in the query's top-k."""
    hits: List[bool] = []
    for gold, retrieved in zip(gold_docs, retrieved_docs):
        topk = set(retrieved[:k])
        for g in gold:
            hits.append(g in topk)
    return np.asarray(hits, dtype=bool)


def per_query_recall(
    gold_docs: Sequence[Sequence[str]],
    retrieved_docs: Sequence[Sequence[str]],
    k: int,
) -> np.ndarray:
    """Per-query Recall@k fractions (|gold ∩ top-k| / |gold|)."""
    out = np.zeros(len(gold_docs), dtype=np.float64)
    for i, (gold, retrieved) in enumerate(zip(gold_docs, retrieved_docs)):
        gold_set = set(gold)
        if gold_set:
            out[i] = len(set(retrieved[:k]) & gold_set) / len(gold_set)
    return out


def mcnemar_exact(a_hits: np.ndarray, b_hits: np.ndarray) -> Dict:
    """Exact two-sided McNemar test on paired boolean outcomes.

    Returns the p-value plus the discordant counts: ``a_only`` trials where
    A hit and B missed, ``b_only`` the reverse. Under H0 (no difference)
    each discordant trial is a fair coin; the p-value is the exact
    two-sided binomial tail.
    """
    a_hits = np.asarray(a_hits, dtype=bool)
    b_hits = np.asarray(b_hits, dtype=bool)
    if a_hits.shape != b_hits.shape:
        raise ValueError(f"paired shapes differ: {a_hits.shape} vs {b_hits.shape}")
    a_only = int(np.sum(a_hits & ~b_hits))
    b_only = int(np.sum(~a_hits & b_hits))
    n_disc = a_only + b_only
    if n_disc == 0:
        p = 1.0
    else:
        from scipy.stats import binomtest

        p = float(binomtest(a_only, n_disc, 0.5, alternative="two-sided").pvalue)
    return {
        "p_value": p,
        "a_only": a_only,
        "b_only": b_only,
        "n_discordant": n_disc,
        "n_trials": int(a_hits.size),
    }


def bootstrap_delta_ci(
    per_query_a: np.ndarray,
    per_query_b: np.ndarray,
    n_boot: int = 10_000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Dict:
    """Percentile bootstrap CI for mean(A) - mean(B), resampling QUERIES.

    Cluster bootstrap: the resampling unit is the query (its paired
    difference), never individual doc trials, so within-query correlation
    is preserved. Deterministic for a fixed seed.
    """
    a = np.asarray(per_query_a, dtype=np.float64)
    b = np.asarray(per_query_b, dtype=np.float64)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"paired 1-d arrays required: {a.shape} vs {b.shape}")
    d = a - b
    n = d.size
    if n == 0:
        raise ValueError("empty sample")
    rng = np.random.default_rng(seed)
    # chunk the resample matrix so n_boot x n never materializes at once
    # for large query sets (10k x 100k would be 8GB of int64)
    means = np.empty(n_boot, dtype=np.float64)
    chunk = max(1, min(n_boot, 50_000_000 // max(n, 1)))
    for start in range(0, n_boot, chunk):
        stop = min(start + chunk, n_boot)
        idx = rng.integers(0, n, size=(stop - start, n))
        means[start:stop] = d[idx].mean(axis=1)
    lo, hi = np.percentile(means, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return {
        "delta": float(d.mean()),
        "ci_low": float(lo),
        "ci_high": float(hi),
        "alpha": alpha,
        "n_queries": int(n),
        "n_boot": int(n_boot),
    }


def paired_retrieval_stats(
    gold_docs: Sequence[Sequence[str]],
    docs_a: Sequence[Sequence[str]],
    docs_b: Sequence[Sequence[str]],
    k_list: Tuple[int, ...] = (2, 5, 20),
    n_boot: int = 10_000,
    seed: int = 0,
) -> Dict[int, Dict]:
    """Full A-vs-B comparison at each k: recall delta with a 95% cluster
    bootstrap CI plus an exact McNemar p-value on doc-level hits.

    ``significant`` is True when the McNemar p < 0.05 — i.e. the paired
    evidence distinguishes the two systems at that k.
    """
    out: Dict[int, Dict] = {}
    for k in k_list:
        ha = doc_level_hits(gold_docs, docs_a, k)
        hb = doc_level_hits(gold_docs, docs_b, k)
        mc = mcnemar_exact(ha, hb)
        ci = bootstrap_delta_ci(
            per_query_recall(gold_docs, docs_a, k),
            per_query_recall(gold_docs, docs_b, k),
            n_boot=n_boot,
            seed=seed + k,
        )
        out[k] = {
            "recall_a": round(float(ha.mean()), 4),
            "recall_b": round(float(hb.mean()), 4),
            "delta": round(ci["delta"], 4),
            "ci95": [round(ci["ci_low"], 4), round(ci["ci_high"], 4)],
            "mcnemar_p": round(mc["p_value"], 6),
            "a_only": mc["a_only"],
            "b_only": mc["b_only"],
            "significant": mc["p_value"] < 0.05,
        }
    return out
