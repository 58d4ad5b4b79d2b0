"""Retrieval and QA metrics.

Functional parity with the reference evaluation layer:
- Recall@k over retrieved doc lists (evaluation/retrieval_eval.py:16-74).
- Exact-match and token-F1 with MRQA normalization, aggregated with ``max``
  over gold answers, 4-dp rounding of pooled results
  (evaluation/qa_eval.py:13-96).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import BaseConfig
from .eval_utils import normalize_answer


class BaseMetric:
    metric_name: str = "base"

    def __init__(self, global_config: Optional[BaseConfig] = None):
        self.global_config = global_config or BaseConfig()

    def calculate_metric_scores(self, *args, **kwargs):
        raise NotImplementedError


class RetrievalRecall(BaseMetric):
    metric_name = "retrieval_recall"

    def calculate_metric_scores(
        self,
        gold_docs: List[List[str]],
        retrieved_docs: List[List[str]],
        k_list: List[int] = (1, 5, 10, 20),
    ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
        k_list = sorted(set(k_list))
        example_results: List[Dict[str, float]] = []
        pooled = {f"Recall@{k}": 0.0 for k in k_list}

        for gold, retrieved in zip(gold_docs, retrieved_docs):
            gold_set = set(gold)
            row = {}
            for k in k_list:
                hit = set(retrieved[:k]) & gold_set
                row[f"Recall@{k}"] = len(hit) / len(gold_set) if gold_set else 0.0
            example_results.append(row)
            for k in k_list:
                pooled[f"Recall@{k}"] += row[f"Recall@{k}"]

        n = len(gold_docs)
        pooled = {key: round(v / n, 4) for key, v in pooled.items()} if n else pooled
        return pooled, example_results


class QAExactMatch(BaseMetric):
    metric_name = "qa_exact_match"

    def calculate_metric_scores(
        self,
        gold_answers: List[List[str]],
        predicted_answers: List[str],
        aggregation_fn: Callable = np.max,
    ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
        assert len(gold_answers) == len(predicted_answers)
        example_results = []
        total = 0.0
        for golds, pred in zip(gold_answers, predicted_answers):
            pred_norm = normalize_answer(pred)
            scores = [1.0 if normalize_answer(g) == pred_norm else 0.0 for g in golds]
            # a row with no gold answers scores 0 instead of crashing the
            # whole eval inside np.max on a zero-size array
            agg = float(aggregation_fn(scores)) if scores else 0.0
            example_results.append({"ExactMatch": agg})
            total += agg
        avg = total / len(gold_answers) if gold_answers else 0.0
        return {"ExactMatch": avg}, example_results


def _token_f1(gold: str, predicted: str) -> float:
    gold_tokens = normalize_answer(gold).split()
    pred_tokens = normalize_answer(predicted).split()
    common = Counter(pred_tokens) & Counter(gold_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gold_tokens)
    return 2 * precision * recall / (precision + recall)


class QAF1Score(BaseMetric):
    metric_name = "qa_f1_score"

    def calculate_metric_scores(
        self,
        gold_answers: List[List[str]],
        predicted_answers: List[str],
        aggregation_fn: Callable = np.max,
    ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
        assert len(gold_answers) == len(predicted_answers)
        example_results = []
        total = 0.0
        for golds, pred in zip(gold_answers, predicted_answers):
            scores = [_token_f1(g, pred) for g in golds]
            agg = float(aggregation_fn(scores)) if scores else 0.0
            example_results.append({"F1": agg})
            total += agg
        avg = total / len(gold_answers) if gold_answers else 0.0
        return {"F1": avg}, example_results
