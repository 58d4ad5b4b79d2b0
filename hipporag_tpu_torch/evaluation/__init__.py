from .eval_utils import normalize_answer
from .metrics import BaseMetric, QAExactMatch, QAF1Score, RetrievalRecall
from .stats import (
    bootstrap_delta_ci,
    mcnemar_exact,
    paired_retrieval_stats,
)

__all__ = [
    "BaseMetric",
    "QAExactMatch",
    "QAF1Score",
    "RetrievalRecall",
    "bootstrap_delta_ci",
    "mcnemar_exact",
    "normalize_answer",
    "paired_retrieval_stats",
]
