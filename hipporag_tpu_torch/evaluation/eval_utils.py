"""Answer normalization for QA metrics.

Bit-identical contract to the MRQA-style normalization used by the reference
(utils/eval_utils.py:4-31): lowercase → strip punctuation → drop articles
(a/an/the) → collapse whitespace.
"""

from __future__ import annotations

import re
import string

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def normalize_answer(answer: str) -> str:
    text = answer.lower()
    text = "".join(ch for ch in text if ch not in _PUNCT)
    text = _ARTICLES.sub(" ", text)
    return " ".join(text.split())
