"""Core dataclasses and small host-side utilities.

Functional parity targets (reference: src/hipporag/utils/misc_utils.py):
- ``compute_mdhash_id`` (misc_utils.py:141-152) — content addressing.
- ``text_processing`` (misc_utils.py:80-85) — phrase canonicalization.
- ``min_max_normalize`` (misc_utils.py:130-139) — per-query score scaling.
- output dataclasses (misc_utils.py:15-77).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from hashlib import md5
from typing import Any, Dict, List, Literal, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Content addressing
# --------------------------------------------------------------------------

def compute_mdhash_id(content: str, prefix: str = "") -> str:
    """MD5 content hash with a namespace prefix (e.g. ``entity-``/``chunk-``)."""
    return prefix + md5(content.encode()).hexdigest()


_NON_ALNUM = re.compile(r"[^A-Za-z0-9 ]")


def text_processing(text):
    """Lowercase and strip non-alphanumeric characters (phrase canonical form)."""
    if isinstance(text, list):
        return [text_processing(t) for t in text]
    if not isinstance(text, str):
        text = str(text)
    return _NON_ALNUM.sub(" ", text.lower()).strip()


def min_max_normalize(x: np.ndarray) -> np.ndarray:
    """Scale to [0, 1]; a constant vector maps to all-ones."""
    x = np.asarray(x)
    lo, hi = np.min(x), np.max(x)
    if hi - lo == 0:
        return np.ones_like(x)
    return (x - lo) / (hi - lo)


def string_to_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"Cannot interpret {v!r} as a boolean")


# --------------------------------------------------------------------------
# Dataclasses
# --------------------------------------------------------------------------

Triple = Tuple[str, str, str]


@dataclass
class NerRawOutput:
    chunk_id: str
    response: Optional[str]
    unique_entities: List[str]
    metadata: Dict[str, Any]


@dataclass
class TripleRawOutput:
    chunk_id: str
    response: Optional[str]
    triples: List[List[str]]
    metadata: Dict[str, Any]


@dataclass
class LinkingOutput:
    score: np.ndarray
    type: Literal["node", "dpr"]


@dataclass(frozen=True)
class Chunk:
    """A text chunk plus source metadata, before indexing."""

    content: str
    source_id: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RetrievalResult:
    """Result of one retrieval query."""

    query: str
    docs: List[str]
    scores: np.ndarray
    doc_metadata: List[Dict[str, Any]] = field(default_factory=list)
    graph_seeds: List[Tuple] = field(default_factory=list)


@dataclass
class QuerySolution:
    question: str
    docs: List[str]
    doc_scores: Optional[np.ndarray] = None
    answer: Optional[str] = None
    gold_answers: Optional[List[str]] = None
    gold_docs: Optional[List[str]] = None
    thoughts: Optional[List[str]] = None
    doc_metadata: Optional[List[Dict[str, Any]]] = None
    graph_seeds: Optional[List[Tuple]] = None

    def to_dict(self):
        result = {
            "question": self.question,
            "answer": self.answer,
            "gold_answers": self.gold_answers,
            "docs": self.docs[:5],
            "doc_scores": (
                [round(v, 4) for v in self.doc_scores.tolist()[:5]]
                if self.doc_scores is not None
                else None
            ),
            "gold_docs": self.gold_docs,
            "doc_metadata": (
                self.doc_metadata[:5] if self.doc_metadata is not None else None
            ),
            "graph_seeds": self.graph_seeds,
        }
        if self.thoughts is not None:
            result["thoughts"] = self.thoughts
        return result


# --------------------------------------------------------------------------
# OpenIE post-processing
# --------------------------------------------------------------------------

def filter_invalid_triples(triples: List[List[Any]]) -> List[List[str]]:
    """Keep only well-formed, unique [s, p, o] triples, preserving order.

    (reference contract: utils/llm_utils.py:222-254)
    """
    seen = set()
    out: List[List[str]] = []
    for t in triples:
        if len(t) != 3:
            continue
        st = [str(x) for x in t]
        key = tuple(st)
        if key not in seen:
            seen.add(key)
            out.append(st)
    return out


def extract_entity_nodes(
    chunk_triples: List[List[Triple]],
) -> Tuple[List[str], List[List[str]]]:
    """Unique entity phrases globally and per chunk (misc_utils.py:110-121)."""
    per_chunk: List[List[str]] = []
    for triples in chunk_triples:
        ents = set()
        for t in triples:
            if len(t) == 3:
                ents.update([t[0], t[2]])
        per_chunk.append(list(ents))
    all_nodes = sorted({e for ents in per_chunk for e in ents})
    return all_nodes, per_chunk


def flatten_facts(chunk_triples: List[List[Triple]]) -> List[Triple]:
    """Unique relation triples (as tuples) across all chunks."""
    seen = set()
    out: List[Triple] = []
    for triples in chunk_triples:
        for t in triples:
            tt = tuple(t)
            if tt not in seen:
                seen.add(tt)
                out.append(tt)
    return out


def reformat_openie_results(corpus_openie_results):
    """Re-hydrate saved OpenIE JSON rows into typed outputs."""
    ner = {
        item["idx"]: NerRawOutput(
            chunk_id=item["idx"],
            response=None,
            metadata={},
            unique_entities=sorted(set(item["extracted_entities"])),
        )
        for item in corpus_openie_results
    }
    triples = {
        item["idx"]: TripleRawOutput(
            chunk_id=item["idx"],
            response=None,
            metadata={},
            triples=filter_invalid_triples(item["extracted_triples"]),
        )
        for item in corpus_openie_results
    }
    return ner, triples
