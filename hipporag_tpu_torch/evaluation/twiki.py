"""Deterministic 2-hop queries from a corpus's title cross-references.

``load_dataset`` falls back to these when a dataset ships its corpus but
not its query file: passage A mentions passage B's title; the question
quotes A's opening (with the bridge mention removed) and asks about the
linked subject, so dense retrieval can find A but graph retrieval must hop
A -> bridge entity -> B. Gold = {A, B}.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def doc_text(item: Dict[str, str]) -> str:
    return f"{item['title']}\n{item['text']}"


def synthesize_multihop_queries(
    corpus: List[Dict[str, str]],
    max_queries: int = 600,
    min_title_len: int = 10,
) -> List[Tuple[str, List[str], str]]:
    """Deterministic 2-hop (question, gold_docs, bridge_title) triples.

    For passages A != B where A's text mentions B's title verbatim: the
    question is A's opening words with every bridge mention removed, plus a
    fixed connective suffix. One query per bridge title (first mention in
    corpus order), capped at ``max_queries``.
    """
    # first-word index over eligible titles keeps the scan near-linear
    # (a naive title x passage substring scan is ~40M checks on 6k docs)
    by_first_word: Dict[str, List[Tuple[str, int]]] = {}
    for i, item in enumerate(corpus):
        title = item["title"]
        if len(title) < min_title_len or " " not in title:
            continue
        by_first_word.setdefault(title.split()[0], []).append((title, i))

    queries: List[Tuple[str, List[str], str]] = []
    used_bridges = set()
    for a_idx, item in enumerate(corpus):
        text = item["text"]
        for word in dict.fromkeys(text.split()):
            for title, b_idx in by_first_word.get(word.strip(",.;:()'\""), ()):
                if (
                    b_idx == a_idx
                    or title in used_bridges
                    or title not in text
                    or title in item["title"]
                    or item["title"] in title
                ):
                    continue
                lead = text.replace(title, " ").split()
                question = (
                    " ".join(lead[:24])
                    + " — which subject is this connected to, and what is known about it?"
                )
                queries.append(
                    (question, [doc_text(item), doc_text(corpus[b_idx])], title)
                )
                used_bridges.add(title)
                if len(queries) >= max_queries:
                    return queries
    return queries
