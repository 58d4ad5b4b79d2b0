"""Deterministic mock LLM for offline tests.

The reference has no LLM fake (SURVEY.md §4 calls this out as a gap we must
fill). This mock recognizes each prompt family by its structure and produces
deterministic, well-formed responses:

- NER        → ``{"named_entities": [...]}`` via capitalized-phrase heuristic
- Triple RE  → ``{"triples": [[s, p, o], ...]}`` linking co-sentence entities
- Fact filter→ ``[[ ## fact_after_filter ## ]]`` keeping facts overlapping
               the question's tokens
- RAG QA     → ``Thought: ... Answer: <span>`` from the top passage

Canned responses can be injected for exact parity tests.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from .base import BaseLLM, TextChatMessage

_CAP_PHRASE = re.compile(
    r"(?:[A-Z][\w'’.-]*(?:\s+(?:of|the|de|la|van|von)\s+[A-Z][\w'’.-]*|\s+[A-Z][\w'’.-]*)*)|\d{4}"
)
# newlines are sentence boundaries too: passages commonly lead with a bare
# title line ("Lothair II\nLothair II (835...) was king..."), and without
# the split the title merges into the next sentence's first capitalized
# phrase ("Lothair II Lothair II (...)"), so the title entity — the bridge
# node multi-hop retrieval hops through — never gets extracted cleanly
_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+|\n+")


# Sentence-initial function words and pronouns capitalize without naming
# anything; a real NER never emits them. Left in, they become giant hub
# nodes ("She", "It", "In November ...") that leak PPR mass corpus-wide.
_NON_ENTITY = frozenset(
    "a an as at and but by for from in into it its he her his him she they "
    "them their this these those that there then thus to of on or over so "
    "when where which while who whom whose with we you i not no after "
    "before during however meanwhile although though also both each ".split()
)


def _strip_leading_stopwords(phrase: str) -> str:
    words = phrase.split()
    while words and words[0].lower() in _NON_ENTITY:
        words = words[1:]
    return " ".join(words)


def extract_capitalized_entities(text: str) -> List[str]:
    ents: List[str] = []
    for sent in _SENT_SPLIT.split(text):
        for m in _CAP_PHRASE.finditer(sent):
            phrase = _strip_leading_stopwords(m.group().strip(".,;:- "))
            if len(phrase) < 2:
                continue
            ents.append(phrase)
    # dedup preserving order
    return list(dict.fromkeys(ents))


def _mock_triples(text: str) -> List[List[str]]:
    triples: List[List[str]] = []
    for sent in _SENT_SPLIT.split(text):
        ents = extract_capitalized_entities(sent)
        if len(ents) < 2:
            continue
        head = ents[0]
        for other in ents[1:]:
            triples.append([head, "is associated with", other])
    return triples


class MockLLM(BaseLLM):
    """Structure-aware deterministic responder."""

    def __init__(self, global_config=None, canned: Optional[Dict[str, str]] = None):
        super().__init__(global_config)
        self.canned = canned or {}
        self.call_log: List[Dict[str, Any]] = []

    # -- prompt family detection ------------------------------------------
    @staticmethod
    def _last_user(messages: List[TextChatMessage]) -> str:
        for msg in reversed(messages):
            if msg["role"] == "user":
                return msg["content"]
        return ""

    def infer(
        self, messages: List[TextChatMessage], **kwargs
    ) -> Tuple[str, Dict[str, Any], bool]:
        user = self._last_user(messages)
        system = messages[0]["content"] if messages and messages[0]["role"] == "system" else ""
        self.call_log.append({"messages": messages})

        for trigger, response in self.canned.items():
            if trigger in user:
                return response, self._meta(response), False

        if "[[ ## question ## ]]" in user:
            content = self._filter_response(user)
        elif '"triples"' in user or "triple list" in user or "knowledge graph" in system.lower():
            content = self._triples_response(user)
        elif "named entities" in system.lower() or "entity extraction" in system.lower() or "Question:" in user and "named entities" in user:
            content = self._ner_response(user)
        elif "Thought:" in user or "reading comprehension" in system.lower():
            content = self._qa_response(user)
        else:
            content = self._ner_response(user)

        return content, self._meta(content), False

    @staticmethod
    def _meta(content: str) -> Dict[str, Any]:
        return {
            "prompt_tokens": 0,
            "completion_tokens": len(content.split()),
            "finish_reason": "stop",
        }

    # -- responders --------------------------------------------------------
    def _ner_response(self, user: str) -> str:
        text = user.split("Question:", 1)[-1] if "Question:" in user else user
        return json.dumps({"named_entities": extract_capitalized_entities(text)})

    def _triples_response(self, user: str) -> str:
        # Passage is fenced in triple backticks by the RE prompt.
        m = re.search(r"```\n(.*?)\n```", user, re.DOTALL)
        passage = m.group(1) if m else user
        return json.dumps({"triples": _mock_triples(passage)})

    def _filter_response(self, user: str) -> str:
        qm = re.search(r"\[\[ ## question ## \]\]\n(.*?)\n\n", user, re.DOTALL)
        fm = re.search(r"\[\[ ## fact_before_filter ## \]\]\n(.*?)\n\n", user, re.DOTALL)
        question = qm.group(1) if qm else ""
        q_tokens = set(re.findall(r"[a-z0-9]+", question.lower()))
        try:
            facts = json.loads(fm.group(1))["fact"] if fm else []
        except (json.JSONDecodeError, KeyError):
            facts = []
        kept = []
        for fact in facts:
            fact_tokens = set(re.findall(r"[a-z0-9]+", " ".join(map(str, fact)).lower()))
            if q_tokens & fact_tokens:
                kept.append(fact)
        if not kept:
            kept = facts
        body = json.dumps({"fact": kept})
        return f"[[ ## fact_after_filter ## ]]\n{body}\n\n[[ ## completed ## ]]"

    def _qa_response(self, user: str) -> str:
        q = re.findall(r"Question:\s*(.*)", user)
        question = q[-1].strip() if q else ""
        q_tokens = set(re.findall(r"[a-z0-9]+", question.lower()))
        best_span = ""
        best_overlap = -1
        for sent in _SENT_SPLIT.split(user):
            tokens = set(re.findall(r"[a-z0-9]+", sent.lower()))
            overlap = len(tokens & q_tokens)
            if overlap > best_overlap and "Question:" not in sent:
                best_overlap = overlap
                best_span = sent.strip()
        ents = extract_capitalized_entities(best_span)
        answer = ents[-1] if ents else (best_span.split()[-1] if best_span else "unknown")
        return f"Thought: The passage states {best_span!r}. \nAnswer: {answer}"
