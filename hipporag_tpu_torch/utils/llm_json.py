"""Robust parsing of LLM JSON output.

Replaces the reference's regex + ``eval`` extraction (a security trap flagged
in SURVEY.md §7: reference openie_openai.py:30-36, 88) with ``json`` /
``ast.literal_eval``-free safe decoding, and re-implements truncated-JSON
repair (reference contract: utils/llm_utils.py:150-219).
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Optional


def repair_truncated_json(json_str: str) -> str:
    """Best-effort repair of a truncated/malformed JSON string.

    If the string already parses, it is returned unchanged. Otherwise the
    trailing partial element (after the last comma) is dropped and any
    unclosed braces/brackets — tracked outside string literals — are closed.
    """
    try:
        json.loads(json_str)
        return json_str
    except json.JSONDecodeError:
        pass

    last_comma = json_str.rfind(",")
    if last_comma != -1:
        json_str = json_str[:last_comma]

    unclosed: List[str] = []
    in_string = False
    escaped = False
    for ch in json_str:
        if in_string:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == '"':
                in_string = False
        else:
            if ch == '"':
                in_string = True
            elif ch in "{[":
                unclosed.append(ch)
            elif ch in "}]":
                if unclosed and (
                    (ch == "}" and unclosed[-1] == "{")
                    or (ch == "]" and unclosed[-1] == "[")
                ):
                    unclosed.pop()

    closing = {"{": "}", "[": "]"}
    for opener in reversed(unclosed):
        json_str += closing[opener]
    return json_str


_OBJECT_RE = re.compile(r"\{.*\}", re.DOTALL)


def extract_json_dict(text: str) -> Optional[dict]:
    """Extract the first top-level JSON object embedded in ``text`` safely."""
    if not text:
        return None
    # Fast path: the whole response is JSON.
    for candidate in (text, text.strip()):
        try:
            obj = json.loads(candidate)
            if isinstance(obj, dict):
                return obj
        except json.JSONDecodeError:
            break
    match = _OBJECT_RE.search(text)
    if match is None:
        return None
    fragment = match.group()
    try:
        obj = json.loads(fragment)
    except json.JSONDecodeError:
        try:
            obj = json.loads(repair_truncated_json(fragment))
        except json.JSONDecodeError:
            return None
    return obj if isinstance(obj, dict) else None


def extract_field_list(text: str, field: str) -> List[Any]:
    """Extract ``{field: [...]}`` from an LLM response; [] if absent/broken."""
    obj = extract_json_dict(text)
    if obj is None:
        return []
    value = obj.get(field, [])
    return value if isinstance(value, list) else []


def extract_named_entities(text: str) -> List[str]:
    """Parse a NER response of the form ``{"named_entities": [...]}``."""
    raw = extract_field_list(text, "named_entities")
    return [str(e) for e in raw if isinstance(e, (str, int, float))]


def extract_triples(text: str) -> List[List[str]]:
    """Parse an RE response of the form ``{"triples": [[s, p, o], ...]}``."""
    raw = extract_field_list(text, "triples")
    return [t for t in raw if isinstance(t, list)]


# ----------------------------------------------------------------------
# Guided-decoding schemas (reference: utils/llm_utils.py:257-436 — JSON
# templates + pydantic twins used by the offline engines)
# ----------------------------------------------------------------------
PROMPT_JSON_TEMPLATE = {
    "ner": {
        "type": "object",
        "properties": {
            "named_entities": {"type": "array", "items": {"type": "string"}}
        },
        "required": ["named_entities"],
    },
    "triples": {
        "type": "object",
        "properties": {
            "triples": {
                "type": "array",
                "items": {
                    "type": "array",
                    "items": {"type": "string"},
                    "minItems": 3,
                    "maxItems": 3,
                },
            }
        },
        "required": ["triples"],
    },
    "fact": {
        "type": "object",
        "properties": {
            "fact": {
                "type": "array",
                "items": {
                    "type": "array",
                    "items": {"type": "string"},
                    "minItems": 3,
                    "maxItems": 3,
                },
            }
        },
        "required": ["fact"],
    },
}

try:  # pydantic twins for engines that take model classes
    from typing import List as _List

    from pydantic import BaseModel as _BaseModel

    class NerResponse(_BaseModel):
        named_entities: _List[str]

    class TriplesResponse(_BaseModel):
        triples: _List[_List[str]]

    class Fact(_BaseModel):
        """A filtered fact list (reference rerank.py:11-12)."""

        fact: _List[_List[str]]

except ImportError:  # pragma: no cover - env without pydantic
    NerResponse = TriplesResponse = Fact = None


def num_tokens(text: str, encoder_name: str = "gpt-4o") -> int:
    """Token count helper (reference: utils/llm_utils.py:329-333).

    Falls back to a whitespace count when the tiktoken vocab cannot be
    loaded (offline environments).
    """
    try:
        import tiktoken

        try:
            enc = tiktoken.encoding_for_model(encoder_name)
        except KeyError:
            enc = tiktoken.get_encoding("cl100k_base")
        return len(enc.encode(text))
    except Exception:  # noqa: BLE001
        return len(text.split())
