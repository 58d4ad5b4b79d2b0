"""Recognition-memory fact filter.

Functional parity with the reference's DSPy-compiled filter
(rerank.py:15-131): few-shot chat prompt with ``[[ ## field ## ]]`` section
markers, response parsed into ``{"fact": [[s, p, o], ...]}``, generated
facts matched back to the candidate list by closest string match, order
preserved, truncated to ``len_after_rerank``.

Safe-parsing difference: candidate matching uses JSON round-trips rather
than ``ast.literal_eval`` on LLM output.
"""

from __future__ import annotations

import difflib
import json
import os
import re
from copy import deepcopy
from typing import Dict, List, Optional, Tuple

from .llm.base import BaseLLM
from .prompts.filter_prompt import best_filter_prompt
from .utils.llm_json import extract_json_dict
from .utils.logging import get_logger

logger = get_logger(__name__)

_SECTION_RE = re.compile(r"\[\[ ## (\w+) ## \]\]")

_INPUT_TEMPLATE = (
    "[[ ## question ## ]]\n{question}\n\n"
    "[[ ## fact_before_filter ## ]]\n{fact_before_filter}\n\n"
    "Respond with the corresponding output fields, starting with the field "
    "`[[ ## fact_after_filter ## ]]` (must be formatted as a valid Python Fact), "
    "and then ending with the marker for `[[ ## completed ## ]]`."
)
_OUTPUT_TEMPLATE = "[[ ## fact_after_filter ## ]]\n{fact_after_filter}\n\n[[ ## completed ## ]]"


def _closest_candidate(s: str, candidate_strs: List[str]) -> Optional[int]:
    """Index of the candidate closest to ``s`` — result-identical to
    ``difflib.get_close_matches(s, candidate_strs, n=1, cutoff=0.0)`` +
    ``candidate_strs.index(...)`` (reference filter matching,
    dspy_filter.py), but fast in the common cases: an exact echo (a good
    filter model copies facts verbatim — ratio 1.0 is only reachable by
    an equal string, and ``.index`` takes its first occurrence)
    short-circuits, and the fuzzy scan prunes with difflib's own upper
    bounds against the best-so-far instead of a cutoff of 0.0, which
    prunes nothing. Ratio ties resolve to the lexicographically largest
    candidate STRING (``nlargest`` compares (ratio, string) tuples) and
    then to that string's first index — the reference quirk, preserved."""
    if not candidate_strs:
        return None
    try:
        return candidate_strs.index(s)
    except ValueError:
        pass
    sm = difflib.SequenceMatcher()
    sm.set_seq2(s)
    best_str, best_ratio = None, -1.0
    for cand in candidate_strs:
        sm.set_seq1(cand)
        if (
            sm.real_quick_ratio() < best_ratio
            or sm.quick_ratio() < best_ratio
        ):
            continue
        r = sm.ratio()
        if r > best_ratio or (r == best_ratio and cand > best_str):
            best_str, best_ratio = cand, r
    return None if best_str is None else candidate_strs.index(best_str)


def parse_filter_response(response: str) -> List[List[str]]:
    """Extract the fact list from a sectioned filter response."""
    sections: List[Tuple[Optional[str], List[str]]] = [(None, [])]
    for line in response.splitlines():
        match = _SECTION_RE.match(line.strip())
        if match:
            sections.append((match.group(1), []))
        else:
            sections[-1][1].append(line)

    for name, lines in sections:
        if name != "fact_after_filter":
            continue
        body = "\n".join(lines).strip()
        obj = extract_json_dict(body)
        if obj is None:
            logger.warning("Unparseable fact_after_filter section: %r", body[:200])
            return []
        facts = obj.get("fact", [])
        out = []
        for fact in facts:
            if isinstance(fact, list) and len(fact) == 3:
                out.append([str(x) for x in fact])
        return out
    return []


class RecognitionMemoryFilter:
    """LLM-based candidate-fact filter ("recognition memory")."""

    def __init__(self, llm: BaseLLM, dspy_file_path: Optional[str] = None):
        self.llm = llm
        prompt_spec = best_filter_prompt
        if dspy_file_path:
            path = dspy_file_path
            if not os.path.exists(path):
                # bare filename resolves against the packaged compiled
                # prompts (ref main.py:96-100 joins the package dir)
                packaged = os.path.join(
                    os.path.dirname(__file__), "prompts", "dspy_prompts",
                    os.path.basename(path),
                )
                if os.path.exists(packaged):
                    path = packaged
            with open(path) as f:
                prompt_spec = json.load(f)
        prog = prompt_spec["prog"]
        self.message_template = [{"role": "system", "content": prog["system"]}]
        for demo in prog.get("demos", []):
            self.message_template.append(
                {
                    "role": "user",
                    "content": _INPUT_TEMPLATE.format(
                        question=demo["question"],
                        fact_before_filter=demo["fact_before_filter"],
                    ),
                }
            )
            self.message_template.append(
                {
                    "role": "assistant",
                    "content": _OUTPUT_TEMPLATE.format(
                        fact_after_filter=demo["fact_after_filter"]
                    ),
                }
            )

    def llm_call(self, question: str, fact_before_filter: str) -> str:
        messages = deepcopy(self.message_template)
        messages.append(
            {
                "role": "user",
                "content": _INPUT_TEMPLATE.format(
                    question=question, fact_before_filter=fact_before_filter
                ),
            }
        )
        response, _, _ = self.llm.infer(
            messages, max_completion_tokens=512, response_format=None
        )
        return response

    def rerank(
        self,
        query: str,
        candidate_items: List[Tuple],
        candidate_indices: List[int],
        len_after_rerank: Optional[int] = None,
    ) -> Tuple[List[int], List[Tuple], Dict]:
        fact_payload = json.dumps({"fact": [list(c) for c in candidate_items]})
        try:
            response = self.llm_call(query, fact_payload)
            generated = parse_filter_response(response)
        except Exception as e:  # noqa: BLE001 — filter failure falls back to no facts
            logger.warning("Filter call failed: %s", e)
            generated = []

        candidate_strs = [json.dumps(list(c)) for c in candidate_items]
        result_indices: List[int] = []
        for fact in generated:
            idx = _closest_candidate(json.dumps(fact), candidate_strs)
            if idx is None:
                continue
            if idx not in result_indices:
                result_indices.append(idx)

        sorted_indices = [candidate_indices[i] for i in result_indices]
        sorted_items = [candidate_items[i] for i in result_indices]
        return (
            sorted_indices[:len_after_rerank],
            sorted_items[:len_after_rerank],
            {"confidence": None},
        )

    __call__ = rerank
