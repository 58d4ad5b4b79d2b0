"""Recognition-memory fact filter.

Functional parity with the reference's DSPy-compiled filter
(rerank.py:15-131): few-shot chat prompt with ``[[ ## field ## ]]`` section
markers, response parsed into ``{"fact": [[s, p, o], ...]}``, generated
facts matched back to the candidate list by closest string match, order
preserved, truncated to ``len_after_rerank``.

A bucket of questions is filtered in one pass (:meth:`RecognitionMemoryFilter.select`):
prompts are built, and responses parsed and matched, on the calling thread;
only the LLM calls go to an executor the filter holds.

Safe-parsing difference: candidate matching uses JSON round-trips rather
than ``ast.literal_eval`` on LLM output.
"""

from __future__ import annotations

import difflib
import json
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Tuple

from .llm.base import BaseLLM
from .prompts.filter_prompt import best_filter_prompt
from .utils.llm_json import extract_json_dict
from .utils.logging import get_logger
from .utils.timing import count

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
    dspy_filter.py), but faster: the scan prunes with difflib's own upper
    bounds against the best-so-far instead of a cutoff of 0.0, which
    prunes nothing. Ratio ties resolve to the lexicographically largest
    candidate STRING (``nlargest`` compares (ratio, string) tuples) and
    then to that string's first index — the reference quirk, preserved.
    An exact echo (ratio 1.0, reachable only by an equal string) is the
    common case; :meth:`RecognitionMemoryFilter.select` looks it up before
    calling this."""
    if not candidate_strs:
        return None
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
    """LLM-based candidate-fact filter ("recognition memory").

    ``max_workers`` bounds the LLM calls in flight, over every caller of
    :meth:`select` at once; their executor is made on first use."""

    def __init__(self, llm: BaseLLM, dspy_file_path: Optional[str] = None, max_workers: int = 16):
        self.llm = llm
        self.max_workers = max_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
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

    def _messages(self, question: str, candidate_strs: List[str]) -> List[Dict[str, str]]:
        """The chat for one question: copies of the template's messages and
        the question's. ``candidate_strs`` are the facts' JSON texts, so the
        payload is ``json.dumps({"fact": [list(c) for c in facts]})``."""
        payload = '{"fact": [' + ", ".join(candidate_strs) + "]}"
        messages = [dict(m) for m in self.message_template]
        messages.append(
            {
                "role": "user",
                "content": _INPUT_TEMPLATE.format(question=question, fact_before_filter=payload),
            }
        )
        return messages

    def _infer(self, messages: List[Dict[str, str]]) -> str:
        response, _, _ = self.llm.infer(
            messages, max_completion_tokens=512, response_format=None
        )
        return response

    def _executor(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.max_workers, thread_name_prefix="filter")
            return self._pool

    def select(self, questions: List[str], candidate_strs: List[List[str]]) -> List[List[int]]:
        """For each question, the positions in its candidates of the facts
        the LLM kept, in the LLM's order and without repeats.

        ``candidate_strs[i]`` are question ``i``'s candidate facts as JSON
        texts (``json.dumps(list(fact))``). The LLM calls run on the
        filter's executor (one question's inline); a question whose call or
        response fails keeps no facts. A generated fact that no candidate
        text equals goes to the closest-match scan and is counted as
        ``facts_fuzzy`` on the span open on this thread."""
        prompts = [self._messages(q, strs) for q, strs in zip(questions, candidate_strs)]
        if len(prompts) > 1:
            pool = self._executor()
            calls = [pool.submit(self._infer, m).result for m in prompts]
        else:
            calls = [partial(self._infer, m) for m in prompts]
        kept, fuzzy = [], 0
        for strs, call in zip(candidate_strs, calls):
            try:
                generated = parse_filter_response(call())
            except Exception as e:  # noqa: BLE001 — filter failure falls back to no facts
                logger.warning("Filter call failed: %s", e)
                generated = []
            first: Dict[str, int] = {}
            for i, text in enumerate(strs):
                first.setdefault(text, i)
            picked: Dict[int, None] = {}
            for fact in generated:
                text = json.dumps(fact)
                idx = first.get(text)
                if idx is None:
                    fuzzy += 1
                    idx = _closest_candidate(text, strs)
                    if idx is None:
                        continue
                picked.setdefault(idx)
            kept.append(list(picked))
        count("facts_fuzzy", fuzzy)
        return kept

    def rerank(
        self,
        query: str,
        candidate_items: List[Tuple],
        candidate_indices: List[int],
        len_after_rerank: Optional[int] = None,
    ) -> Tuple[List[int], List[Tuple], Dict]:
        """:meth:`select` for one question over its candidate facts."""
        (kept,) = self.select([query], [[json.dumps(list(c)) for c in candidate_items]])
        kept = kept[:len_after_rerank]
        return (
            [candidate_indices[i] for i in kept],
            [candidate_items[i] for i in kept],
            {"confidence": None},
        )

    __call__ = rerank
