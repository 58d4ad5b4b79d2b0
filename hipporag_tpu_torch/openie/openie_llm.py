"""LLM-driven open information extraction (NER → triple extraction).

Functional parity with the reference OpenIE contract
(information_extraction/openie_openai.py:45-210): per chunk, one NER call
produces unique entities, then one NER-conditioned RE call produces
[s, p, o] triples; failures degrade to empty results with the error
recorded in metadata; truncated JSON is repaired; token usage and cache
hits are accounted.

Differences by design: responses are parsed with safe JSON extraction (no
``eval``), and the batch fan-out is a thread pool over the provider's
``infer`` (the reference's two sequential pools become one two-stage
pipeline per chunk so RE for chunk i doesn't wait on NER for chunk j).
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from ..llm.base import BaseLLM
from ..prompts import PromptTemplateManager
from ..utils.llm_json import (
    extract_named_entities,
    extract_triples,
    repair_truncated_json,
)
from ..utils.logging import get_logger
from ..utils.misc import NerRawOutput, TripleRawOutput, filter_invalid_triples

logger = get_logger(__name__)


@dataclass
class OpenIEResult:
    chunk_id: str
    ner: NerRawOutput
    triples: TripleRawOutput


class LLMOpenIE:
    def __init__(self, llm: BaseLLM, max_workers: int = 16):
        self.llm = llm
        self.max_workers = max_workers
        self.prompts = PromptTemplateManager()

    # ------------------------------------------------------------------
    def ner(self, chunk_id: str, passage: str) -> NerRawOutput:
        messages = self.prompts.render("ner", passage=passage)
        raw, metadata = "", {}
        try:
            raw, metadata, cache_hit = self.llm.infer(messages)
            metadata["cache_hit"] = cache_hit
            text = (
                repair_truncated_json(raw)
                if metadata.get("finish_reason") == "length"
                else raw
            )
            entities = extract_named_entities(text)
            unique = list(dict.fromkeys(entities))
            return NerRawOutput(chunk_id, raw, unique, metadata)
        except Exception as e:  # noqa: BLE001 — degrade, don't abort the batch
            logger.warning("NER failed for %s: %s", chunk_id, e)
            metadata["error"] = str(e)
            return NerRawOutput(chunk_id, raw, [], metadata)

    def triple_extraction(
        self, chunk_id: str, passage: str, named_entities: List[str]
    ) -> TripleRawOutput:
        messages = self.prompts.render(
            "triple_extraction",
            passage=passage,
            named_entity_json=json.dumps({"named_entities": named_entities}),
        )
        raw, metadata = "", {}
        try:
            raw, metadata, cache_hit = self.llm.infer(messages)
            metadata["cache_hit"] = cache_hit
            text = (
                repair_truncated_json(raw)
                if metadata.get("finish_reason") == "length"
                else raw
            )
            triples = filter_invalid_triples(extract_triples(text))
            return TripleRawOutput(chunk_id, raw, triples, metadata)
        except Exception as e:  # noqa: BLE001
            logger.warning("Triple extraction failed for %s: %s", chunk_id, e)
            metadata["error"] = str(e)
            return TripleRawOutput(chunk_id, raw, [], metadata)

    def openie(self, chunk_id: str, passage: str) -> OpenIEResult:
        ner_out = self.ner(chunk_id, passage)
        triple_out = self.triple_extraction(chunk_id, passage, ner_out.unique_entities)
        return OpenIEResult(chunk_id, ner_out, triple_out)

    # ------------------------------------------------------------------
    def batch_openie(
        self, chunks: Dict[str, Dict[str, Any]]
    ) -> Tuple[Dict[str, NerRawOutput], Dict[str, TripleRawOutput]]:
        """Extract over {chunk_id: {"content": ...}}; returns two id-keyed dicts."""
        items = [(cid, row["content"]) for cid, row in chunks.items()]
        ner_results: Dict[str, NerRawOutput] = {}
        triple_results: Dict[str, TripleRawOutput] = {}
        if not items:
            return ner_results, triple_results

        total_prompt_tokens = 0
        total_completion_tokens = 0
        cache_hits = 0

        def run(item):
            cid, passage = item
            return self.openie(cid, passage)

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            for result in pool.map(run, items):
                ner_results[result.chunk_id] = result.ner
                triple_results[result.chunk_id] = result.triples
                for meta in (result.ner.metadata, result.triples.metadata):
                    total_prompt_tokens += meta.get("prompt_tokens") or 0
                    total_completion_tokens += meta.get("completion_tokens") or 0
                    cache_hits += 1 if meta.get("cache_hit") else 0

        logger.info(
            "OpenIE over %d chunks: %d prompt tokens, %d completion tokens, %d cache hits",
            len(items),
            total_prompt_tokens,
            total_completion_tokens,
            cache_hits,
        )
        return ner_results, triple_results
