"""Offline batch OpenIE variants (reference:
information_extraction/openie_vllm_offline.py:20-77 and
openie_transformers_offline.py:14-77).

Same ``batch_openie`` contract as the online extractor, but driven by a
local batch engine (``llm/offline.py``) with JSON-schema guidance: one
whole-corpus NER pass followed by one whole-corpus triple pass, instead
of per-chunk thread fan-out. This backs the two-phase offline indexing
protocol (reference HippoRAG.py:243-260).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

from ..prompts import PromptTemplateManager
from ..utils.llm_json import (
    PROMPT_JSON_TEMPLATE,
    extract_named_entities,
    extract_triples,
)
from ..utils.logging import get_logger
from ..utils.misc import NerRawOutput, TripleRawOutput, filter_invalid_triples

logger = get_logger(__name__)

NER_SCHEMA = PROMPT_JSON_TEMPLATE["ner"]
TRIPLES_SCHEMA = PROMPT_JSON_TEMPLATE["triples"]


class OfflineBatchOpenIE:
    """Two-pass batch OpenIE over an offline engine with guided JSON."""

    def __init__(self, llm):
        self.llm = llm
        self.prompts = PromptTemplateManager()

    def batch_openie(
        self, chunks: Dict[str, Dict[str, Any]]
    ) -> Tuple[Dict[str, NerRawOutput], Dict[str, TripleRawOutput]]:
        ids = list(chunks.keys())
        passages = [chunks[c]["content"] for c in ids]
        ner_results: Dict[str, NerRawOutput] = {}
        triple_results: Dict[str, TripleRawOutput] = {}
        if not ids:
            return ner_results, triple_results

        # pass 1: NER over the whole corpus in one engine batch
        ner_msgs = [
            self.prompts.render("ner", passage=p) for p in passages
        ]
        ner_out = self.llm.batch_infer(ner_msgs, json_schema=NER_SCHEMA)
        entities_per_chunk = []
        for cid, passage, (raw, meta, _hit) in zip(ids, passages, ner_out):
            ents = extract_named_entities(raw)
            entities_per_chunk.append(ents)
            ner_results[cid] = NerRawOutput(cid, raw, ents, dict(meta))

        # pass 2: triple extraction conditioned on pass-1 entities
        re_msgs = [
            self.prompts.render(
                "triple_extraction",
                passage=p,
                named_entity_json=json.dumps({"named_entities": ents}),
            )
            for p, ents in zip(passages, entities_per_chunk)
        ]
        re_out = self.llm.batch_infer(re_msgs, json_schema=TRIPLES_SCHEMA)
        for cid, (raw, meta, _hit) in zip(ids, re_out):
            triples = filter_invalid_triples(extract_triples(raw))
            triple_results[cid] = TripleRawOutput(cid, raw, triples, dict(meta))

        logger.info("Offline OpenIE extracted %d chunks in 2 engine batches", len(ids))
        return ner_results, triple_results


class VLLMOfflineOpenIE(OfflineBatchOpenIE):
    def __init__(self, global_config):
        from ..llm.offline import VLLMOffline

        super().__init__(VLLMOffline(global_config))


class TransformersOfflineOpenIE(OfflineBatchOpenIE):
    def __init__(self, global_config):
        from ..llm.offline import TransformersOffline

        super().__init__(TransformersOffline(global_config))
