from .misc import (
    Chunk,
    NerRawOutput,
    QuerySolution,
    RetrievalResult,
    Triple,
    TripleRawOutput,
    compute_mdhash_id,
    extract_entity_nodes,
    filter_invalid_triples,
    flatten_facts,
    min_max_normalize,
    text_processing,
)

__all__ = [
    "Chunk",
    "NerRawOutput",
    "QuerySolution",
    "RetrievalResult",
    "Triple",
    "TripleRawOutput",
    "compute_mdhash_id",
    "extract_entity_nodes",
    "filter_invalid_triples",
    "flatten_facts",
    "min_max_normalize",
    "text_processing",
]
