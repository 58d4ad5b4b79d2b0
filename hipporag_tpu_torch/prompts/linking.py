"""Instruction strings per query-linking method.

These instructions steer instruction-tuned embedders; the method names match
the reference's linking registry (prompts/linking.py:1-10) because they are
part of the public configuration surface.
"""

_INSTRUCTIONS = {
    "ner_to_node": "Given a phrase, retrieve synonymous or closely related phrases.",
    "query_to_node": "Given a question, retrieve the phrases it mentions.",
    "query_to_fact": "Given a question, retrieve triplet facts that match it.",
    "query_to_sentence": "Given a question, retrieve sentences that answer it.",
    "query_to_passage": "Given a question, retrieve documents that best answer it.",
}

_DEFAULT = _INSTRUCTIONS["query_to_passage"]


def get_query_instruction(linking_method: str) -> str:
    return _INSTRUCTIONS.get(linking_method, _DEFAULT)
