"""Query NER prompt (contract parity: prompts/templates/ner_query.py)."""

ner_query_system = "You are a precise entity extraction system."

one_shot_query_input = """Extract every named entity that matters for answering the question below.
Return them as a JSON object with the key "named_entities".

Question: Which observatory was commissioned earlier, the Kestrel Telescope or the Harrier Array?

"""

one_shot_query_output = """
{"named_entities": ["Kestrel Telescope", "Harrier Array"]}
"""

prompt_template = [
    {"role": "system", "content": ner_query_system},
    {"role": "user", "content": one_shot_query_input},
    {"role": "assistant", "content": one_shot_query_output},
    {"role": "user", "content": "Question: ${query}"},
]
