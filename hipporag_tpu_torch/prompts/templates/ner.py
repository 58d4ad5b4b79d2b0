"""Passage NER prompt (contract parity: prompts/templates/ner.py).

Output contract: a JSON object ``{"named_entities": [...]}``. One-shot
demonstration uses an original example passage.
"""

ner_system = (
    "You extract named entities from the paragraph provided by the user.\n"
    "Reply with a JSON object containing a single key \"named_entities\" whose "
    "value is the list of entities found."
)

one_shot_ner_paragraph = """Cedar Hollow Observatory
Cedar Hollow Observatory is an astronomical research facility in Tasmania, opened on 12 March 1967.
It is operated by the University of Hobart and hosts the Southern Sky Survey.
In June 1994 the observatory commissioned the Kestrel Telescope, a 2.3-metre reflector used for photometric studies."""

one_shot_ner_output = """{"named_entities":
    ["Cedar Hollow Observatory", "Tasmania", "12 March 1967", "University of Hobart", "Southern Sky Survey", "June 1994", "Kestrel Telescope"]
}
"""

prompt_template = [
    {"role": "system", "content": ner_system},
    {"role": "user", "content": one_shot_ner_paragraph},
    {"role": "assistant", "content": one_shot_ner_output},
    {"role": "user", "content": "${passage}"},
]
