"""NER-conditioned triple extraction prompt.

Contract parity with prompts/templates/triple_extraction.py: given a passage
and its named-entity list, emit ``{"triples": [[subject, predicate, object],
...]}``. Every triple should involve at least one listed entity and pronouns
must be resolved.
"""

from .ner import one_shot_ner_output, one_shot_ner_paragraph

re_system = (
    "You build a knowledge graph in RDF style from a passage and its named "
    "entity list.\n"
    "Reply with a JSON object containing a single key \"triples\": a list of "
    "[subject, predicate, object] string triples describing the relationships "
    "stated in the passage.\n\n"
    "Requirements:\n"
    "- Every triple must mention at least one entity from the list; prefer two.\n"
    "- Replace pronouns with the full entity name they refer to.\n"
)

re_frame = """Turn the paragraph below into a JSON dict holding a named entity list and a triple list.
Paragraph:
```
{passage}
```

{named_entity_json}
"""

one_shot_re_input = re_frame.format(
    passage=one_shot_ner_paragraph, named_entity_json=one_shot_ner_output
)

one_shot_re_output = """{"triples": [
            ["Cedar Hollow Observatory", "located in", "Tasmania"],
            ["Cedar Hollow Observatory", "is", "astronomical research facility"],
            ["Cedar Hollow Observatory", "opened on", "12 March 1967"],
            ["Cedar Hollow Observatory", "operated by", "University of Hobart"],
            ["Cedar Hollow Observatory", "hosts", "Southern Sky Survey"],
            ["Cedar Hollow Observatory", "commissioned", "Kestrel Telescope"],
            ["Kestrel Telescope", "commissioned in", "June 1994"],
            ["Kestrel Telescope", "is", "2.3-metre reflector"],
            ["Kestrel Telescope", "used for", "photometric studies"]
    ]
}
"""

# The live turn substitutes ${passage} and ${named_entity_json}.
live_turn = """Turn the paragraph below into a JSON dict holding a named entity list and a triple list.
Paragraph:
```
${passage}
```

${named_entity_json}
"""

prompt_template = [
    {"role": "system", "content": re_system},
    {"role": "user", "content": one_shot_re_input},
    {"role": "assistant", "content": one_shot_re_output},
    {"role": "user", "content": live_turn},
]
