"""Default few-shot prompt for the recognition-memory fact filter.

Same interaction format as the reference's compiled DSPy program
(prompts/filter_default_prompt.py): sections delimited by
``[[ ## question ## ]]`` / ``[[ ## fact_before_filter ## ]]`` /
``[[ ## fact_after_filter ## ]]`` / ``[[ ## completed ## ]]``, with the fact
payloads as ``{"fact": [[s, p, o], ...]}`` JSON. Demos are original.
"""

filter_system_prompt = """Your input fields are:
1. `question` (str)
2. `fact_before_filter` (str)
Your output fields are:
1. `fact_after_filter` (Fact)

All interactions will be structured in the following way, with the appropriate values filled in.

[[ ## question ## ]]
{question}

[[ ## fact_before_filter ## ]]
{fact_before_filter}

[[ ## fact_after_filter ## ]]
{fact_after_filter}

[[ ## completed ## ]]

In adhering to this structure, your objective is:
    Given a question and a candidate list of facts (each a [subject, predicate, object] triple), keep only the facts that could help answer the question, preserving their original wording. Output them as JSON of the form {"fact": [[subject, predicate, object], ...]}. Never invent facts that are not in the candidate list."""

default_filter_demos = [
    {
        "question": "Which country is the birthplace of the director of the film Silver Harbour?",
        "fact_before_filter": '{"fact": [["silver harbour", "directed by", "maren lindqvist"], ["silver harbour", "released in", "1998"], ["maren lindqvist", "born in", "norway"], ["golden coast", "directed by", "ira chen"], ["silver harbour", "produced by", "nordfilm"]]}',
        "fact_after_filter": '{"fact":[["silver harbour","directed by","maren lindqvist"],["maren lindqvist","born in","norway"]]}',
    },
    {
        "question": "When did the university that operates Cedar Hollow Observatory open its medical school?",
        "fact_before_filter": '{"fact": [["cedar hollow observatory", "operated by", "university of hobart"], ["university of hobart", "opened medical school in", "1965"], ["harrier array", "completed in", "2002"], ["cedar hollow observatory", "located in", "tasmania"], ["kestrel telescope", "commissioned in", "june 1994"]]}',
        "fact_after_filter": '{"fact":[["cedar hollow observatory","operated by","university of hobart"],["university of hobart","opened medical school in","1965"]]}',
    },
    {
        "question": "Are Lake Veyra and Mount Solen in the same country?",
        "fact_before_filter": '{"fact": [["lake veyra", "located in", "finland"], ["mount solen", "located in", "sweden"], ["lake veyra", "has area", "90 square kilometres"], ["mount solen", "is", "granite peak"], ["river kalda", "flows into", "lake veyra"]]}',
        "fact_after_filter": '{"fact":[["lake veyra","located in","finland"],["mount solen","located in","sweden"]]}',
    },
]

# Shape-compatible with saved DSPy program files so users can drop in their
# own compiled prompts via config.rerank_dspy_file_path.
best_filter_prompt = {
    "prog": {
        "lm": None,
        "traces": [],
        "train": [],
        "demos": [
            {
                "augmented": True,
                "question": d["question"],
                "fact_before_filter": d["fact_before_filter"],
                "fact_after_filter": d["fact_after_filter"],
            }
            for d in default_filter_demos
        ],
        "system": filter_system_prompt,
    }
}
