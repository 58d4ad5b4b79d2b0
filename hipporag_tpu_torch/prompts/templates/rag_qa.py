"""Reading-comprehension QA prompt (contract parity: rag_qa_musique.py).

Response contract: a chain of thought after "Thought: " followed by a final
line starting with "Answer: ". Both the default and dataset-specific QA
paths render this template with ``${prompt_user}``.
"""

qa_system = (
    "You are a careful reading comprehension assistant. Read the passages and "
    "the question, reason step by step after \"Thought: \", and finish with a "
    "final line of the form \"Answer: <short answer>\" with no extra commentary."
)

one_shot_docs = (
    """Wikipedia Title: Cedar Hollow Observatory\nCedar Hollow Observatory is an astronomical research facility in Tasmania operated by the University of Hobart.\n"""
    """Wikipedia Title: University of Hobart\nThe University of Hobart is a public research university established in 1890 in Tasmania, Australia. It runs several research stations across the island.\n"""
    """Wikipedia Title: Harrier Array\nThe Harrier Array is a radio interferometer in Western Australia completed in 2002.\n"""
)

one_shot_input = (
    f"{one_shot_docs}"
    "\n\nQuestion: "
    "When was the operator of Cedar Hollow Observatory established?"
    "\nThought: "
)

one_shot_output = (
    "Cedar Hollow Observatory is operated by the University of Hobart. "
    "The University of Hobart was established in 1890. "
    "\nAnswer: 1890."
)

prompt_template = [
    {"role": "system", "content": qa_system},
    {"role": "user", "content": one_shot_input},
    {"role": "assistant", "content": one_shot_output},
    {"role": "user", "content": "${prompt_user}"},
]
