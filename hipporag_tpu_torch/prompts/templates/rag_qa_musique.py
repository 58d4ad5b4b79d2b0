"""MuSiQue QA template: compositional bridge-question demo.

Dataset-specific one-shot demonstration (reference keeps a distinct demo per
dataset, ref prompts/templates/rag_qa_musique.py:1-47; demo content here is
original). MuSiQue questions compose 2-4 hops through bridge entities, so the
demo shows multi-document composition with distractor passages present.
"""

one_shot_rag_qa_docs = (
    """Wikipedia Title: Kestrel Telescope\nThe Kestrel Telescope is a 3.6-metre optical telescope commissioned in June 1994 at the Alto Verde Observatory in northern Chile. It was the first large instrument funded by the Meridian Astronomy Consortium.\n"""
    """Wikipedia Title: Alto Verde Observatory\nAlto Verde Observatory is a high-altitude astronomical site in the Atacama region of Chile, operated since 1988 by the University of Valdora. The dry climate gives the site more than 300 clear nights per year.\n"""
    """Wikipedia Title: University of Valdora\nThe University of Valdora is a private research university founded in 1921 in the coastal city of Valdora. Its physical sciences faculty runs several remote observing stations in the Atacama.\n"""
    """Wikipedia Title: Harrier Array\nThe Harrier Array is a radio interferometer in Western Australia completed in 2002, consisting of 36 dish antennas. It is unrelated to optical astronomy programs in South America.\n"""
    """Wikipedia Title: Valdora (city)\nValdora is a port city on the Pacific coast known for its copper exports and its annual maritime festival held every February since 1902.\n"""
)

rag_qa_system = (
    "As an advanced reading comprehension assistant, your task is to analyze "
    "text passages and corresponding questions meticulously. Your response "
    'starts after "Thought: ", where you will methodically break down the '
    "reasoning process, illustrating how you arrive at conclusions. Conclude "
    'with "Answer: " to present a concise, definitive response, devoid of '
    "additional elaborations."
)

one_shot_rag_qa_input = (
    f"{one_shot_rag_qa_docs}"
    "\n\nQuestion: "
    "When was the university that operates the observatory hosting the Kestrel Telescope founded?"
    "\nThought: "
)

one_shot_rag_qa_output = (
    "The Kestrel Telescope is located at the Alto Verde Observatory. "
    "Alto Verde Observatory is operated by the University of Valdora. "
    "The University of Valdora was founded in 1921. "
    "\nAnswer: 1921."
)

prompt_template = [
    {"role": "system", "content": rag_qa_system},
    {"role": "user", "content": one_shot_rag_qa_input},
    {"role": "assistant", "content": one_shot_rag_qa_output},
    {"role": "user", "content": "${prompt_user}"},
]
