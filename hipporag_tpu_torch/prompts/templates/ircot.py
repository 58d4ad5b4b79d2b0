"""IRCoT iterative-reasoning prompt (contract parity: ircot_musique.py).

Each call produces ONE further reasoning step ("thought"); the chain stops
when a thought contains "So the answer is:". Rendered with ``${prompt_user}``
containing passages, the question, and prior thoughts.
"""

ircot_system = (
    "You answer multi-hop questions by thinking one step at a time. Given "
    "passages, a question, and your previous thoughts, write the single next "
    "reasoning step. When the answer is fully determined, finish the step "
    "with \"So the answer is: <answer>.\""
)

one_shot_input = (
    """Wikipedia Title: Cedar Hollow Observatory\nCedar Hollow Observatory is an astronomical research facility in Tasmania operated by the University of Hobart.\n"""
    """Wikipedia Title: University of Hobart\nThe University of Hobart is a public research university established in 1890 in Tasmania, Australia.\n"""
    "\n\nQuestion: When was the operator of Cedar Hollow Observatory established?"
    "\nThought: "
)

one_shot_output = (
    "The operator of Cedar Hollow Observatory is the University of Hobart, "
    "which was established in 1890. So the answer is: 1890."
)

prompt_template = [
    {"role": "system", "content": ircot_system},
    {"role": "user", "content": one_shot_input},
    {"role": "assistant", "content": one_shot_output},
    {"role": "user", "content": "${prompt_user}"},
]
