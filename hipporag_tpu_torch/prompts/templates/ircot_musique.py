"""MuSiQue IRCoT template: compositional multi-hop stepwise demo.

Reference shape (ircot_musique.py:1-30): the one-shot demonstration lives in
the system message; the user turn carries only ``${prompt_user}``. Demo
content is original. MuSiQue chains compose 2-4 hops, so the demo thought
resolves one bridge entity per sentence.
"""

one_shot_ircot_demo_docs = (
    """Wikipedia Title: Kestrel Telescope\nThe Kestrel Telescope is a 3.6-metre optical telescope commissioned in June 1994 at the Alto Verde Observatory in northern Chile.\n\n"""
    """Wikipedia Title: Alto Verde Observatory\nAlto Verde Observatory is a high-altitude astronomical site in the Atacama region of Chile, operated since 1988 by the University of Valdora.\n\n"""
    """Wikipedia Title: University of Valdora\nThe University of Valdora is a private research university founded in 1921 in the coastal city of Valdora.\n\n"""
    """Wikipedia Title: Harrier Array\nThe Harrier Array is a radio interferometer in Western Australia completed in 2002.\n\n"""
    """Wikipedia Title: Valdora (city)\nValdora is a port city on the Pacific coast known for its copper exports and its annual maritime festival.\n"""
)

one_shot_ircot_demo = (
    f"{one_shot_ircot_demo_docs}"
    "\n\nQuestion: "
    "When was the university that operates the observatory hosting the Kestrel Telescope founded?"
    "\nThought: "
    "The Kestrel Telescope is hosted at the Alto Verde Observatory. "
    "Alto Verde Observatory is operated by the University of Valdora. "
    "The University of Valdora was founded in 1921. So the answer is: 1921."
    "\n\n"
)

ircot_system = (
    "You serve as an intelligent assistant, adept at facilitating users "
    "through complex, multi-hop reasoning across multiple documents. This "
    "task is illustrated through demonstrations, each consisting of a "
    "document set paired with a relevant question and its multi-hop "
    "reasoning thoughts. Your task is to generate one thought for the "
    "current step, DON'T generate the whole thoughts at once! If you reach "
    'what you believe to be the final step, start with "So the answer is:".'
    "\n\n"
    f"{one_shot_ircot_demo}"
)

prompt_template = [
    {"role": "system", "content": ircot_system},
    {"role": "user", "content": "${prompt_user}"},
]
