"""HotpotQA IRCoT template: two-hop bridge stepwise demo.

Reference shape (ircot_hotpotqa.py:1-29): demonstration in the system
message, user turn carries only ``${prompt_user}``. Demo content is
original. HotpotQA bridges exactly two documents through a shared entity,
with same-domain distractors in the context.
"""

one_shot_ircot_demo_docs = (
    """Wikipedia Title: Glass Lantern (film)\nGlass Lantern is a 1976 drama film directed by Howard Brecht. It won the audience prize at the Ostend Film Week and launched the career of its lead actress Miriam Kessler.\n\n"""
    """Wikipedia Title: Howard Brecht\nHoward Brecht (born 14 March 1941 in Dover, England) is a retired film director who made six feature films between 1971 and 1989.\n\n"""
    """Wikipedia Title: Miriam Kessler\nMiriam Kessler is a stage and screen actress who trained at the Wexford Conservatory.\n\n"""
    """Wikipedia Title: Paper Lantern (song)\nPaper Lantern is a 1998 single by the band Copper Meridian.\n\n"""
    """Wikipedia Title: Ostend Film Week\nThe Ostend Film Week was an annual film festival held in the 1970s.\n"""
)

one_shot_ircot_demo = (
    f"{one_shot_ircot_demo_docs}"
    "\n\nQuestion: "
    "In what English town was the director of the 1976 film Glass Lantern born?"
    "\nThought: "
    "The 1976 film Glass Lantern was directed by Howard Brecht. Howard "
    "Brecht was born in Dover, England. So the answer is: Dover."
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
