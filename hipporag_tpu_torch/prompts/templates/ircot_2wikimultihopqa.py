"""2WikiMultihopQA IRCoT template: comparison-question stepwise demo.

Reference shape (ircot_2wikimultihopqa.py:1-24): demonstration in the system
message, user turn carries only ``${prompt_user}``. Demo content is
original. 2Wiki questions compare infobox-style facts (locations, dates,
relations) across two entities, with unrelated distractor passages.
"""

one_shot_ircot_demo_docs = (
    """Wikipedia Title: Lake Veyra\nLake Veyra is a freshwater lake in southern Finland with an area of about 90 square kilometres.\n\n"""
    """Wikipedia Title: Mount Solen\nMount Solen is a granite peak in central Sweden, popular with winter climbers.\n\n"""
    """Wikipedia Title: Helsinki Choral Festival\nThe Helsinki Choral Festival is a biennial music event first organised in 1921.\n\n"""
    """Wikipedia Title: Norrland Coastal Museum\nThe Norrland Coastal Museum is a regional museum of maritime history opened in 1964.\n\n"""
    """Wikipedia Title: River Kalda\nThe River Kalda is a short river in southern Finland that flows into Lake Veyra.\n"""
)

one_shot_ircot_demo = (
    f"{one_shot_ircot_demo_docs}"
    "\n\nQuestion: Are both Lake Veyra and Mount Solen located in the same country?"
    "\nThought: Lake Veyra is located in the country of Finland. Mount Solen "
    "is located in the country of Sweden. Thus, they are not in the same "
    "country. So the answer is: no.\n\n"
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
