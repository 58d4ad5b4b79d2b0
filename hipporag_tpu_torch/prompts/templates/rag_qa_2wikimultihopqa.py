"""2WikiMultihopQA QA template: comparison-question demo over structured facts.

Dataset-specific one-shot demonstration (the reference ships per-dataset
demos, ref prompts/templates/rag_qa_musique.py:1-47; content here is
original). 2Wiki questions are largely comparison/inference over infobox-like
facts (birth dates, nationalities, family relations), so the demo compares
two entities across documents with unrelated distractors present.
"""

one_shot_rag_qa_docs = (
    """Wikipedia Title: Anders Lindholm\nAnders Lindholm (12 May 1873 - 3 January 1941) was a Swedish landscape painter known for his winter scenes of the Norrland coast.\n"""
    """Wikipedia Title: Paavo Rantanen\nPaavo Rantanen (30 August 1881 - 19 November 1956) was a Finnish composer whose choral works are still performed in Helsinki churches.\n"""
    """Wikipedia Title: Lake Veyra\nLake Veyra is a freshwater lake in southern Finland with an area of about 90 square kilometres.\n"""
    """Wikipedia Title: Norrland Coastal Museum\nThe Norrland Coastal Museum is a regional museum of maritime history opened in 1964.\n"""
    """Wikipedia Title: Helsinki Choral Festival\nThe Helsinki Choral Festival is a biennial music event first organised in 1921.\n"""
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
    "Who died earlier, Anders Lindholm or Paavo Rantanen?"
    "\nThought: "
)

one_shot_rag_qa_output = (
    "Anders Lindholm died on 3 January 1941. Paavo Rantanen died on "
    "19 November 1956. 1941 is earlier than 1956, so Anders Lindholm "
    "died earlier. "
    "\nAnswer: Anders Lindholm."
)

prompt_template = [
    {"role": "system", "content": rag_qa_system},
    {"role": "user", "content": one_shot_rag_qa_input},
    {"role": "assistant", "content": one_shot_rag_qa_output},
    {"role": "user", "content": "${prompt_user}"},
]
