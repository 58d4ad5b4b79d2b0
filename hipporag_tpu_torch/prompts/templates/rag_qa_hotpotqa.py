"""HotpotQA QA template: two-hop bridge demo with topically-close distractors.

Dataset-specific one-shot demonstration (the reference ships per-dataset
demos, ref prompts/templates/rag_qa_musique.py:1-47; content here is
original). HotpotQA bridges exactly two supporting documents, typically
linked by a shared person or work, amid same-domain distractors.
"""

one_shot_rag_qa_docs = (
    """Wikipedia Title: Glass Lantern (film)\nGlass Lantern is a 1976 drama film directed by Howard Brecht. It won the audience prize at the fictional Ostend Film Week and launched the career of its lead actress Miriam Kessler.\n"""
    """Wikipedia Title: Howard Brecht\nHoward Brecht (born 14 March 1941 in Dover, England) is a retired film director. After studying painting he moved to documentary work, then directed six feature films between 1971 and 1989.\n"""
    """Wikipedia Title: Miriam Kessler\nMiriam Kessler is a stage and screen actress who trained at the Wexford Conservatory and later founded a touring theatre company.\n"""
    """Wikipedia Title: Paper Lantern (song)\nPaper Lantern is a 1998 single by the band Copper Meridian, released on their second studio album.\n"""
    """Wikipedia Title: Ostend Film Week\nThe Ostend Film Week was an annual film festival held in the 1970s that showcased European drama and documentary features.\n"""
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
    "In what English town was the director of the 1976 film Glass Lantern born?"
    "\nThought: "
)

one_shot_rag_qa_output = (
    "The 1976 film Glass Lantern was directed by Howard Brecht. "
    "Howard Brecht was born in Dover, England. "
    "\nAnswer: Dover."
)

prompt_template = [
    {"role": "system", "content": rag_qa_system},
    {"role": "user", "content": one_shot_rag_qa_input},
    {"role": "assistant", "content": one_shot_rag_qa_output},
    {"role": "user", "content": "${prompt_user}"},
]
