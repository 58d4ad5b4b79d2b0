"""IRCoT helpers (reference contract: utils/qa_utils.py:9-50)."""

from __future__ import annotations

from typing import List


def merge_elements_with_same_first_line(
    elements: List[str], prefix: str = "Wikipedia Title: "
) -> List[str]:
    """Merge passages that share a first line (title), joining bodies."""
    merged = {}
    order = []
    for element in elements:
        lines = element.split("\n", 1)
        title = lines[0]
        body = lines[1] if len(lines) > 1 else ""
        if title not in merged:
            merged[title] = body
            order.append(title)
        else:
            merged[title] = merged[title] + "\n" + body if merged[title] else body
    return [f"{t}\n{merged[t]}" if merged[t] else t for t in order]


def reason_step(dataset, prompt_template_manager, query: str, passages: List[str], thoughts: List[str], llm):
    """One IRCoT reasoning step: render passages + prior thoughts, get the next thought."""
    prompt_user = ""
    for passage in merge_elements_with_same_first_line(passages):
        prompt_user += f"Wikipedia Title: {passage}\n\n"
    prompt_user += f"Question: {query}\nThought: " + " ".join(thoughts)

    name = f"ircot_{dataset}"
    if not prompt_template_manager.is_template_name_valid(name):
        name = "ircot"
    messages = prompt_template_manager.render(name, prompt_user=prompt_user)
    response, _, _ = llm.infer(messages, response_format=None)
    return response.strip()


def finish_rag_qa(
    config,
    solutions,
    responses,
    metadata,
    overall_retrieval_result,
    gold_docs,
    gold_answers,
    log_label: str = "QA",
):
    """Shared rag_qa epilogue (EM/F1 scoring, 4-dp rounding, gold
    attachment — ref HippoRAG.py:641-663): ONE copy for HippoRAG.rag_qa,
    rag_qa_dpr, and StandardRAG.rag_qa so the eval contract cannot
    silently diverge between retrievers."""
    if gold_answers is None:
        return solutions, responses, metadata

    import numpy as np

    from ..evaluation import QAExactMatch, QAF1Score
    from .logging import get_logger

    em, _ = QAExactMatch(config).calculate_metric_scores(
        gold_answers, [s.answer for s in solutions], np.max
    )
    f1, _ = QAF1Score(config).calculate_metric_scores(
        gold_answers, [s.answer for s in solutions], np.max
    )
    overall = {k: round(float(v), 4) for k, v in {**em, **f1}.items()}
    get_logger(__name__).info("%s eval: %s", log_label, overall)
    for i, s in enumerate(solutions):
        s.gold_answers = list(gold_answers[i])
        if gold_docs is not None:
            s.gold_docs = gold_docs[i]
    return solutions, responses, metadata, overall_retrieval_result, overall
