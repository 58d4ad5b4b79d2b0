"""The comparison that decides ``correct``.

Each answer the timed path produced (a question, its ranked passages with
their scores and, from graph search, the facts it kept) is judged against
the plain reference (``reference/``) for that question:

- ``malformed``: answers with a passage the corpus does not hold, a passage
  twice, another length than asked for, or (graph search) another number of
  kept facts than ``linking_top_k`` or a fact the graph does not hold;
- ``fact_gap``: how far the lowest kept fact's reference score lies below
  the reference's ``linking_top_k``-th best (normalized scores; 0 when the
  kept facts are the reference's);
- ``rank_gap``: at each rank, how far the reference's score of the passage
  served there lies below the reference's score at that rank (0 for the
  reference's own order; near ties give tiny gaps);
- ``score_err``: the largest difference between a served score and the
  reference's score of that passage;
- ``embed_err`` (configurations that name a question encoder): the largest
  L2 distance between a row the program's encoder gave a sampled question
  (unit length) and the reference encoder's row for the same text and
  instruction, over the sample and both instructions.

The ranking is judged on the question rows the timed path used: the fact
rows for the fact scores and the passage rows for the dense passage
scores. Without an encoder both are the benchmark's hashing rows; with one
they are the program's own rows, and ``embed_err`` judges the encoder.

The ranking is judged against the reference's own graph search, from its
own top facts. Where scores tie at a ``linking_top_k`` cut (facts within
1e-5, entity weights within 1e-6 of the largest), the reference tries each
set the cut may keep and takes the closest; where
an entity pair's synonymy score lies within 1e-6 of the threshold, it also
walks the graph with those decisions flipped. A number over its limit, or
any malformed answer, makes the run incorrect.
"""

from __future__ import annotations

import torch

from .reference.retrieval import Reference


def judge(ref: Reference, fact_vecs: torch.Tensor, passage_vecs: torch.Tensor, answers, graph: bool,
          block: int = 256) -> dict:
    """``answers``: dicts with ``docs`` (passage texts), ``scores``, ``k``
    (how many were asked for) and, for graph search, ``facts`` (kept
    triples). ``fact_vecs``, ``passage_vecs``: [len(answers), D] float64
    question rows on the reference's device."""
    out = {"malformed": 0, "rank_gap": 0.0, "score_err": 0.0}
    if graph and any(a["facts"] is not None for a in answers):
        out["fact_gap"] = 0.0
    k_link = ref.settings["linking_top_k"]
    n_pass = len(ref.graph.passages)
    for start in range(0, len(answers), block):
        part = answers[start:start + block]
        dense = ref.dense_scores(passage_vecs[start:start + block])
        if not graph:
            for i, a in enumerate(part):
                _keep_worst(out, _gaps(a, dense[i], ref, n_pass))
            continue
        facts = ref.fact_scores(fact_vecs[start:start + block])
        rows, owners = [], []
        for i, a in enumerate(part):
            if a["facts"] is not None:
                ids = [ref.graph.fact_id.get(tuple(f)) for f in a["facts"]]
                if None in ids or len(set(ids)) != min(k_link, len(ref.graph.facts)):
                    out["malformed"] += 1
                    continue
                kth = float(torch.topk(facts[i], k_link).values[-1])
                out["fact_gap"] = max(out["fact_gap"], kth - min(float(facts[i][f]) for f in ids))
            for ids in ref.fact_choices(facts[i]):
                for choice in ref.seed_choices(ref.entity_weights(ids, facts[i])):
                    rows.append(ref.reset(choice, dense[i]))
                    owners.append(i)
        if not rows:
            continue
        resets = torch.stack(rows)
        best: dict = {}
        for flipped in (False, True) if ref.graph.t_flipped is not None else (False,):
            scores = ref.passage_scores(ref.ppr(resets, flipped=flipped)[0])
            for row, i in enumerate(owners):
                got = _gaps(part[i], scores[row], ref, n_pass)
                if got is not None and (i not in best or got[0] < best[i][0]):
                    best[i] = got
        for i in set(owners):
            _keep_worst(out, best.get(i))
    return out


def _gaps(answer, ref_scores: torch.Tensor, ref: Reference, n_pass: int):
    """(rank gap, score error) of one answer, or None if it is malformed."""
    ids = [ref.passage_of.get(d) for d in answer["docs"]]
    if None in ids or len(set(ids)) != len(ids) or len(ids) != min(answer["k"], n_pass):
        return None
    ranked = torch.sort(ref_scores, descending=True).values[: len(ids)]
    got = ref_scores[torch.tensor(ids, device=ref_scores.device)]
    served = torch.tensor(answer["scores"], dtype=torch.float64, device=ref_scores.device)
    return float((ranked - got).max()), float((served - got).abs().max())


def _keep_worst(out: dict, gaps) -> None:
    """Fold one answer's (rank gap, score error) into ``out``; None is a
    malformed answer."""
    if gaps is None:
        out["malformed"] += 1
        return
    out["rank_gap"] = max(out["rank_gap"], gaps[0])
    out["score_err"] = max(out["score_err"], gaps[1])


def embed_err(program_rows, reference_rows) -> float:
    """Largest L2 distance between matching rows of the (fact, passage)
    pairs ``program_rows`` and ``reference_rows``, in float64."""
    return max(float(torch.linalg.vector_norm(p.double() - r.to(p.device, torch.float64), dim=1).max())
               for p, r in zip(program_rows, reference_rows))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers that have a limit."""
    rows = [(name, numbers[name], limits[name]) for name in limits if name in numbers]
    missing = [name for name in limits if name not in numbers]
    ok = not missing and all(value <= limit for _name, value, limit in rows)
    return ok, rows
