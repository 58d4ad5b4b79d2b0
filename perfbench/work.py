"""The least device time of the engine calls a window drove, stage by stage
(``roofline.py``), from the reference's shapes: facts, passages, graph
nodes and entries, and the PageRank iterations the plain reference needs
for each 128-query tile's resets at the configured tolerance. Where the
configuration names a question encoder, the ``encode`` stage is its
``work`` over the tokens of each question under both instructions, at the
precision the configuration states; without one it is 0."""

from __future__ import annotations

import torch

from . import roofline as rf


def tiles(questions, size: int):
    return [questions[s:s + size] for s in range(0, len(questions), size)]


def ppr_iterations(ref, fact_vecs, passage_vecs, settings) -> int:
    """Iterations the reference needs for one tile of questions."""
    facts = ref.fact_scores(fact_vecs)
    dense = ref.dense_scores(passage_vecs)
    k = settings["linking_top_k"]
    rows = []
    for i in range(fact_vecs.shape[0]):
        top = torch.topk(facts[i], k).indices.tolist()
        rows.append(ref.reset(ref.seed_choices(ref.entity_weights(top, facts[i]))[0], dense[i]))
    _p, iters = ref.ppr(torch.stack(rows), tol=settings["ppr_tol"], max_iters=settings["ppr_max_iters"])
    return iters


def call_stages(ref, calls, config, query_rows) -> list:
    """Per call, {stage: least seconds}. ``query_rows(questions)`` gives the
    float64 (fact rows, passage rows) the call used."""
    s = config["hipporag"]
    encoder = None
    if config.get("query_encoder"):
        from .encoders import load
        from .reference.encoders import token_counts

        encoder = load(config["query_encoder"])
    g = ref.graph
    d = int(config["index_vectors"]["dim"])
    n_fact, n_pass, nodes, entries = len(g.facts), len(g.passages), g.num_nodes, g.num_entries
    out = []
    for call in calls:
        qs = list(dict.fromkeys(call["questions"]))
        st = {}

        def add(stage, work):
            st[stage] = st.get(stage, 0.0) + rf.least_s(*work)

        if encoder is not None:
            add("encode", encoder.work(config, token_counts(config, qs)))
        for tile in tiles(qs, s["ppr_batch_size"]):
            b = len(tile)
            add("dense_scores", rf.dense_scores(b, n_pass, d))
            if call["entry"] == "retrieve_dpr":
                add("passage_topk", rf.topk(b, n_pass, s["retrieval_top_k"]))
                continue
            add("fact_topk", rf.fact_topk(b, n_fact, d, s["linking_top_k"]))
            add("k1_pass_a", rf.k1_pass_a(b, n_fact, d))
            add("seeds", rf.seeds(b, nodes, n_pass))
            iters = ppr_iterations(ref, *query_rows(tile), s)
            add("ppr", rf.ppr(entries, nodes, b, iters))
            add("passage_scores", rf.passage_scores(b, n_pass))
            add("passage_topk", rf.topk(b, n_pass, s["retrieval_top_k"]))
        out.append(st)
    return out


STEP_STAGES = ("encode", "dense_scores", "fact_topk", "seeds", "ppr", "passage_scores", "passage_topk")
GRAPH_SEARCH_STAGES = ("seeds", "ppr", "passage_scores", "passage_topk")
