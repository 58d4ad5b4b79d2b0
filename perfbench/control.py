#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision below what the configuration
states (float32 with TF32 products, for float32 with TF32 off), judged by
the same comparison as a run. Where the configuration names a question
encoder, the reference encoder computed with every product's operands one
precision below the configuration's ``torch_dtype`` (TF32 for float32, fp8
e4m3 for bfloat16) gives the question rows in the program's place, and ``embed_err`` is reported beside the ranking numbers. Its
numbers are the upper readings the limits of ``workloads/<cell>.json``
are set below.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--answers 256]

It builds each seed's corpus and questions as a run does and prints one
JSON line per seed with the numbers. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import check, run  # noqa: E402
from perfbench.corpus import Corpus, QuestionStream  # noqa: E402
from perfbench.sampling import answer  # noqa: E402


def control_answers(ref, fact_vecs, passage_vecs, questions, ks, settings, entry: str, with_facts: bool):
    """Answers as the timed path would give them, from ``ref`` (in the
    control's precision): per tile of ``ppr_batch_size`` questions, the top
    facts, the seeds, PageRank at the configured tolerance and the ranking."""
    out = []
    tile = settings["ppr_batch_size"]
    for s in range(0, len(questions), tile):
        q = passage_vecs[s:s + tile]
        dense = ref.dense_scores(q)
        if entry == "retrieve_dpr":
            scores = dense
            kept = [None] * len(q)
        else:
            facts = ref.fact_scores(fact_vecs[s:s + tile])
            kept, rows = [], []
            for i in range(q.shape[0]):
                ids = torch.topk(facts[i], settings["linking_top_k"]).indices.tolist()
                kept.append([ref.graph.facts[f] for f in ids])
                rows.append(ref.reset(ref.seed_choices(ref.entity_weights(ids, facts[i]))[0], dense[i]))
            p, _ = ref.ppr(torch.stack(rows), tol=settings["ppr_tol"], max_iters=settings["ppr_max_iters"])
            scores = ref.passage_scores(p)
        vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        for i in range(q.shape[0]):
            k = ks[s + i]
            docs = [ref.graph.passages[j] for j in idx[i, :k].tolist()]
            out.append(answer(questions[s + i], docs, vals[i, :k].tolist(), k,
                              kept[i] if with_facts else None))
    return out


def control_numbers(config, params, seed: int, count: int, device) -> dict:
    corpus = Corpus(seed, config["corpus"])
    questions = QuestionStream(corpus, seed).take(count)
    settings = config["hipporag"]
    ks = [settings["retrieval_top_k"]] * count
    entry = params.get("entry", "retrieve")
    rows = None
    if config.get("query_encoder"):
        from perfbench.reference import encoders

        control = encoders.rows(config, seed, questions, device, precision=encoders.LOWER[config["torch_dtype"]])
        rows = {kind: dict(zip(questions, t.cpu().numpy())) for kind, t in zip(encoders.KINDS, control)}
    ref, query_rows = run.reference_for(config, corpus, device, rows)
    fact_rows, passage_rows = query_rows(questions)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = device.type == "cuda"
    try:
        # every product in TF32
        answers = control_answers(ref.as_dtype(torch.float32), fact_rows.float(), passage_rows.float(), questions,
                                  ks, settings, entry, with_facts=entry == "retrieve")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    numbers = check.judge(ref, fact_rows, passage_rows, answers, graph=entry == "retrieve")
    if rows is not None:
        numbers["embed_err"] = check.embed_err((fact_rows, passage_rows),
                                               encoders.rows(config, seed, questions, device))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--answers", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    manifest = run.load_json(run.ROOT, "BENCHMARK.json")
    _cell, config, params, limits = run.cell_spec(manifest, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(config, params, seed, args.answers, torch.device("cuda", 0))
        failed = [n for n, v in numbers.items() if n in limits and v > limits[n]]
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers, "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
