#!/usr/bin/env python3
"""The stage spans of one benchmark cell on a CUDA GPU, and their cost.

Usage, from the repository root on a machine with one CUDA GPU (no JAX):

    python3 scripts/span_report.py [--workload nvembed2-musique.batch] [--seed N] [--seconds 20] [--calls 5]

1. Span cost on the host: the mean nanoseconds of one ``span`` with its
   attrs and of one ``count``, off and inside ``recording()``, over
   200,000 of each (the median of 7 repeats).
2. Span overhead (``--calls`` > 0): the cell's deployment is built from
   the seed and warmed up, then ``--calls`` engine calls run with
   ``recording()`` on and as many with it off, in turns (off, on, on,
   off, ...), no profiler running; each call's wall time ends in a device
   synchronise. Reports the median of each side.
3. One traced run of the cell (``perfbench/run.py --trace 1`` in process),
   its result line kept whole, every idle gap of the profiled call kept
   (the result line keeps ten), and from the program's span log the
   profiled call's time by stage: for each span name its count and summed
   milliseconds, and the share of its ``retrieve`` span that its direct
   children cover.

Prints one JSON object as the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import run, trace  # noqa: E402
from hipporag_tpu_torch.utils.timing import count, recording, reset_spans, span, spans  # noqa: E402

NO_STAGE = ("(no host operation)", "retrieve")


def span_cost(n: int = 200_000, repeats: int = 7) -> dict:
    def per_call(fn):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t0) / n

    def one_span():
        with span("retrieve/filter", bucket=3):
            pass

    def one_count():
        count("iterations", 7)

    out = defaultdict(list)
    for _ in range(repeats):
        for name, fn in (("span", one_span), ("count", one_count)):
            out[name + "_off_ns"].append(per_call(fn))
            with recording():
                out[name + "_recording_ns"].append(per_call(fn))
            reset_spans()
    return {k: statistics.median(v) for k, v in out.items()}


def overhead(cell: str, seed: int, calls: int, device) -> dict:
    from perfbench.deployment import Deployment

    _cell, config, params, _limits = run.cell_spec(run.load_json(ROOT, "BENCHMARK.json"), cell)
    dep = Deployment(config, seed, device)
    entry = getattr(dep.rag, params["entry"])
    per_call = int(params["questions_per_call"])
    try:
        entry(dep.take_questions(per_call))  # warm-up
        walls = {"off": [], "on": []}
        order = ["off", "on", "on", "off"] * ((calls + 1) // 2)
        for side in order[: 2 * calls]:
            qs = dep.take_questions(per_call)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            if side == "on":
                with recording():
                    entry(qs)
            else:
                entry(qs)
            torch.cuda.synchronize(device)
            walls[side].append(time.perf_counter() - t0)
    finally:
        dep.close()
    med = {k: statistics.median(v) for k, v in walls.items()}
    return {"calls_s": walls, "median_s": med, "questions_per_call": per_call,
            "on_over_off": med["on"] / med["off"]}


def stage_breakdown(log) -> dict:
    roots = [s for s in log if s.name == "retrieve" and s.parent_id is None]
    if not roots:
        return {}
    root = roots[-1]
    call = [s for s in log if s.call_id == root.call_id]
    by_name = defaultdict(lambda: [0, 0.0])
    for s in call:
        by_name[s.name][0] += 1
        by_name[s.name][1] += s.seconds * 1e3
    covered = []
    for s in sorted((c for c in call if c.parent_id == root.span_id), key=lambda c: c.start_ns):
        if covered and s.start_ns <= covered[-1][1]:
            covered[-1][1] = max(covered[-1][1], s.end_ns)
        else:
            covered.append([s.start_ns, s.end_ns])
    child_ns = sum(e - s for s, e in covered)
    return {"retrieve_ms": root.seconds * 1e3,
            "children_cover": child_ns / max(1, root.end_ns - root.start_ns),
            "stages": {name: {"count": n, "ms": ms} for name, (n, ms) in sorted(by_name.items())},
            "ppr": {k: sum(s.attrs.get(k, 0) for s in call if s.name == "retrieve/ppr")
                    for k in ("tiles", "iterations", "kernel_iterations")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="nvembed2-musique.batch")
    ap.add_argument("--seed", type=int, default=2**31 + 12)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(device), "workload": args.workload, "seed": args.seed,
           "span_cost": span_cost()}
    if args.calls > 0:
        out["overhead"] = overhead(args.workload, args.seed + 1, args.calls, device)
        print("span_report: overhead " + json.dumps(out["overhead"]), file=sys.stderr, flush=True)

    # every idle gap, not the ten the result line keeps
    reduce_events = trace.reduce_events
    trace.reduce_events = lambda events, window_s, top=10: reduce_events(events, window_s, 10**9)
    try:
        result, _rows = run.execute(run.load_json(ROOT, "BENCHMARK.json"), args.workload, args.seed % (1 << 63),
                                    args.seconds, True, device, time.perf_counter())
    finally:
        trace.reduce_events = reduce_events
    gaps = result["breakdown"]["idle_gaps"]
    idle = sum(s for _name, s in gaps)
    out["result"] = result
    out["idle_gaps_s"] = idle
    out["unstaged_idle_share"] = sum(s for name, s in gaps if name in NO_STAGE) / idle if idle else None
    out["spans"] = stage_breakdown(spans())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
