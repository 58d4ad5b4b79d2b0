#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU: builds the
cell's deployment of ``hipporag_tpu_torch`` from the seed, warms up its
shapes (set-up), drives its traffic for ``--seconds``, judges a sample of
the answers against the plain reference (``reference/``), and prints one
JSON line last on standard output. ``--trace 1`` profiles a sub-window and
reports the cell's per-layer metrics instead of its end-to-end ones; its
``breakdown`` gives, beside the longest device operations and idle gaps,
the device seconds of the kernels launched inside each ``retrieve/*``
range (``range_device_s``) and the profiled calls' least seconds by stage
(``least_s``).

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration file, ``traffic/<traffic>.json`` (whose ``driver`` key names
``drivers/<driver>.py``), ``workloads/<cell>.json`` (the cell's own
parameters and the limits of its comparison), ``metrics/<metric>.py`` and,
where the configuration names a question encoder (``query_encoder``),
``encoders/<name>.py`` and its reference ``reference/encoders/<name>.py``.
It fails, printing no result, without a CUDA device or with fewer than the
cell asks for, and if JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "hipporag_tpu")
BUILD = os.path.join(ROOT, "build")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(BUILD, sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


class Context:
    """What a driver and the metric readers see of one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cell_spec(manifest: dict, name: str, root: str = ROOT):
    """(cell, configuration, traffic parameters, limits) of the cell ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config_entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = load_json(root, config_entry["file"])
    bench = os.path.join(root, "perfbench")
    params = dict(load_json(bench, "traffic", cell["traffic"] + ".json"))
    own = load_json(bench, "workloads", name + ".json")
    params.update(own.get("params", {}))
    return cell, config, params, own["limits"]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metric(name: str, mctx, root: str = ROOT):
    reader = load_file_module(os.path.join(root, "perfbench", "metrics", name + ".py"),
                              "perfbench.metrics._" + name.replace(".", "_"))
    return reader.read(mctx)


def execute(manifest: dict, name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
            spec=None) -> tuple:
    """One run of the cell ``name`` on ``device``: (result line, checks)."""
    import torch

    from perfbench import check, work
    from perfbench.deployment import Deployment

    cell, config, params, limits = spec or cell_spec(manifest, name)
    dep = Deployment(config, seed, device)
    driver_mod = importlib.import_module(f"perfbench.drivers.{params['driver']}")
    ctx = Context(dep=dep, params=params, seconds=seconds, trace=trace, seed=seed)
    driver = driver_mod.Driver(ctx)
    cuda = device.type == "cuda"
    pauses = []

    def gc_clock(phase, info):
        pauses.append((phase, info["generation"], time.perf_counter()))

    try:
        driver.prepare()
        if cuda:
            # the window's peak: the deployment's state and what its calls use
            torch.cuda.reset_peak_memory_stats(device)
        # every run starts its window at the same point of the collector's
        # cycle, so the window's own collections fall alike in every run
        gc.collect()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        gc.callbacks.append(gc_clock)
        try:
            out = driver.measure()
        finally:
            gc.callbacks.remove(gc_clock)
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        driver.close()
    full = [(a[2], b[2]) for a, b in zip(pauses, pauses[1:]) if a[0] == "start" and a[1] == 2 and b[0] == "stop"]
    spent = sum(b[2] - a[2] for a, b in zip(pauses, pauses[1:]) if a[0] == "start" and b[0] == "stop")
    print(f"perfbench: window garbage collection {len(pauses) // 2} runs, {spent:.3f} s; "
          f"{len(full)} full, {sum(e - s for s, e in full):.3f} s", file=sys.stderr)
    print(f"perfbench: set-up {json.dumps({k: round(v, 3) for k, v in dep.timings.items()})}, "
          f"graph {json.dumps(dep.graph_info)}", file=sys.stderr)

    # the program's state goes before the reference runs on the device
    corpus = dep.corpus
    dep.close()
    del dep, driver, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref, query_rows = reference_for(config, corpus, device, out.get("query_rows"))
    answers = out["answers"]
    questions = [a["question"] for a in answers]
    fact_rows, passage_rows = query_rows(questions)
    numbers = check.judge(ref, fact_rows, passage_rows, answers, graph=params.get("entry", "retrieve") == "retrieve")
    if config.get("query_encoder"):
        from perfbench.reference import encoders

        numbers["embed_err"] = check.embed_err((fact_rows, passage_rows),
                                               encoders.rows(config, seed, questions, device))
    correct, rows = check.verdict(numbers, limits)
    print(f"perfbench: judged {len(answers)} answers in {time.perf_counter() - t_ref:.1f} s; reference graph "
          f"{ref.graph.num_nodes} nodes, {ref.graph.num_entries} entries, {len(ref.graph.facts)} facts, "
          f"{ref.graph.num_synonymy} synonymy entries, {ref.graph.near_threshold} within 1e-6 of the threshold",
          file=sys.stderr)

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]), "failed": int(out["failed"])}
    if trace:
        t_work = time.perf_counter()
        calls = out["calls"]
        stages = work.call_stages(ref, calls, config, query_rows)
        traced_stages = [st for st, c in zip(stages, calls) if c["traced"]]
        mctx = Context(counters=out["counters"], trace=out["trace"], window_s=out["window_s"], stages=stages,
                       traced_stages=traced_stages)
        metrics = {}
        for m in manifest["per_layer"]:
            if applies(m, name):
                value = read_metric(m["name"], mctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        print(f"perfbench: work counted in {time.perf_counter() - t_work:.1f} s", file=sys.stderr)
        t = out["trace"] or {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
        device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
        least = {}
        for st in traced_stages:
            for stage, seconds in st.items():
                least[stage] = least.get(stage, 0.0) + seconds
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"],
                               "range_device_s": largest(t.get("range_device_s", {})), "least_s": largest(least)}
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in manifest["end_to_end"] if applies(m, name) and m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {n: {"value": value, "limit": limit} for n, value, limit in rows}
    return result, rows


def largest(seconds: dict, top: int = 10) -> list:
    """[[name, seconds], ...] of the ``top`` largest, largest first."""
    return [[name, value] for name, value in sorted(seconds.items(), key=lambda kv: -kv[1])[:top]]


def reference_for(config: dict, corpus, device, program_rows: dict = None):
    """(float64 plain reference over ``corpus``, ``query_rows``) for
    ``config``. ``query_rows(questions)`` gives the float64 (fact rows,
    passage rows) the timed path used: the hashing rows for both, or, where
    the configuration names a question encoder, the program's own rows
    ``program_rows`` ({"triple": {question: row}, "passage": {...}})."""
    import numpy as np
    import torch

    from perfbench import vectors
    from perfbench.reference.encoders import KINDS
    from perfbench.reference.retrieval import Reference

    dim = int(config["index_vectors"]["dim"])

    def embed(texts):
        return vectors.embed_texts(texts, dim, device)

    def query_rows(qs):
        if program_rows is None:
            rows = embed(qs).double()
            return rows, rows
        return tuple(torch.from_numpy(np.stack([program_rows[kind][q] for q in qs])).to(device, torch.float64)
                     for kind in KINDS)

    return Reference(corpus.openie(), config["hipporag"], embed, device), query_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_json(ROOT, "BENCHMARK.json")
    cell = cell_spec(manifest, args.workload)[0]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, rows = execute(manifest, args.workload, args.seed % (1 << 63), args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
