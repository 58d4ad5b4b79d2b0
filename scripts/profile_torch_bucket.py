#!/usr/bin/env python3
"""Profile one retrieval bucket of the PyTorch port on a CUDA GPU.

Builds the phase-2 workload of ``chip_smoke.py`` (a 200k-node graph from 2M
sampled edges, 262,144 facts and 32,768 passages at D = 4096, a bucket of
128 queries), warms it up, and reports for one bucket:

- CUDA-event times (mean of 5 after a warm-up) of the whole bucket and of
  each stage; seeds (``seed_reset_batch``) and PPR (``batched_ppr_ell``) are
  also timed as separate calls on the bucket's own inputs, since
  ``graph_search_batch`` runs both;
- PPR iterations per column tile;
- under ``torch.profiler``: device busy time (the union of kernel, memcpy
  and memset intervals), the span from the first to the last device
  activity, the idle share of that span, and device time by kernel name.

With ``--encoder`` it profiles instead one batch of the on-device encoder
at BERT-base width (``chip_smoke.ENCODER``, bf16 compute): 128 passages of
500 words, the 512-token bucket that takes most of ``chip_smoke.py``
phase 4(c)'s time.

Usage, from the repository root on a machine with one CUDA GPU (no JAX):

    python3 scripts/profile_torch_bucket.py [--encoder] [--trace build/profile/bucket.json] [--top 12]

The chrome trace goes to ``--trace``; the last line of standard output is
one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hipporag_tpu_torch.models.retrieval import seed_reset_batch  # noqa: E402
from hipporag_tpu_torch.ops.pagerank import batched_ppr_ell  # noqa: E402
from hipporag_tpu_torch.ops.scoring import batched_scores, fact_topk  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def stage_times(bucket) -> dict:
    """CUDA-event ms of the bucket and its stages, each the mean of 5 calls."""
    sizes, index = bucket["sizes"], bucket["index"]
    k = sizes["link_top_k"]
    dpr = batched_scores(bucket["qp"], bucket["passage_emb"])
    cand_vals, cand_idx = fact_topk(bucket["qf"], bucket["fact_emb"], sizes["facts"], k)
    mask = cs.fallback_mask(bucket)
    reset, _dpr_norm, _p_valid = seed_reset_batch(index, cand_vals, cand_idx, mask, dpr, k, 0.05)
    stages = cs.run_bucket(bucket)[-1]
    out = {f"bucket_{name}": ms for name, ms in stages.items()}
    out["bucket"] = cs.time_ms(lambda: cs.run_bucket(bucket))
    out["seeds"] = cs.time_ms(lambda: seed_reset_batch(index, cand_vals, cand_idx, mask, dpr, k, 0.05))
    out["ppr"] = cs.time_ms(lambda: batched_ppr_ell(
        index.graph, reset, damping=cs.DAMPING, max_iters=cs.PPR_MAX_ITERS, tol=cs.PPR_TOL))
    return out


def merged_busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_profile(fn, trace_path: str, top: int, label: str = "bucket") -> dict:
    """One call of ``fn`` under torch.profiler, read back from its chrome trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(label):
            fn()
    os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("name") == label]
    out = {"trace": trace_path, "device_activities": len(dev),
           "host_span_ms": host[0]["dur"] / 1e3 if host else None}
    if not dev:
        # the profiler saw no device time: the CUDA-event times stand alone
        out.update(device_busy_ms=None, device_span_ms=None, idle_share=None, by_kernel=[])
        return out
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy = merged_busy_us(intervals)
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e["name"]][0] += float(e["dur"])
        by_name[e["name"]][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out.update(
        device_busy_ms=busy / 1e3,
        device_span_ms=span / 1e3,
        idle_share=1.0 - busy / span if span > 0 else 0.0,
        by_kernel=[{"name": name[:100], "ms": us / 1e3, "calls": calls, "share_of_busy": us / busy}
                   for name, (us, calls) in ranked],
    )
    return out


def profile_bucket(device, sizes, trace_path: str, top: int) -> dict:
    bucket = cs.build_bucket(device, sizes)
    for _ in range(2):  # CUDA context, cuBLAS handles and the kernel build
        cs.run_bucket(bucket)
    iters = cs.run_bucket(bucket)[3]
    result = {
        "stage_ms": stage_times(bucket),
        "ppr_iters_per_tile": iters[::128].tolist(),
        "profile": device_profile(lambda: cs.run_bucket(bucket), trace_path, top),
    }
    for name, ms in result["stage_ms"].items():
        cs.log(f"  {name:24s} {ms:10.3f} ms")
    log_profile(result["profile"])
    return result


def profile_encoder(device, trace_path: str, top: int, words: int = 500, seed: int = 0) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        model = cs.encoder_model(device, "bfloat16", tmp)
    texts = cs.synthetic_texts(np.random.default_rng(seed), cs.ENCODE_BATCH, (words, words))
    ids, mask = model.pretokenize(texts)

    def run():
        model.encode_pretokenized(ids, mask)
        cs.sync()

    result = {"batch": int(ids.shape[0]), "bucket": int(ids.shape[1]),
              "device_ms": cs.time_ms(lambda: model.encode_pretokenized(ids, mask)),
              "profile": device_profile(run, trace_path, top, label="encoder")}
    cs.log(f"encoder batch {result['batch']} x {result['bucket']}: {result['device_ms']:.3f} ms")
    log_profile(result["profile"])
    return result


def log_profile(prof: dict) -> None:
    if prof["device_busy_ms"] is None:
        cs.log("profiler: no device activity in the trace (device time not measured)")
    else:
        cs.log(f"profiler: device busy {prof['device_busy_ms']:.3f} ms in a "
               f"{prof['device_span_ms']:.3f} ms span, idle share {prof['idle_share']:.4f}")
        for row in prof["by_kernel"]:
            cs.log(f"  {row['ms']:9.3f} ms {row['share_of_busy']:7.2%} x{row['calls']:<5d} {row['name']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None, help="default build/profile/{bucket,encoder}.json")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--encoder", action="store_true", help="profile one encoder batch instead")
    args = ap.parse_args()
    trace = args.trace or os.path.join(ROOT, "build", "profile", "encoder.json" if args.encoder else "bucket.json")
    if not torch.cuda.is_available():
        print("profile_torch_bucket: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    cs.log(smi)
    device = torch.device("cuda", 0)
    if args.encoder:
        result = profile_encoder(device, trace, args.top)
    else:
        result = profile_bucket(device, cs.FULL, trace, args.top)
    result["gpu"] = smi
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
