#!/usr/bin/env python3
"""Drive the PyTorch port (hipporag_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA GPU, nvcc and PyTorch
built for CUDA (no JAX needed). It builds the hand-written CUDA kernel from
``hipporag_tpu_torch/csrc`` and runs three phases; any failure ends the run
with a non-zero exit:

1. Kernel vs plain: ``fused_score_topk`` (CUDA pass A) against
   ``fused_score_topk_reference`` (plain PyTorch pass A) and against
   ``score_and_topk`` on small shapes with padding and a constant row,
   then at the phase-2 shape, with CUDA-event times of both.
2. The retrieval device path at a realistic size (a 200k-node graph from
   2M sampled edges, 262,144 facts and 32,768 passages at D = 4096, a batch
   of 128 queries): DPR scores, fact top-k through the kernel, seeds, PPR
   and the document top-k, as ``HippoRAG._retrieve_batches`` strings them.
   Checks that the kernel ran, that a second run is bit-identical, and PPR
   against a float64 scipy power iteration.
3. The user entry points: ``HippoRAG(...).index()``, ``.retrieve()`` and
   ``.rag_qa()`` on the sample corpus with the mock LLM and embedder, held
   against ``tests/fixtures/torch_port_sample_expected.json`` (recorded
   from the JAX package on the CPU).

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from hipporag_tpu_torch import BaseConfig, HippoRAG, compute_mdhash_id, load_dataset  # noqa: E402
from hipporag_tpu_torch.models.retrieval import (  # noqa: E402
    RetrievalIndex,
    graph_search_batch,
    rank_documents_topk,
    seed_reset_batch,
)
from hipporag_tpu_torch.ops import _kernels, fused_topk  # noqa: E402
from hipporag_tpu_torch.ops.pagerank import (  # noqa: E402
    batched_ppr_ell,
    ell_from_coo,
    ell_gathered_rows_per_iter,
    normalize_symmetric_coo,
)
from hipporag_tpu_torch.ops.scoring import batched_scores, fact_topk, score_and_topk  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_sample_expected.json")

# phase-2 shape: the bench headline graph, NV-Embed-v2 width, one retrieval bucket
FULL = dict(nodes=200_000, edges=2_000_000, facts=262_144, passages=32_768, dim=4096,
            batch=128, link_top_k=5, retrieval_top_k=200)
DAMPING, PPR_TOL, PPR_MAX_ITERS = 0.5, 1e-6, 64
# the phase-1 grid (tests/test_pallas.py) plus the constant row
GRID = [(3, 1024, 384, 1000, 5), (8, 512, 128, 512, 8), (1, 640, 200, 7, 5), (4, 256, 64, 3, 5)]
# f32 dot products of D terms in another order: |err| <= ~sqrt(D) * 2^-24 * max|dot|
SCAN_RTOL = 1e-5


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call on the device (CUDA events), after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def peak_memory() -> int:
    return torch.cuda.max_memory_allocated()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare_topk(q, keys, valid_n, k):
    """Hold the kernel path against the plain pass A and the plain matmul +
    top-k; return the max |err| of the kernel's tile extrema."""
    tmax, tmin = fused_topk.scan_tiles(*_scan_args(q, keys), valid_n)
    rmax, rmin = fused_topk.scan_tiles_reference(*_scan_args(q, keys), valid_n)
    fin = torch.isfinite(rmax)
    check(torch.equal(fin, torch.isfinite(tmax)) and torch.equal(torch.isfinite(rmin), torch.isfinite(tmin)),
          "scan: finite pattern of tile extrema differs")
    err = max(float((tmax - rmax)[fin].abs().max()) if fin.any() else 0.0,
              float((tmin - rmin)[fin].abs().max()) if fin.any() else 0.0)
    scale = max(1.0, float(rmax[fin].abs().max()) if fin.any() else 1.0)
    check(err <= SCAN_RTOL * scale, f"scan: max|err| {err} > {SCAN_RTOL} * {scale}")

    norm, raw, idx = fused_topk.fused_score_topk(q, keys, valid_n, k)
    rnorm, _rraw, ridx = fused_topk.fused_score_topk_reference(q, keys, valid_n, k)
    _s, pvals, pidx = score_and_topk(q, keys, valid_n, k)
    kv = min(k, valid_n)
    for name, vals, ids in (("reference", rnorm, ridx), ("score_and_topk", pvals, pidx)):
        check(torch.equal(idx[:, :kv].long(), ids[:, :kv].long()), f"top-k indices differ from {name}")
        torch.testing.assert_close(norm[:, :kv], vals[:, :kv], rtol=1e-5, atol=1e-6)
    if kv < norm.shape[1]:
        check(bool((raw[:, kv:] == -torch.inf).all() and (norm[:, kv:] == 0).all()),
              "missing candidates must carry raw -inf and norm 0")
    dots = (q.double()[:, None, :] * keys[idx[:, :kv].long()].double()).sum(-1)
    torch.testing.assert_close(raw[:, :kv].double(), dots, rtol=1e-5, atol=1e-5)
    return err


def _scan_args(q, keys):
    """Pass A sees the padded shapes fused_score_topk gives it."""
    d_pad = -(-q.shape[1] // 16) * 16
    n_pad = -(-keys.shape[0] // fused_topk.TILE_N) * fused_topk.TILE_N
    return fused_topk._pad_to(q, q.shape[0], d_pad), fused_topk._pad_to(keys, n_pad, d_pad)


def phase1_grid(device):
    rng = np.random.default_rng(0)
    for b, n, d, valid_n, k in GRID:
        q = rng.standard_normal((b, d)).astype(np.float32)
        keys = np.zeros((n, d), np.float32)
        keys[:valid_n] = rng.standard_normal((valid_n, d))
        compare_topk(torch.from_numpy(q).to(device), torch.from_numpy(keys).to(device), valid_n, k)
    ones_q = torch.ones(2, 128, device=device)
    norm, _raw, _idx = fused_topk.fused_score_topk(ones_q, torch.ones(256, 128, device=device), 256, 4)
    check(bool((norm == 1.0).all()), "constant row must normalize to 1.0")
    log(f"phase 1: kernel == plain on the {len(GRID)}-shape grid and the constant row")


def make_embeddings(rng, rows, dim, device):
    x = torch.from_numpy(rng.standard_normal((rows, dim), dtype=np.float32)).to(device)
    return x / x.norm(dim=1, keepdim=True)


def near_queries(rng, emb, batch, device):
    """Queries near random rows of ``emb``, so top-k picks have real margins."""
    pick = torch.from_numpy(rng.choice(emb.shape[0], batch, replace=False)).to(device)
    noise = torch.from_numpy(rng.standard_normal((batch, emb.shape[1]), dtype=np.float32)).to(device)
    q = emb[pick] + 0.02 * noise
    return q / q.norm(dim=1, keepdim=True)


def phase1_big(qf, fact_emb, num_facts, k):
    err = compare_topk(qf, fact_emb, num_facts, k)
    qs, ks = _scan_args(qf, fact_emb)
    times = {}
    # plain, kernel, kernel, plain: both sides see the same card state
    for name, fn in (
        ("scan_plain", lambda: fused_topk.scan_tiles_reference(qs, ks, num_facts)),
        ("scan_kernel", lambda: fused_topk.scan_tiles(qs, ks, num_facts)),
        ("fused_topk_kernel", lambda: fused_topk.fused_score_topk(qf, fact_emb, num_facts, k)),
        ("fused_topk_plain_scan", lambda: fused_topk.fused_score_topk_reference(qf, fact_emb, num_facts, k)),
        ("score_and_topk", lambda: score_and_topk(qf, fact_emb, num_facts, k)),
    ):
        times[name] = [time_ms(fn)]
    for name in ("scan_kernel", "scan_plain"):
        fn = (fused_topk.scan_tiles if name == "scan_kernel" else fused_topk.scan_tiles_reference)
        times[name].append(time_ms(lambda fn=fn: fn(qs, ks, num_facts)))
    ms = {name: float(np.mean(v)) for name, v in times.items()}
    log(f"phase 1 at B={qf.shape[0]} N={fact_emb.shape[0]} D={fact_emb.shape[1]} k={k}: "
        f"scan max|err| {err:.3e}; ms {json.dumps(ms)}")
    return err, ms


def synthetic_graph(num_nodes, num_edges, seed=0):
    """Directed COO entries with a heavy-tailed out-degree (bench.build_synthetic_graph)."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, num_nodes + 1) ** 0.6
    weights /= weights.sum()
    src = rng.choice(num_nodes, size=num_edges, p=weights)
    dst = rng.integers(0, num_nodes, size=num_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.5, 2.0, size=len(src)).astype(np.float32)
    return src.astype(np.int64), dst.astype(np.int64), w


def scipy_ppr(src, dst, w_norm, dangling, num_nodes, reset, damping, tol=1e-10, max_iters=1000):
    """Float64 power iteration of p = (1-d) r + d (T p + (dangling . p) r)."""
    import scipy.sparse as sp

    t = sp.csr_matrix(
        (w_norm.astype(np.float64), (dst, src)), shape=(num_nodes, num_nodes)
    )
    r = np.maximum(np.nan_to_num(reset.astype(np.float64).T), 0.0)  # [N, b]
    r = r / r.sum(0, keepdims=True)
    dang = dangling[:num_nodes].astype(np.float64)
    p = r.copy()
    for _ in range(max_iters):
        nxt = (1 - damping) * r + damping * (t @ p + (dang @ p)[None, :] * r)
        done = np.abs(nxt - p).max() < tol
        p = nxt
        if done:
            return p.T
    raise AssertionError("scipy reference PPR did not converge")


def build_bucket(device, sizes, seed=0):
    """The phase-2 index, embeddings and one bucket of queries, made from ``seed``."""
    rng = np.random.default_rng(seed)
    n, f, p, d, b = sizes["nodes"], sizes["facts"], sizes["passages"], sizes["dim"], sizes["batch"]
    t0 = time.perf_counter()
    src, dst, w = synthetic_graph(n, sizes["edges"], seed)
    node_cap = -(-(n + 1) // 128) * 128  # the last slot is the padding node
    s2, d2, w2, dangling = normalize_symmetric_coo(src, dst, w, n, node_cap)
    ell = ell_from_coo(s2, d2, w2, dangling, n, node_cap)
    fact_subj = rng.integers(0, n - p, f).astype(np.int32)
    fact_obj = rng.integers(0, n - p, f).astype(np.int32)
    counts = np.zeros(node_cap, np.float32)
    counts[: n - p] = rng.integers(1, 4, n - p)
    index = RetrievalIndex(
        graph=ell.to(device),
        fact_subj_node=torch.from_numpy(fact_subj).to(device),
        fact_obj_node=torch.from_numpy(fact_obj).to(device),
        node_chunk_counts=torch.from_numpy(counts).to(device),
        passage_node_ids=torch.arange(n - p, n, dtype=torch.int32, device=device),
        num_facts=f,
        num_passages=p,
    )
    fact_emb = make_embeddings(rng, f, d, device)
    passage_emb = make_embeddings(rng, p, d, device)
    qf = near_queries(rng, fact_emb, b, device)
    qp = near_queries(rng, passage_emb, b, device)
    sync()
    setup_s = time.perf_counter() - t0
    log(f"phase 2 set-up: {n} nodes, {len(s2)} directed entries, F={f} P={p} D={d} B={b}; {setup_s:.1f} s")
    return dict(sizes=sizes, index=index, fact_emb=fact_emb, passage_emb=passage_emb, qf=qf, qp=qp,
                coo=(s2, d2, w2, dangling), setup_s=setup_s)


def fallback_mask(bucket):
    """The host rerank keeps every candidate; the last two queries keep none
    and take the DPR fallback."""
    sizes = bucket["sizes"]
    top_mask = torch.ones(sizes["batch"], sizes["link_top_k"], device=bucket["qf"].device)
    top_mask[-2:] = 0.0
    return top_mask


def run_bucket(bucket):
    """The device calls of _retrieve_batches for one bucket, each timed."""
    sizes, index = bucket["sizes"], bucket["index"]
    k = sizes["link_top_k"]
    stage = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    dpr = batched_scores(bucket["qp"], bucket["passage_emb"])
    ev[1].record()
    cand_vals, cand_idx = fact_topk(bucket["qf"], bucket["fact_emb"], sizes["facts"], k)
    ev[2].record()
    doc_scores, iters = graph_search_batch(
        index, cand_vals, cand_idx, fallback_mask(bucket), dpr, link_top_k=k,
        damping=DAMPING, ppr_max_iters=PPR_MAX_ITERS, ppr_tol=PPR_TOL, return_iters=True,
    )
    ev[3].record()
    order, vals = rank_documents_topk(doc_scores, sizes["retrieval_top_k"])
    ev[4].record()
    sync()
    for i, name in enumerate(("dpr_scores", "fact_topk", "graph_search", "rank_topk")):
        stage[name] = ev[i].elapsed_time(ev[i + 1])
    return cand_vals, cand_idx, doc_scores, iters, order, vals, stage


def phase2(device, sizes, seed=0):
    bucket = build_bucket(device, sizes, seed)
    index, qp, passage_emb = bucket["index"], bucket["qp"], bucket["passage_emb"]
    s2, d2, w2, dangling = bucket["coo"]
    n, p, b, k = sizes["nodes"], sizes["passages"], sizes["batch"], sizes["link_top_k"]

    err, ms = phase1_big(bucket["qf"], bucket["fact_emb"], sizes["facts"], k)

    torch.cuda.reset_peak_memory_stats()
    fused_topk.SCAN_LAUNCHES.reset()
    cand_vals, cand_idx, doc_scores, iters, order, vals, stage = run_bucket(bucket)
    launches = fused_topk.SCAN_LAUNCHES.count
    check(launches > 0, "phase 2: the fused kernel was not launched")
    peak = peak_memory()
    _, _, doc2, _, order2, _, stage2 = run_bucket(bucket)
    check(torch.equal(doc_scores, doc2) and torch.equal(order, order2),
          "phase 2: a second run is not bit-identical")
    check(tuple(doc_scores.shape) == (b, p) and bool(torch.isfinite(doc_scores).all()),
          "phase 2: doc scores must be finite [B, P]")
    check(tuple(order.shape) == (b, sizes["retrieval_top_k"]) and bool((order < p).all()),
          "phase 2: document top-k out of range")

    # (c) PPR of four queries against float64 scipy
    top_mask = torch.ones(4, k, device=device)
    reset, _dpr_norm, _pv = seed_reset_batch(
        index, cand_vals[:4], cand_idx[:4], top_mask, batched_scores(qp[:4], passage_emb), k, 0.05
    )
    ppr4 = batched_ppr_ell(index.graph, reset, damping=DAMPING, max_iters=PPR_MAX_ITERS, tol=PPR_TOL)
    ref4 = scipy_ppr(s2, d2, w2, dangling, n, reset[:, :n].cpu().numpy(), DAMPING)
    got4 = ppr4[:, :n].double().cpu().numpy()
    ppr_err = float(np.abs(got4 - ref4).max())
    top20 = float(np.mean([
        np.array_equal(np.argsort(-got4[i], kind="stable")[:20], np.argsort(-ref4[i], kind="stable")[:20])
        for i in range(4)
    ]))
    check(ppr_err <= 1e-6, f"phase 2: PPR max|err| vs float64 scipy {ppr_err} > 1e-6")

    tile_iters = iters[:: 128].tolist()
    detail = {
        "stage_ms_first_run": stage,
        "stage_ms_second_run": stage2,
        "ppr_iters_per_tile": tile_iters,
        "gathered_rows_per_iter": ell_gathered_rows_per_iter(index.graph),
        "peak_memory_bytes": peak,
        "ppr_max_abs_err_vs_scipy_f64": ppr_err,
        "ppr_top20_agreement": top20,
        "kernel_launches": launches,
        "setup_s": bucket["setup_s"],
    }
    log("phase 2: " + json.dumps(detail))
    return err, ms, launches, detail


def phase3(device):
    with open(FIXTURE) as fh:
        expected = json.load(fh)["queries"]
    docs, queries, gold_docs, gold_answers = load_dataset("sample", os.path.join(ROOT, "data"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cfg = BaseConfig(llm_name="mock", embedding_model_name="mock",
                         vector_store_type="memory", save_dir=tmp)
        rag = HippoRAG(cfg, device=device)
        rag.index(docs)
        fused_topk.SCAN_LAUNCHES.reset()
        t0 = time.perf_counter()
        sols = rag.retrieve(queries)
        sync()
        wall = time.perf_counter() - t0
        launches = fused_topk.SCAN_LAUNCHES.count
        check(launches > 0, "phase 3: retrieve did not launch the fused kernel")
        qa_sols = rag.rag_qa(queries, gold_docs=gold_docs, gold_answers=gold_answers)[0]
    for exp, sol, qa in zip(expected, sols, qa_sols):
        for got in (sol, qa):
            ids = [compute_mdhash_id(doc, "chunk-") for doc in got.docs]
            check(got.question == exp["question"] and ids == exp["ranked_passage_ids"],
                  f"phase 3: ranked passages differ from the JAX package for {exp['question']!r}")
        check(qa.answer == exp["answer"], f"phase 3: answer {qa.answer!r} != {exp['answer']!r}")
    check(len(sols) == len(expected), "phase 3: query count differs from the fixture")
    log(f"phase 3: index/retrieve/rag_qa on {len(docs)} passages, {len(queries)} queries "
        f"match the JAX package; retrieve wall {wall * 1e3:.1f} ms, {launches} kernel launches")
    return {"retrieve_wall_ms": wall * 1e3, "kernel_launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    precision = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"float32 matmul precision {precision}; cuda.matmul.allow_tf32 {tf32}")
    check(precision == "highest" and tf32 is False, "TF32 must stay off")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    start = time.perf_counter()
    _kernels.load("fused_topk_scan")
    build_s, build_log = _kernels.build_info.get("fused_topk_scan", (0.0, ""))
    log(f"kernel build: fused_topk_scan.cu {build_s:.1f} s (load {time.perf_counter() - start:.1f} s)")
    for line in build_log.strip().splitlines():
        log(f"  nvcc: {line}")

    phase1_grid(device)
    err, ms, launches, detail = phase2(device, FULL)
    detail["phase1_ms"] = ms
    detail["phase3"] = phase3(device)
    log("phase 3: " + json.dumps(detail["phase3"]))

    kernels = [{
        "name": "fused_topk_scan",
        "route": "cuda",
        "source": "hipporag_tpu_torch/csrc/fused_topk_scan.cu",
        "replaces": "hipporag_tpu/ops/fused_topk.py:58",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms["scan_kernel"],
        "plain_ms": ms["scan_plain"],
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
