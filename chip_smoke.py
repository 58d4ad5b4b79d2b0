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
   with float32 and bfloat16 keys; a near-tie case (tile maxima and minima
   closer than pass A's error), through the kernel and through a pass A
   perturbed against the true order; then the phase-2 shape with both key
   types, with CUDA-event times, and a sweep over the bucket sizes
   B = 8, 32, 128.
2. The retrieval device path at a realistic size (a 200k-node graph from
   2M sampled edges, 262,144 facts and 32,768 passages at D = 4096, a batch
   of 128 queries): DPR scores, fact top-k through the kernel, seeds, PPR
   and the document top-k, as ``HippoRAG._retrieve_batches`` strings them.
   Checks that the kernel ran, that a second run is bit-identical, and PPR
   against a float64 scipy power iteration.
3. The user entry points: ``HippoRAG(...).index()``, ``.retrieve()`` and
   ``.rag_qa()`` on the sample corpus with the mock LLM and embedder, held
   against ``tests/fixtures/torch_port_sample_expected.json`` (recorded
   from the JAX package on the CPU), with ``compute_dtype`` float32 and
   bfloat16 (bf16 keys through the kernel).
4. The on-device encoder at BERT-base width (``jax/random-768x12``:
   hidden 768, 12 layers, 12 heads, FFN 3072): (a) the embeddings of 16
   texts spanning the buckets 16-512, in bf16 and f32 compute, held to
   ``tests/fixtures/torch_port_encoder_768x12.npz`` (the JAX package on the
   CPU) within the bounds stored there; (b) the lengths path and the
   full-mask path bit-equal, a zero-length row giving zeros; (c) 16,384
   synthetic passages of 48-500 words in bf16, batches of 128 sorted by
   length: tokens/s, ms per batch by bucket, the share of the bf16 dense
   peak, peak memory, and ``batch_encode`` over 2,048 of them unsorted;
   (d) 1,024 of them in f32; (e) one bucket of 128 queries of 8-24 words.
5. The dense entry points on the encoder (f32): ``HippoRAG`` index ->
   retrieve -> rag_qa, ``retrieve_dpr``, ``rag_qa_dpr``,
   ``dense_passage_retrieval`` and ``StandardRAG`` index -> retrieve ->
   rag_qa on the sample corpus, held to
   ``tests/fixtures/torch_port_encoder_sample_expected.json`` (the JAX
   package on the CPU), with the kernel launched by ``retrieve``; then the
   CLI, ``python -m hipporag_tpu_torch``, once as a subprocess.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
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

from hipporag_tpu_torch import (  # noqa: E402
    BaseConfig,
    HippoRAG,
    StandardRAG,
    compute_mdhash_id,
    load_dataset,
)
from hipporag_tpu_torch.embedding.encoder import TorchEncoderEmbeddingModel  # noqa: E402
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
ENCODER_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_encoder_768x12.npz")
ENTRY_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_encoder_sample_expected.json")

# phase-2 shape: the bench headline graph, NV-Embed-v2 width, one retrieval bucket
FULL = dict(nodes=200_000, edges=2_000_000, facts=262_144, passages=32_768, dim=4096,
            batch=128, link_top_k=5, retrieval_top_k=200)
DAMPING, PPR_TOL, PPR_MAX_ITERS = 0.5, 1e-6, 64
# the phase-1 grid (tests/test_pallas.py) plus the constant row
GRID = [(3, 1024, 384, 1000, 5), (8, 512, 128, 512, 8), (1, 640, 200, 7, 5), (4, 256, 64, 3, 5)]
# kernel (3xTF32, f32 sums per 32-deep stage) vs cuBLAS f32: ~1e-7 of the
# score scale in practice; scan_delta gives the kernel's worst case
SCAN_RTOL = 1e-5
# near ties on the card: 2^-22 apart, inside the kernel's split error
NEAR_TIE_EPS = 2.0**-22
# the adversarial pass A of the CPU test (tests/test_torch_fused_topk.py)
PERTURB_DELTA, PERTURB_EPS = 1e-3, 4e-4
SWEEP_BATCHES = (8, 32, 128)
# phase 4: BERT-base width; NVIDIA's dense peaks of one H100 SXM at 700 W
ENCODER = "jax/random-768x12"
BF16_PEAK_FLOPS, F32_PEAK_FLOPS = 989e12, 67e12
PASSAGES, PASSAGE_WORDS, ENCODE_BATCH = 16_384, (48, 500), 128
UNSORTED_PASSAGES = 2_048
F32_PASSAGES, QUERIES, QUERY_WORDS = 1_024, 128, (8, 24)
# phase 5: doc scores are min-max normalized over passages whose raw scores
# lie close together, which magnifies the encoder's ~1e-7 differences to
# ~1e-5; rankings, answers and metrics are compared exactly
ENTRY_SCORE_ATOL = 1e-4


def scan_delta(q, keys):
    """Worst-case |error| of one kernel tile extremum against exact
    arithmetic (csrc/fused_topk_scan.cu): the TF32 split, 3 * 2^-22 (bf16
    keys 2^-22), plus f32 sums, 96 terms on the tensor core (2^-23 each,
    it does not round to nearest) and D / 32 promoted partials (2^-24
    each), all times the largest sum_i |q_i||k_i|."""
    split = 2.0**-22 * (1 if keys.dtype == torch.bfloat16 else 3)
    acc = 96 * 2.0**-23 + (keys.shape[1] // 32) * 2.0**-24
    mag = max(float((q.abs() @ keys[i:i + 65536].float().abs().T).max())
              for i in range(0, keys.shape[0], 65536))
    return (split + acc) * mag


def scan_layouts():
    """Dynamic shared memory and ring stages of each kernel instance."""
    fn = _kernels.load("fused_topk_scan").fused_topk_scan_layout
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for tag, bf16 in (("f32", 0), ("bf16", 1)):
        for width in fused_topk.QUERY_WIDTHS:
            smem, stages = ctypes.c_int(), ctypes.c_int()
            check(fn(width, bf16, ctypes.byref(smem), ctypes.byref(stages)) == 0, f"no kernel of width {width}")
            out[f"{tag} width {width}"] = [smem.value, stages.value]
    return out


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
    d_pad = -(-q.shape[1] // fused_topk._DEPTH_MULTIPLE) * fused_topk._DEPTH_MULTIPLE
    n_pad = -(-keys.shape[0] // fused_topk.TILE_N) * fused_topk.TILE_N
    return fused_topk._pad_to(q, q.shape[0], d_pad), fused_topk._pad_to(keys, n_pad, d_pad)


def phase1_grid(device):
    rng = np.random.default_rng(0)
    errs = {}
    for key_dtype in (torch.float32, torch.bfloat16):
        for b, n, d, valid_n, k in GRID:
            q = rng.standard_normal((b, d)).astype(np.float32)
            keys = np.zeros((n, d), np.float32)
            keys[:valid_n] = rng.standard_normal((valid_n, d))
            keys = torch.from_numpy(keys).to(device, key_dtype)
            err = compare_topk(torch.from_numpy(q).to(device), keys, valid_n, k)
            errs[str(key_dtype)] = max(errs.get(str(key_dtype), 0.0), err)
        ones_q = torch.ones(2, 128, device=device)
        ones_k = torch.ones(256, 128, device=device, dtype=key_dtype)
        norm, _raw, _idx = fused_topk.fused_score_topk(ones_q, ones_k, 256, 4)
        check(bool((norm == 1.0).all()), f"constant row must normalize to 1.0 ({key_dtype} keys)")
    log(f"phase 1: kernel == plain on the {len(GRID)}-shape grid and the constant row, "
        f"f32 and bf16 keys; scan max|err| {json.dumps(errs)}")


def near_tie_inputs(rng, eps, device, n_tiles=8, d=64):
    """Row r scores key column r exactly (q = e_r): its 3rd and 4th tile
    maxima, and its two lowest tile minima, lie ``eps`` apart
    (tests/test_torch_fused_topk.py builds the same case)."""
    b, n = 2, n_tiles * fused_topk.TILE_N
    keys = rng.uniform(0.1, 0.5, (n, d)).astype(np.float32)
    q = np.zeros((b, d), np.float32)
    tiles = []
    for r in range(b):
        q[r, r] = 1.0
        t = rng.permutation(n_tiles)[:6]
        for tile, value in zip(t, (0.95, 0.9, 0.8, 0.8 - eps, -0.5, -0.5 + eps)):
            keys[tile * fused_topk.TILE_N + rng.integers(fused_topk.TILE_N), r] = value
        tiles.append(t)
    return torch.from_numpy(q).to(device), torch.from_numpy(keys).to(device), tiles


def phase1_near_ties(device, k=3):
    """The widened refine keeps the top-k exact where pass A cannot order
    the tiles: ties 2^-22 apart through the kernel, and ties 4e-4 apart
    under a pass A moved by up to 1e-3 against the true order."""
    rng = np.random.default_rng(7)
    for seed in range(3):
        q, keys, _tiles = near_tie_inputs(rng, NEAR_TIE_EPS, device)
        compare_topk(q, keys, keys.shape[0], k)
        q, keys, tiles = near_tie_inputs(rng, PERTURB_EPS, device)

        def perturbed(qs, ks, valid_n, tiles=tiles, seed=seed):
            tmax, tmin = fused_topk.scan_tiles(qs, ks, valid_n)
            noise = np.random.default_rng(seed + 100)
            tmax = tmax + torch.from_numpy(
                noise.uniform(-PERTURB_DELTA, PERTURB_DELTA, tuple(tmax.shape)).astype(np.float32)).to(device)
            tmin = tmin + torch.from_numpy(
                noise.uniform(-PERTURB_DELTA, PERTURB_DELTA, tuple(tmin.shape)).astype(np.float32)).to(device)
            for r, t in enumerate(tiles):
                tmax[r, t[2]] -= 0.9 * PERTURB_DELTA
                tmax[r, t[3]] += 0.9 * PERTURB_DELTA
                tmin[r, t[4]] += 0.9 * PERTURB_DELTA
                tmin[r, t[5]] -= 0.9 * PERTURB_DELTA
            return tmax, tmin

        n = keys.shape[0]
        want = fused_topk.fused_score_topk_reference(q, keys, n, k)
        got = fused_topk._fused_topk(perturbed, q, keys, n, k)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "near ties: the widened refine differs from the plain path under a perturbed pass A")
        narrow = fused_topk._fused_topk(perturbed, q, keys, n, k, extra_tiles=0, min_tiles=1)
        check(not torch.equal(narrow[2], want[2]), "near ties: the case does not need the widening")
    log("phase 1: near ties (2^-22 through the kernel, 4e-4 under a 1e-3 perturbation) stay exact")


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
    """The phase-2 shape with f32 and bf16 keys: errors, CUDA-event times,
    and the bucket-size sweep."""
    fact_bf16 = fact_emb.to(torch.bfloat16)
    out = {}
    for tag, keys in (("f32", fact_emb), ("bf16", fact_bf16)):
        err = compare_topk(qf, keys, num_facts, k)
        qs, ks = _scan_args(qf, keys)
        times = {}
        # plain, kernel, kernel, plain: both sides see the same card state
        for name, fn in (
            ("scan_plain", lambda: fused_topk.scan_tiles_reference(qs, ks, num_facts)),
            ("scan_kernel", lambda: fused_topk.scan_tiles(qs, ks, num_facts)),
            ("fused_topk_kernel", lambda: fused_topk.fused_score_topk(qf, keys, num_facts, k)),
            ("fused_topk_plain_scan", lambda: fused_topk.fused_score_topk_reference(qf, keys, num_facts, k)),
            ("score_and_topk", lambda: score_and_topk(qf, keys, num_facts, k)),
        ):
            times[name] = [time_ms(fn)]
        for name in ("scan_kernel", "scan_plain"):
            fn = (fused_topk.scan_tiles if name == "scan_kernel" else fused_topk.scan_tiles_reference)
            times[name].append(time_ms(lambda fn=fn: fn(qs, ks, num_facts)))
        ms = {name: float(np.mean(v)) for name, v in times.items()}
        delta = scan_delta(qs, ks)
        check(err <= delta, f"phase 1 ({tag} keys): scan max|err| {err} above the stated bound {delta}")
        log(f"phase 1 at B={qf.shape[0]} N={keys.shape[0]} D={keys.shape[1]} k={k}, {tag} keys: "
            f"scan max|err| {err:.3e} (bound {delta:.3e}); ms {json.dumps(ms)}")
        out[tag] = dict(err=err, delta=delta, ms=ms)

    sweep = {}
    for b in SWEEP_BATCHES:
        q = qf[:b]
        row = {}
        for tag, keys in (("f32", fact_emb), ("bf16", fact_bf16)):
            qs, ks = _scan_args(q, keys)
            row[f"scan_plain_{tag}"] = time_ms(lambda: fused_topk.scan_tiles_reference(qs, ks, num_facts))
            row[f"scan_kernel_{tag}"] = time_ms(lambda: fused_topk.scan_tiles(qs, ks, num_facts))
            row[f"fused_topk_kernel_{tag}"] = time_ms(lambda: fused_topk.fused_score_topk(q, keys, num_facts, k))
        row["score_and_topk_f32"] = time_ms(lambda: score_and_topk(q, fact_emb, num_facts, k))
        sweep[b] = row
    log("phase 1 sweep over B (ms): " + json.dumps(sweep))
    out["sweep"] = sweep
    return out


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

    big = phase1_big(bucket["qf"], bucket["fact_emb"], sizes["facts"], k)

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
    return big, launches, detail


def phase3(device, compute_dtype="float32"):
    with open(FIXTURE) as fh:
        expected = json.load(fh)["queries"]
    docs, queries, gold_docs, gold_answers = load_dataset("sample", os.path.join(ROOT, "data"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cfg = BaseConfig(llm_name="mock", embedding_model_name="mock",
                         vector_store_type="memory", save_dir=tmp, compute_dtype=compute_dtype)
        rag = HippoRAG(cfg, device=device)
        rag.index(docs)
        fused_topk.SCAN_LAUNCHES.reset()
        t0 = time.perf_counter()
        sols = rag.retrieve(queries)
        sync()
        wall = time.perf_counter() - t0
        launches = fused_topk.SCAN_LAUNCHES.count
        check(launches > 0, f"phase 3 ({compute_dtype}): retrieve did not launch the fused kernel")
        qa_sols = rag.rag_qa(queries, gold_docs=gold_docs, gold_answers=gold_answers)[0]
    for exp, sol, qa in zip(expected, sols, qa_sols):
        for got in (sol, qa):
            ids = [compute_mdhash_id(doc, "chunk-") for doc in got.docs]
            check(got.question == exp["question"] and ids == exp["ranked_passage_ids"],
                  f"phase 3 ({compute_dtype}): ranked passages differ from the JAX package for "
                  f"{exp['question']!r}")
        check(qa.answer == exp["answer"], f"phase 3: answer {qa.answer!r} != {exp['answer']!r}")
    check(len(sols) == len(expected), "phase 3: query count differs from the fixture")
    log(f"phase 3 ({compute_dtype}): index/retrieve/rag_qa on {len(docs)} passages, {len(queries)} "
        f"queries match the JAX package; retrieve wall {wall * 1e3:.1f} ms, {launches} kernel launches")
    return {"retrieve_wall_ms": wall * 1e3, "kernel_launches": launches}


# ----------------------------------------------------------------------
# Phase 4: the encoder at BERT-base width
# ----------------------------------------------------------------------
def encoder_model(device, compute_dtype, tmp, batch_size=ENCODE_BATCH):
    cfg = BaseConfig(embedding_model_name=ENCODER, embedding_model_dtype=compute_dtype,
                     embedding_batch_size=batch_size, save_dir=tmp)
    return TorchEncoderEmbeddingModel(cfg, device=device)


def encode_each(model, texts):
    """Each text alone, in its own bucket: [N, D] on the host."""
    rows = []
    for text in texts:
        ids, mask = model.pretokenize([text])
        rows.append(model.encode_pretokenized(ids, mask).cpu().numpy()[0])
    return np.stack(rows)


def check_bounds(got, want, bounds, compute_dtype, what):
    """The CPU test's bounds (tests/test_torch_encoder.py), stored in the fixture."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape and bool(np.isfinite(got).all()), f"{what}: shape or non-finite values")
    err = float(np.abs(got - want).max())
    real = np.linalg.norm(want, axis=1) > 0
    cos = (got * want).sum(1)[real] / (np.linalg.norm(got, axis=1)[real] * np.linalg.norm(want, axis=1)[real])
    if compute_dtype == "float32":
        check(err <= bounds["f32_max_abs"], f"{what}: max|err| {err} > {bounds['f32_max_abs']}")
    else:
        check(err <= bounds["bf16_max_abs"], f"{what}: max|err| {err} > {bounds['bf16_max_abs']}")
        check(cos.min() >= bounds["bf16_min_cos"], f"{what}: min cosine {cos.min()} < {bounds['bf16_min_cos']}")
    return {"max_abs_err": err, "min_cos": float(cos.min())}


def synthetic_texts(rng, n, words_range, vocab_size=20_000):
    """``n`` texts of ``words_range`` random words from a seeded vocabulary."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(letters[rng.integers(0, 26, rng.integers(3, 11))]) for _ in range(vocab_size)]
    counts = rng.integers(words_range[0], words_range[1] + 1, n)
    flat = rng.integers(0, vocab_size, int(counts.sum()))
    cuts = np.concatenate([[0], np.cumsum(counts)])
    return [" ".join(vocab[j] for j in flat[cuts[i]:cuts[i + 1]]) for i in range(n)]


def encode_throughput(model, batches, peak_flops):
    """Device time of each pretokenized batch (CUDA events after one warm-up
    batch per bucket), by bucket; model FLOPs per token and layer are
    24 d^2 (the six products) + 4 L d (the two attention products)."""
    enc = model.encoder
    d, layers = enc.dim, len(enc.layers)
    warm = {}
    for ids, mask in batches:
        warm.setdefault(ids.shape[1], (ids, mask))
    for ids, mask in warm.values():
        model.encode_pretokenized(ids, mask)
    sync()
    torch.cuda.reset_peak_memory_stats()
    events = []
    outs = []
    for ids, mask in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(model.encode_pretokenized(ids, mask))
        end.record()
        events.append((start, end))
    sync()
    peak = peak_memory()
    by_bucket, total_ms, flops, real, padded = {}, 0.0, 0.0, 0, 0
    for (ids, mask), (start, end), out in zip(batches, events, outs):
        b, l = ids.shape
        ms = start.elapsed_time(end)
        check(tuple(out.shape) == (b, d) and bool(torch.isfinite(out).all()), "encoder output not finite [B, D]")
        norms = out.norm(dim=1)
        check(bool(((norms - 1).abs() < 1e-3).all()), "encoder rows must be unit vectors")
        row = by_bucket.setdefault(l, {"batches": 0, "ms": 0.0})
        row["batches"] += 1
        row["ms"] += ms
        total_ms += ms
        flops += b * l * layers * (24 * d * d + 4 * l * d)
        real += int(mask.sum())
        padded += b * l
    for row in by_bucket.values():
        row["ms_per_batch"] = row["ms"] / row["batches"]
    seconds = total_ms / 1e3
    return {
        "batches": len(batches), "device_ms": total_ms,
        "real_tokens": real, "padded_tokens": padded,
        "real_tokens_per_s": real / seconds, "padded_tokens_per_s": padded / seconds,
        "model_flops": flops, "flop_share_of_peak": flops / seconds / peak_flops,
        "ms_per_batch_by_bucket": {str(k): v["ms_per_batch"] for k, v in sorted(by_bucket.items())},
        "batches_by_bucket": {str(k): v["batches"] for k, v in sorted(by_bucket.items())},
        "peak_memory_bytes": peak,
    }


def phase4(device, seed=0):
    fixture = np.load(ENCODER_FIXTURE)
    texts = [str(t) for t in fixture["texts"]]
    bounds = {k: float(fixture[k]) for k in ("f32_max_abs", "bf16_max_abs", "bf16_min_cos")}
    out = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        models = {}
        for dt in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            model = models[dt] = encoder_model(device, dt, tmp)
            check(model.encoder.word_emb.is_cuda and model.encoder.layers[0].q_w.is_cuda,
                  "phase 4: the encoder is not on the card")
            want = fixture[f"embeddings_{dt}"]
            # (a) each text in its own bucket, and all 16 in one batch
            single = check_bounds(encode_each(model, texts), want, bounds, dt, f"phase 4a ({dt}, one text a batch)")
            ids, mask = model.pretokenize(texts)
            batched = check_bounds(model.encode_pretokenized(ids, mask).cpu().numpy(), want, bounds, dt,
                                   f"phase 4a ({dt}, one batch of {len(texts)} at {ids.shape[1]})")
            # (b) lengths path == full-mask path, bit for bit; a zero-length row is zeros
            ids0 = np.concatenate([ids, np.zeros_like(ids[:1])])
            mask0 = np.concatenate([mask, np.zeros_like(mask[:1])])
            ids_t = torch.from_numpy(ids0).to(device)
            wire = model.encoder.encode_forward_wire(ids_t, torch.from_numpy(mask0.sum(1).astype(np.int32)).to(device))
            full = model.encoder.encode_forward(ids_t, torch.from_numpy(mask0).to(device))
            check(torch.equal(wire, full), f"phase 4b ({dt}): lengths path and full-mask path differ")
            check(bool((wire[-1] == 0).all()), f"phase 4b ({dt}): a zero-length row must embed to zeros")
            out[f"fixture_{dt}"] = {"one_text_a_batch": single, "one_batch": batched,
                                   "model_setup_s": time.perf_counter() - t0}
            log(f"phase 4a/b ({dt}): {json.dumps(out[f'fixture_{dt}'])}")

        # (c) 16,384 passages in bf16, batches of 128 sorted by length
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        passages = synthetic_texts(rng, PASSAGES, PASSAGE_WORDS)
        by_len = sorted(passages, key=lambda t: t.count(" "))
        bf16 = models["bfloat16"]
        batches = [bf16.pretokenize(by_len[i:i + ENCODE_BATCH]) for i in range(0, PASSAGES, ENCODE_BATCH)]
        host_s = time.perf_counter() - t0
        out["bf16_passages"] = encode_throughput(bf16, batches, BF16_PEAK_FLOPS)
        out["bf16_passages"]["host_generate_and_tokenize_s"] = host_s
        check(set(out["bf16_passages"]["batches_by_bucket"]) == {"64", "128", "256", "512"},
              "phase 4c: the passages must fill every bucket from 64 to 512")
        log("phase 4c (bf16, 16,384 passages): " + json.dumps(out["bf16_passages"]))
        # batch_encode as a caller uses it: unsorted, host tokenization overlapping the device
        unsorted = passages[:UNSORTED_PASSAGES]
        t0 = time.perf_counter()
        embs = bf16.batch_encode(unsorted, norm=True)
        wall = time.perf_counter() - t0
        check(embs.shape == (len(unsorted), 768) and bool(np.isfinite(embs).all()),
              "phase 4c: batch_encode output")
        out["bf16_batch_encode_unsorted"] = {"passages": len(unsorted), "wall_s": wall,
                                             "passages_per_s": len(unsorted) / wall}
        log("phase 4c batch_encode: " + json.dumps(out["bf16_batch_encode_unsorted"]))

        # (d) 1,024 of the passages in f32 (every 16th by length: every bucket)
        f32 = models["float32"]
        picked = by_len[:: PASSAGES // F32_PASSAGES]
        batches = [f32.pretokenize(picked[i:i + ENCODE_BATCH]) for i in range(0, len(picked), ENCODE_BATCH)]
        out["f32_passages"] = encode_throughput(f32, batches, F32_PEAK_FLOPS)
        log("phase 4d (f32, 1,024 passages): " + json.dumps(out["f32_passages"]))

        # (e) one bucket of 128 queries, the online query-encoding cost
        queries = synthetic_texts(rng, QUERIES, QUERY_WORDS)
        ids, mask = bf16.pretokenize(queries)
        q = {"bucket": int(ids.shape[1])}
        q["device_ms"] = time_ms(lambda: bf16.encode_pretokenized(ids, mask))
        bf16.batch_encode(queries)
        t0 = time.perf_counter()
        for _ in range(5):
            qe = bf16.batch_encode(queries, norm=True)
        q["batch_encode_wall_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        check(qe.shape == (QUERIES, 768) and bool(np.isfinite(qe).all()), "phase 4e: query embeddings")
        out["bf16_queries"] = q
        log("phase 4e (bf16, 128 queries): " + json.dumps(q))
    return out


# ----------------------------------------------------------------------
# Phase 5: the dense entry points on the encoder
# ----------------------------------------------------------------------
def _solutions(sols):
    return [{"question": s.question,
             "ranked_passage_ids": [compute_mdhash_id(doc, "chunk-") for doc in s.docs],
             "doc_scores": [float(x) for x in s.doc_scores],
             "answer": s.answer} for s in sols]


def _rag_qa(out):
    solutions, _responses, _meta, retrieval, qa = out
    return {"solutions": _solutions(solutions), "retrieval": retrieval, "qa": qa}


def entry_point_record(hipporag, standard, data, counter=None):
    """Every entry point of phase 5 on ``data`` (docs, queries, gold docs,
    gold answers), in the fixture's form; and the kernel launches of
    ``hipporag.retrieve`` when ``counter`` is given."""
    docs, queries, gold_docs, gold_answers = data
    hipporag.index(docs)
    if counter is not None:
        counter.reset()
    retrieved = hipporag.retrieve(queries)
    launches = counter.count if counter is not None else None
    order, scores = hipporag.dense_passage_retrieval(queries[0])
    record = {
        "hipporag.retrieve": _solutions(retrieved),
        "hipporag.rag_qa": _rag_qa(hipporag.rag_qa(queries, gold_docs=gold_docs, gold_answers=gold_answers)),
        "hipporag.retrieve_dpr": _solutions(hipporag.retrieve_dpr(queries)),
        "hipporag.rag_qa_dpr": _rag_qa(
            hipporag.rag_qa_dpr(queries, gold_docs=gold_docs, gold_answers=gold_answers)),
        "hipporag.dense_passage_retrieval": {
            "query": queries[0], "order": [int(i) for i in order], "scores": [float(x) for x in scores]},
    }
    standard.index(docs)
    record["standard_rag.retrieve"] = _solutions(standard.retrieve(queries))
    record["standard_rag.rag_qa"] = _rag_qa(
        standard.rag_qa(queries, gold_docs=gold_docs, gold_answers=gold_answers))
    return record, launches


def compare_records(got, want, score_atol=ENTRY_SCORE_ATOL):
    """Rankings, answers and metrics exactly; scores within ``score_atol``.
    Returns the largest score difference."""
    check(sorted(got) == sorted(want), "entry points differ from the fixture's")
    worst = 0.0

    def scores_close(a, b, what):
        nonlocal worst
        check(len(a) == len(b), f"{what}: score count differs")
        err = float(np.abs(np.asarray(a) - np.asarray(b)).max()) if a else 0.0
        worst = max(worst, err)
        check(err <= score_atol, f"{what}: scores differ by {err} > {score_atol}")

    def solutions(g, w, what):
        check(len(g) == len(w), f"{what}: query count differs")
        for gs, ws in zip(g, w):
            label = f"{what} {ws['question']!r}"
            check(gs["question"] == ws["question"], f"{label}: question differs")
            check(gs["ranked_passage_ids"] == ws["ranked_passage_ids"], f"{label}: ranked passages differ")
            check(gs["answer"] == ws["answer"], f"{label}: answer {gs['answer']!r} != {ws['answer']!r}")
            scores_close(gs["doc_scores"], ws["doc_scores"], label)

    for key, w in want.items():
        g = got[key]
        if key.endswith("dense_passage_retrieval"):
            check(g["query"] == w["query"] and g["order"] == w["order"], f"{key}: order differs")
            scores_close(g["scores"], w["scores"], key)
        elif isinstance(w, dict):
            solutions(g["solutions"], w["solutions"], key)
            check(g["retrieval"] == w["retrieval"] and g["qa"] == w["qa"],
                  f"{key}: metrics {g['retrieval']} {g['qa']} != {w['retrieval']} {w['qa']}")
        else:
            solutions(g, w, key)
    return worst


def phase5(device):
    with open(ENTRY_FIXTURE) as fh:
        fixture = json.load(fh)
    data = load_dataset("sample", os.path.join(ROOT, "data"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        def config(sub):
            return BaseConfig(save_dir=os.path.join(tmp, sub), **fixture["config"])

        t0 = time.perf_counter()
        hipporag = HippoRAG(config("hipporag"), device=device)
        standard = StandardRAG(config("standard"), device=device)
        for model in (hipporag.embedding_model, standard.embedding_model):
            check(model.encoder.word_emb.is_cuda, "phase 5: the encoder is not on the card")
        record, launches = entry_point_record(hipporag, standard, data, fused_topk.SCAN_LAUNCHES)
        sync()
        wall = time.perf_counter() - t0
        check(launches > 0, "phase 5: retrieve did not launch the fused kernel")
        worst = compare_records(record, fixture["record"])

        t0 = time.perf_counter()
        out_json = os.path.join(tmp, "cli.json")
        proc = subprocess.run(
            [sys.executable, "-m", "hipporag_tpu_torch", "--dataset", "sample", "--llm_name", "mock",
             "--embedding_name", ENCODER, "--data_dir", os.path.join(ROOT, "data"),
             "--save_dir", os.path.join(tmp, "cli"), "--vector_store_type", "memory",
             "--output_json", out_json],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 5: the CLI failed (rc {proc.returncode}): {proc.stderr[-3000:]}")
        with open(out_json) as fh:
            cli = json.load(fh)
        check(len(cli["solutions"]) == len(data[1]) and all(s["docs"] for s in cli["solutions"]),
              "phase 5: the CLI returned no ranked passages")
    detail = {"entry_points_wall_s": wall, "kernel_launches": launches, "max_score_diff": worst,
              "cli_s": cli_s, "cli_qa": cli["qa_eval"], "cli_retrieval": cli["retrieval_eval"]}
    log(f"phase 5: {len(fixture['record'])} entry-point results on {len(data[0])} passages match the JAX "
        f"package; " + json.dumps(detail))
    return detail


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
    log("kernel shared memory per block (bytes, ring stages): " + json.dumps(scan_layouts()))

    phase1_grid(device)
    phase1_near_ties(device)
    big, launches, detail = phase2(device, FULL)
    detail["phase3"] = {dt: phase3(device, dt) for dt in ("float32", "bfloat16")}
    log("phase 3: " + json.dumps(detail["phase3"]))
    phase4(device)
    phase5(device)

    f32, bf16 = big["f32"], big["bf16"]
    kernels = [{
        "name": "fused_topk_scan",
        "route": "cuda",
        "source": "hipporag_tpu_torch/csrc/fused_topk_scan.cu",
        "replaces": "hipporag_tpu/ops/fused_topk.py:58",
        "launches": launches,
        "max_abs_err": f32["err"],
        "delta_bound": f32["delta"],
        "ms": f32["ms"]["scan_kernel"],
        "plain_ms": f32["ms"]["scan_plain"],
        "max_abs_err_bf16": bf16["err"],
        "delta_bound_bf16": bf16["delta"],
        "ms_bf16": bf16["ms"]["scan_kernel"],
        "plain_ms_bf16": bf16["ms"]["scan_plain"],
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
