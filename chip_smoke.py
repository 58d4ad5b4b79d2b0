#!/usr/bin/env python3
"""Drive the PyTorch port (hipporag_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA GPU, nvcc and PyTorch
built for CUDA (no JAX needed). It builds the hand-written CUDA kernel from
``hipporag_tpu_torch/csrc`` and the native graph core from
``hipporag_tpu_torch/graph/native`` and runs eleven phases; any failure ends
the run with a non-zero exit:

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
   against a float64 scipy power iteration. At the same shape, the default
   route of ``fact_topk`` under bf16 compute (K1 on bf16 keys, the queries
   rounded to bf16 as the JAX package's XLA path rounds them) against the
   plain bf16 route: equal indices (near ties within 2e-6 may trade, and are
   counted), normalized values within 1e-6, both routes timed.
3. The user entry points: ``HippoRAG(...).index()``, ``.retrieve()`` and
   ``.rag_qa()`` on the sample corpus with the mock LLM and embedder, held
   against ``tests/fixtures/torch_port_sample_expected.json`` (recorded
   from the JAX package on the CPU), with ``compute_dtype`` float32 and
   bfloat16 (bf16 keys through the kernel); then ``retrieve`` again under a
   caller's ``torch.set_float32_matmul_precision("high")``, bit-identical.
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
6. Serving: 10,000 synthetic passages (numpy seed; Zipf-skewed entities)
   indexed by ``HippoRAG(device="cuda")``, served by ``RetrievalService``
   through the native C++ front end (built from the checkout) to 16
   closed-loop HTTP clients: 256 distinct queries rank as ``rag.retrieve``
   does (near ties may trade places), then 2,048 ``/retrieve`` (mixed top_k,
   hot queries) and 128 ``/qa`` with one ``/index`` of 64 new passages and
   one ``/delete`` of 32 in the middle; every request completes or is shed,
   new passages are found, deleted ones never served; then 256 requests on
   the stdlib front end. Queries/s, p50/p99 latency per front end, batch
   sizes, dedup, cache hits, K1 launches and peak memory are printed. Last,
   index -> delete -> retrieve -> re-index -> retrieve on the sample corpus
   is held to ``tests/fixtures/torch_port_lifecycle_expected.json`` (the JAX
   package) in float32 and bfloat16.
7. The rest of the single-device port: (a) COO PPR (``batched_ppr``, edge
   chunks 1 and 4 with f32 gathers, bf16 gathers) and (b) the Chebyshev
   iteration on phase 2's graph and resets, held to the ELL power iteration
   and to float64 scipy, a COO rerun bit-identical, with iterations, ms and
   peak memory; (c) ``HippoRAG(ppr_format="coo")`` on the sample corpus in
   float32 and bfloat16, held to ``tests/fixtures/torch_port_coo_expected.json``;
   on phase 6's live index, (e) one 128-query ``retrieve`` with
   ``profile_log_dir`` set, its trace read back for K1's kernel, K2's
   kernels (the PageRank steps), the device idle share and graph search's device/host split, and
   (d) the index re-prepared as COO: its rankings equal the ELL path's and
   both hold to the native float64 serial solver (``exact_rank_check``),
   with the NumPy twin beside them; (f) 100 AdamW steps of the adapter at
   NV-Embed-v2's width, the first 5 losses equal to the same steps on the
   CPU; (g) ``run_multihop_eval`` on the card against
   ``tests/fixtures/torch_port_multihop_expected.json``.
8. The multi-device path on virtual shards of the one card (a mesh whose
   four devices are all this GPU: it checks correctness and per-shard work,
   not scaling): (a) ``make_sharded_score_topk`` at phase 2's shape on
   meshes (1, 4) and (2, 2), held to the single-device plain ``fact_topk``;
   (b) ``make_sharded_ppr_ell`` on phase 2's graph and resets at (1, 4) and
   (2, 2), held to ``batched_ppr_ell`` per dp group and to float64 scipy,
   with iterations, ms per iteration and the work counters; (c)
   ``make_sharded_ppr`` (COO) at (1, 4), held to the single-device COO
   solve, a rerun bit-identical; (d) phase 6's live index re-prepared with
   ``mesh_shape=(1, 4)``: 256 parity queries rank as the single-device
   ``retrieve`` (near ties may trade), then 256 ``/retrieve`` through the
   native front end; (e) the dp+tp adapter step at phase 7f's width on
   (2, 2), its first 5 losses equal to phase 7f's; (f) the 768x12 encoder
   with ``mesh_shape=(1, 4)`` equal to the unsharded encoder and the
   fixture; (g) ``parallel.dryrun`` at 4 shards (the 1,048,576-node halo
   solve, the memory model, the 16 MiB-budget reduce, the weak-scaling point
   from 2 to 4 shards checked on its work counters, the capacity table).
9. The quality sections through ``evaluation.bench_sections.run_section``:
   ``multihop`` on the card against
   ``tests/fixtures/torch_port_multihop_expected.json``; ``2wiki``,
   ``hotpot``, ``musique`` and ``replay`` run when their corpus
   (``bench_sections.corpus_path()``) exists and print a skip line when it
   does not.
10. K2, the ELL PageRank step kernel (``csrc/ell_ppr_step.cu``), on a
   small hub-heavy graph (every bucket width up to 256, hubs of several
   512-wide chunk rows, zero-in-degree nodes) and on the benchmark's graph
   (``perfbench``'s ``nvembed2-musique`` deployment): one step against the
   plain torch step at b = 8, 32, 104, 128 with f32 and bf16 gathers,
   within a stated bound, the kernel's residual equal to the max over its
   own outputs, reruns bit-identical; whole power and Chebyshev solves with
   the per-tile iteration counts of the same solves on the CPU (the torch
   step) and no torch SpMV, the ``retrieve/ppr`` counts
   ``kernel_iterations`` equal to ``iterations``; then the kernel's and the
   torch step's times at b = 128. In phases 2-9, each path that ranks by
   PageRank (the phase-2 bucket, 3, 5, 6's served window, 7c-e, 7g, 9's
   multihop) is held on its own to its ``retrieve/ppr`` spans: K2 launched
   once per iteration on the ELL route, never on COO (``k2_path``).
11. NV-Embed-v2's decoder-layer kernels (``csrc/nvembed_layer.cu``:
   ``add_rms_norm``, ``rope_qkv``, ``masked_softmax``, ``ungroup_operand``,
   ``swiglu``): each against its plain version (``<op>_plain``) on the same
   inputs, at the ``nvembed2-7b-musique.batch`` cell's forwards (16 x 18,
   16 x 22) and published widths and at a ragged shape whose widths take
   every narrow branch, writing bfloat16 and float32; each timed inside a
   CUDA graph against its plain version and its least time by bytes; the
   published model's forward (weights drawn on the card): its launches of
   each kernel eager (192 a forward), as captured and in a traced replay,
   its unit rows and time against the forward captured through the plain
   versions; and the ``retrieve/embed`` span's ``fused_kernels`` against
   its ``forwards``.
12. GritLM-8x7B's mixture-of-experts kernels (``ops/moe.py``, Triton:
   ``moe_route``, ``moe_gate_up``, ``moe_down``, ``moe_combine``): each
   against its plain version on the same inputs, eager and inside a traced
   CUDA-graph replay, at the ``gritlm-8x7b-musique.batch`` cell's forwards
   (16 x 22, 16 x 18) and published widths and at a ragged shape whose
   routing leaves one expert with no rows (the same expert choices, rows and
   offsets; gates and products within stated bounds); each timed against
   its plain version and its least time; the cell's 16 layers' forward
   (weights drawn on the card): its launches of each MoE and layer kernel
   eager, as captured and in a traced replay, its unit rows and time
   against the forward through the plain versions, and its rows and expert
   choices against the float32 reference's; and the ``retrieve/embed``
   span's ``moe_kernels``, ``routed`` and ``expert_rows_max``.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. Neither JAX nor ``hipporag_tpu`` may be
imported by then.
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
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
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
    COOGraph,
    batched_ppr,
    batched_ppr_ell,
    ell_from_coo,
    ell_gathered_rows_per_iter,
    normalize_symmetric_coo,
)
from hipporag_tpu_torch.ops.scoring import (  # noqa: E402
    batched_normalized_scores,
    batched_scores,
    fact_topk,
    score_and_topk,
)
from hipporag_tpu_torch.parallel import (  # noqa: E402
    corpus_sharded,
    make_mesh,
    make_sharded_ppr,
    make_sharded_ppr_ell,
    make_sharded_score_topk,
    put_sharded_ell,
    put_sharded_graph,
    shard_graph,
    shard_graph_ell,
    sharded_ell_counters,
)
from hipporag_tpu_torch.parallel.backend import ShardedBackend  # noqa: E402

from hipporag_tpu_torch.utils.timing import dropped_spans, recording, span  # noqa: E402
from hipporag_tpu_torch.utils.timing import spans as logged_spans  # noqa: E402

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
TF32_PEAK_FLOPS, HBM_BYTES_PER_S = 495e12, 3.35e12
PASSAGES, PASSAGE_WORDS, ENCODE_BATCH = 16_384, (48, 500), 128
UNSORTED_PASSAGES = 2_048
F32_PASSAGES, QUERIES, QUERY_WORDS = 1_024, 128, (8, 24)
# phase 5: doc scores are min-max normalized over passages whose raw scores
# lie close together, which magnifies the encoder's ~1e-7 differences to
# ~1e-5; rankings, answers and metrics are compared exactly
ENTRY_SCORE_ATOL = 1e-4
# phase 6: the delete lifecycle on the sample corpus, held to the JAX package
LIFECYCLE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_lifecycle_expected.json")
LIFECYCLE_CONFIG = dict(llm_name="mock", embedding_model_name="mock", vector_store_type="memory")
LIFECYCLE_DELETED = 3
# rankings are compared exactly; scores of the port against the JAX package's.
# With bf16 keys the default route rounds the queries to bf16 before the fused
# top-k, as the JAX package's XLA path does, so both dtypes agree to float32
# rounding (the card's bf16 doc scores differed by 2.8e-5 when it did not)
LIFECYCLE_SCORE_ATOL = {"float32": 1e-5, "bfloat16": 1e-5}
# phase 6: 10,000 passages (the HippoRAG 2 paper's corpora hold about 4k-23k),
# served to 16 closed-loop clients. The embedder is the hashing n-gram model
# at BERT-base width: the random-weight encoder maps every text to nearly the
# same direction, which puts every entity pair over the synonymy threshold
# and leaves a query hardly more likely to find its own passage than chance.
SERVE = dict(passages=10_000, entity_pool=20_000, retrieve_requests=2_048, qa_requests=128,
             parity_queries=256, stdlib_requests=256, new_passages=64, deleted=32, clients=16)
SERVE_CONFIG = dict(llm_name="mock", embedding_model_name="hashing", embedding_dim=768,
                    vector_store_type="memory", embedding_batch_size=256)
ZIPF_S = 1.1
SERVE_SENTENCES, SERVE_WORDS, SERVE_ENTITIES = (3, 6), (10, 25), (2, 4)
HOT_QUERIES, HOT_EVERY, TOP_KS = 16, 8, (5, 20, 200)
SERVE_MAX_WAIT_MS, SERVE_CACHE = 8.0, 256
NEW_PASSAGE_PROBES = 8
# PPR stops per 128-column tile, so a query's iteration count depends on its
# batch-mates: served and direct scores may differ by about ppr_tol, and
# passages that close may trade places
PARITY_ATOL = 2e-6
# phase 7: the COO operator, Chebyshev, profiling, the adapter, multihop
COO_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_coo_expected.json")
COO_CONFIG = dict(llm_name="mock", embedding_model_name="mock", vector_store_type="memory",
                  ppr_format="coo")
COO_SCORE_ATOL = LIFECYCLE_SCORE_ATOL
MULTIHOP_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_multihop_expected.json")
COO_EDGE_CHUNKS = (1, 4)
# float64 scipy over the first 8 queries of the bucket (all 128 against ELL)
SCIPY_QUERIES = 8
# bf16 gathers: each gathered term carries up to three bf16 roundings
# (p, w and their product, 2^-9 each) and d·y <= p, so the fixed point
# moves by at most 3·2^-9 / (1 - d) · max p (PERF.md states it)
BF16_TERM_RTOL = 3 * 2.0**-9
# served index: top-20 set overlap with the float64 tol-1e-12 serial solver
EXACT_TOP_K, EXACT_AGREEMENT_MIN = 20, 0.99
PROFILE_QUERIES = 128
PROFILE_DIR = os.path.join(ROOT, "build", "profile", "served")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the adapter at NV-Embed-v2's width (the reference's default embedder)
ADAPTER = dict(dim=4096, hidden=1024, pairs=1024, steps=100, cpu_steps=5, lr=1e-3)
# phase 8: virtual shards of the one card; the bounds of tests/test_parallel.py
SHARDS = 4
SHARD_MESHES = ((1, SHARDS), (2, SHARDS // 2))
SHARDED_SCORE_ATOL = 1e-5
SHARDED_ELL_RTOL, SHARDED_ELL_ATOL = 1e-5, 1e-7
SHARDED_COO_ATOL = 2e-6
SHARDED_ADAPTER_STEPS, SHARDED_ADAPTER_RTOL = 5, 1e-4
# phase 2's bf16 default route against the plain bf16 route: the same exact
# bf16 x bf16 products summed in another order (float64 against cuBLAS f32)
BF16_ROUTE_TIE_ATOL, BF16_ROUTE_NORM_ATOL = 2e-6, 1e-6
# phase 9: the quality sections that read the 2WikiMultihopQA corpus
CORPUS_SECTIONS = ("2wiki", "hotpot", "musique", "replay")
# phase 10: K2 at the column widths of the served path and of the benchmark's
# calls (1,000 questions: 7 buckets of 128 and one of 104), on the
# benchmark's graph at the seed its configuration file records
K2_WIDTHS = (8, 32, 104, 128)
K2_BENCH_SEED = 2147483653
PASSAGE_WEIGHT = 0.05
# phase 11: NV-Embed-v2's layer kernels at the forwards of the
# nvembed2-7b-musique.batch cell (16 texts of 18 or 22 tokens) and published
# widths, and at a ragged shape whose widths take every narrow branch
# (D % 4, F % 4, head_dim % 8 and head_dim % 4 all nonzero)
NV_OPS = ("add_rms_norm", "rope_qkv", "masked_softmax", "ungroup_operand", "swiglu")
NV_KERNELS = {"add_rms_norm": "add_rms_norm_kernel", "rope_qkv": "rope_qkv_kernel",
              "masked_softmax": "masked_softmax_kernel", "ungroup_operand": "ungroup_kernel",
              "swiglu": "swiglu_kernel"}  # the kernels' names in a device trace
NV_SHAPES = ((16, 18), (16, 22))
NV_WIDTHS = dict(d=4096, f=14336, heads=32, kv_heads=8, head_dim=128)
NV_RAGGED = (3, 37, dict(d=4094, f=1021, heads=6, kv_heads=2, head_dim=6))
# kernel against plain version: bf16 outputs at most one bf16 step apart on
# at most NV_DIFFER_SHARE of the elements; float32 outputs to NV_F32_RTOL.
# add_rms_norm sums its squares in another order than torch, so its rsqrt
# may differ in the last place and flip a bf16 rounding (in 1-6 of 0.45-1.4
# M elements); each element where its bf16 output differs must be a rounding
# tie: the exact (float64) value within NV_TIE_RTOL of the midpoint between
# the two bf16 values (float32 sums of 4,096 squares err by up to ~4e-7)
NV_DIFFER_SHARE, NV_F32_RTOL, NV_TIE_RTOL = 1e-5, 1e-6, 2.0**-20
# the replayed forward's unit rows against the forward through the plain
# versions: the kernels' forward read 0.024-0.033 (add_rms_norm's rsqrt
# differs from torch's in a few rows, carried through 32 random layers); the
# bf16 forward lies 0.074-0.080 from float32
NV_FORWARD_L2 = 0.04
NV_COLD_BYTES = 128 << 20  # inputs cycled per timing: over twice the 50 MB L2
NV_TIMED_CALLS = 200
# phase 12: GritLM-8x7B's mixture-of-experts kernels (ops/moe.py) at the
# gritlm-8x7b-musique.batch cell's forwards (16 texts of 22 or 18 tokens) and
# published widths, and at a ragged shape whose routing leaves one expert
# with no rows
MOE_OPS = ("moe_route", "moe_gate_up", "moe_down", "moe_combine")
MOE_SHAPES = ((16, 22), (16, 18))
MOE_RAGGED, MOE_EMPTY_EXPERT = (3, 37), 5
MOE_WIDTHS = dict(d=4096, f=14336, experts=8, top_k=2)
MOE_SEED = 2**31 + 12
# kernel against plain version on the same inputs: the same expert choices,
# rows and offsets; the gates within MOE_GATE_ATOL (the kernel's exp is
# Triton's, within a few float32 steps of torch's, on gates of at most 1);
# the grouped products, which sum the same bf16 products in float32 in
# another order than cuBLAS (4,096 or 14,336 terms, whose magnitudes add to
# far more than the sum: the down product read 1.3e-5), and the combine
# within MOE_PRODUCT_RTOL of their largest magnitude
MOE_GATE_ATOL, MOE_PRODUCT_RTOL = 2e-6, 1e-4
# the 16 layers' forward replayed against the same forward eager (the same
# kernels: MOE_REPLAY_L2), and against the forward through the plain
# versions held to the kernels' expert choices: a product's other sum order
# moves the bf16 operands in their last bits, which 16 layers carry on
# (NV-Embed-v2's 32 read 0.024-0.033). Left to route itself, the plain
# forward flips an expert choice wherever such a difference meets a near tie,
# and a flipped token moves its whole text: that distance is reported.
MOE_REPLAY_L2, MOE_FORWARD_L2 = 1e-6, 0.05


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


# K2's launches and PageRank iterations on each path that solves (k2_path)
K2_PATHS: dict = {}


def k2_reset() -> int:
    """Start counting one path's K2 launches: zero the counter and return
    the time after which the path's ``retrieve/ppr`` spans start (the path
    runs inside ``recording()``)."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    if torch.cuda.is_available():
        sync()
    ell_ops.ELL_STEP_LAUNCHES.reset()
    return time.time_ns()


def k2_path(name: str, since_ns: int, kernel: bool = True) -> None:
    """Hold the K2 launches since ``k2_reset`` to the ``retrieve/ppr`` spans
    that started after it: on the card's ELL route each iteration is one
    launch and the span counts it as ``kernel_iterations``; a COO path, or
    one on the CPU (``kernel=False``), launches none. Records the path in
    ``K2_PATHS``."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    if torch.cuda.is_available():
        sync()
    ppr = [s for s in logged_spans() if s.name == "retrieve/ppr" and s.start_ns >= since_ns]
    iters = sum(s.attrs.get("iterations", 0) for s in ppr)
    kernel_iters = sum(s.attrs.get("kernel_iterations", 0) for s in ppr)
    launches = ell_ops.ELL_STEP_LAUNCHES.count
    want = iters if kernel else 0
    check(iters > 0 and launches == kernel_iters == want,
          f"{name}: {launches} K2 launches and {kernel_iters} kernel iterations over {len(ppr)} PageRank "
          f"solves of {iters} iterations; want {want} of each")
    K2_PATHS[name] = {"launches": launches, "iterations": iters, "solves": len(ppr)}


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


def scan_bound(q, keys):
    """The least time pass A could take on one H100 at 700 W: the larger of
    its bytes (each key and query read once, the tile maxima and minima
    written once) over the HBM rate and its products (2 B N D flops) over
    the TF32 tensor-core peak; also the time of the three TF32 products the
    kernel runs for f32 keys (two for bf16 keys)."""
    n_tiles = -(-keys.shape[0] // fused_topk.TILE_N)
    moved = keys.numel() * keys.element_size() + q.numel() * 4 + 2 * q.shape[0] * n_tiles * 4
    flops = 2 * q.shape[0] * keys.shape[0] * keys.shape[1]
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / TF32_PEAK_FLOPS * 1e3
    terms = 2 if keys.dtype == torch.bfloat16 else 3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "split_products_ms": terms * ops_ms}


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
        ) + ((("library_matmul", lambda: torch.matmul(qf, keys.T)),) if tag == "f32" else ()):
            times[name] = [time_ms(fn)]
        for name in ("scan_kernel", "scan_plain"):
            fn = (fused_topk.scan_tiles if name == "scan_kernel" else fused_topk.scan_tiles_reference)
            times[name].append(time_ms(lambda fn=fn: fn(qs, ks, num_facts)))
        ms = {name: float(np.mean(v)) for name, v in times.items()}
        delta = scan_delta(qs, ks)
        check(err <= delta, f"phase 1 ({tag} keys): scan max|err| {err} above the stated bound {delta}")
        bound = scan_bound(qf, keys)
        log(f"phase 1 at B={qf.shape[0]} N={keys.shape[0]} D={keys.shape[1]} k={k}, {tag} keys: "
            f"scan max|err| {err:.3e} (bound {delta:.3e}); ms {json.dumps(ms)}; roofline {json.dumps(bound)}")
        out[tag] = dict(err=err, delta=delta, ms=ms, bound=bound)

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


def topk_trades(idx, want_idx, q, keys, atol):
    """Where two top-k index sets differ at a rank, both keys must score
    within ``atol`` of each other (exactly, in float64). Returns the count
    of traded positions."""
    diff = idx.long() != want_idx.long()
    if not bool(diff.any()):
        return 0
    rows = diff.nonzero()[:, 0]
    qd = q.double()[rows]
    got = (qd * keys[idx.long()[diff]].double()).sum(-1)
    want = (qd * keys[want_idx.long()[diff]].double()).sum(-1)
    gap = float((got - want).abs().max())
    check(gap <= atol, f"top-k indices differ beyond a near tie: score gap {gap} > {atol}")
    return int(diff.sum())


def phase2_bf16_route(qf, fact_emb, num_facts, k):
    """The default route of ``fact_topk`` under bf16 compute at the phase-2
    shape: K1 on bf16 keys with the queries rounded to bf16, as the JAX
    package's XLA path rounds them, against the plain bf16 route
    (``use_pallas=False``). Also the explicit kernel route
    (``use_pallas=True``, float32 queries), to show what the rounding changes."""
    keys = fact_emb.to(torch.bfloat16)
    fused_topk.SCAN_LAUNCHES.reset()
    norm, idx = fact_topk(qf, keys, num_facts, k, "bfloat16")
    sync()
    launches = fused_topk.SCAN_LAUNCHES.count
    check(launches == 1, f"phase 2 bf16 route: {launches} kernel launches, want 1")
    want_norm, want_idx = fact_topk(qf, keys, num_facts, k, "bfloat16", use_pallas=False)
    qr = qf.to(torch.bfloat16).float()
    trades = topk_trades(idx, want_idx, qr, keys, BF16_ROUTE_TIE_ATOL)
    norm_err = float((norm - want_norm).abs().max())
    check(norm_err <= BF16_ROUTE_NORM_ATOL,
          f"phase 2 bf16 route: normalized values max|err| {norm_err} > {BF16_ROUTE_NORM_ATOL}")
    _f32_norm, f32_idx = fact_topk(qf, keys, num_facts, k, "bfloat16", use_pallas=True)
    f32_rows = int((f32_idx.long() != want_idx.long()).any(1).sum())
    out = {
        "kernel_launches": launches, "near_tie_trades": trades, "norm_max_abs_err": norm_err,
        "rows_differing_with_f32_queries": f32_rows,
        # default, plain, default: both routes see the same card state
        "default_route_ms": [time_ms(lambda: fact_topk(qf, keys, num_facts, k, "bfloat16"))],
        "plain_route_ms": time_ms(lambda: fact_topk(qf, keys, num_facts, k, "bfloat16", use_pallas=False)),
    }
    out["default_route_ms"].append(time_ms(lambda: fact_topk(qf, keys, num_facts, k, "bfloat16")))
    out["default_route_ms"] = float(np.mean(out["default_route_ms"]))
    log(f"phase 2 bf16 default route at B={qf.shape[0]} N={keys.shape[0]} D={keys.shape[1]} k={k}: K1 with "
        f"bf16-rounded queries equals the plain bf16 route ({trades} near-tie trades within "
        f"{BF16_ROUTE_TIE_ATOL}; norm max|err| {norm_err:.2e}); with f32 queries {f32_rows} rows would differ; "
        + json.dumps(out))
    return out


def phase2(device, sizes, seed=0):
    bucket = build_bucket(device, sizes, seed)
    index, qp, passage_emb = bucket["index"], bucket["qp"], bucket["passage_emb"]
    s2, d2, w2, dangling = bucket["coo"]
    n, p, b, k = sizes["nodes"], sizes["passages"], sizes["batch"], sizes["link_top_k"]

    big = phase1_big(bucket["qf"], bucket["fact_emb"], sizes["facts"], k)
    big["bf16_route"] = phase2_bf16_route(bucket["qf"], bucket["fact_emb"], sizes["facts"], k)

    torch.cuda.reset_peak_memory_stats()
    fused_topk.SCAN_LAUNCHES.reset()
    k2_since = k2_reset()
    with recording():
        cand_vals, cand_idx, doc_scores, iters, order, vals, stage = run_bucket(bucket)
    k2_path("phase2_bucket", k2_since)
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
    return big, launches, detail, bucket


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
        k2_since = k2_reset()
        t0 = time.perf_counter()
        with recording():
            sols = rag.retrieve(queries)
        sync()
        wall = time.perf_counter() - t0
        k2_path(f"phase3_{compute_dtype}", k2_since)
        launches = fused_topk.SCAN_LAUNCHES.count
        check(launches > 0, f"phase 3 ({compute_dtype}): retrieve did not launch the fused kernel")
        # a caller's TF32 setting must not reach the port's products
        torch.set_float32_matmul_precision("high")
        try:
            again = rag.retrieve(queries)
            check(torch.get_float32_matmul_precision() == "high", "phase 3: retrieve did not restore the caller's flags")
        finally:
            torch.set_float32_matmul_precision("highest")
        check(all(a.docs == s.docs and np.array_equal(a.doc_scores, s.doc_scores) for a, s in zip(again, sols)),
              f"phase 3 ({compute_dtype}): retrieve under precision 'high' is not bit-identical")
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
        f"queries match the JAX package, and bit-identically under precision 'high'; "
        f"retrieve wall {wall * 1e3:.1f} ms, {launches} kernel launches")
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
    ``hipporag.retrieve`` when ``counter`` is given (K2's then checked as
    path ``phase5_retrieve``)."""
    docs, queries, gold_docs, gold_answers = data
    hipporag.index(docs)
    if counter is not None:
        counter.reset()
        k2_since = k2_reset()
    with recording():
        retrieved = hipporag.retrieve(queries)
    launches = counter.count if counter is not None else None
    if counter is not None:
        k2_path("phase5_retrieve", k2_since)
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


def lifecycle_record(rag, data):
    """index -> delete -> retrieve -> re-index -> retrieve on the sample
    ``data``: the ranked passages and graph counts after each retrieve."""
    docs, queries = data[0], data[1]
    rag.index(docs)
    rag.delete(docs[:LIFECYCLE_DELETED])
    record = {"after_delete": {"solutions": _solutions(rag.retrieve(queries)), "graph": rag.get_graph_info()}}
    rag.index(docs)
    record["after_reindex"] = {"solutions": _solutions(rag.retrieve(queries)), "graph": rag.get_graph_info()}
    return record


def compare_lifecycle(got, want, score_atol):
    """Rankings and graph counts exactly, scores within ``score_atol``."""
    check(sorted(got) == sorted(want), "lifecycle steps differ from the fixture's")
    worst = 0.0
    for step, w in want.items():
        g = got[step]
        check(g["graph"] == w["graph"], f"lifecycle {step}: graph {g['graph']} != {w['graph']}")
        check(len(g["solutions"]) == len(w["solutions"]), f"lifecycle {step}: query count differs")
        for gs, ws in zip(g["solutions"], w["solutions"]):
            check(gs["question"] == ws["question"] and gs["ranked_passage_ids"] == ws["ranked_passage_ids"],
                  f"lifecycle {step} {ws['question']!r}: ranked passages differ from the JAX package")
            err = float(np.abs(np.asarray(gs["doc_scores"]) - np.asarray(ws["doc_scores"])).max())
            worst = max(worst, err)
            check(err <= score_atol, f"lifecycle {step} {ws['question']!r}: scores differ by {err}")
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


# ----------------------------------------------------------------------
# Phase 6: the served path over a synthetic 10,000-passage index
# ----------------------------------------------------------------------
_NAME_SYLLABLES = ("ka lo ve mi dra sen tu bor li qua ren sta fa zel mor ni pe ri gu hal "
                   "wy cor bal dun gar hol jor kel lan mar nor par rus sol tam var wen yor").split()
_FILLER_SYLLABLES = "ab ec id ob ut an en il om up ar es ir os ul ax ev im oz ud".split()


def _words(rng, syllables, count, parts=(2, 4)):
    """``count`` words of 2-3 syllables."""
    lengths = rng.integers(*parts, count)
    picks = rng.integers(0, len(syllables), int(lengths.sum()))
    cuts = np.concatenate([[0], np.cumsum(lengths)])
    return ["".join(syllables[j] for j in picks[cuts[i]:cuts[i + 1]]) for i in range(count)]


def _names(rng, count):
    """``count`` distinct capitalized two-word names."""
    out = {}
    while len(out) < count:
        first = _words(rng, _NAME_SYLLABLES, 2 * count)
        for a, b in zip(first[::2], first[1::2]):
            out.setdefault(f"{a.capitalize()} {b.capitalize()}", None)
            if len(out) == count:
                break
    return list(out)


def _sentence(rng, entities, fillers):
    """``entities`` (the head first) in one sentence of 10-25 words, each
    pair apart by at least one lowercase filler word."""
    n_fill = max(len(entities), int(rng.integers(SERVE_WORDS[0], SERVE_WORDS[1] + 1)) - 2 * len(entities))
    gaps = 1 + rng.multinomial(n_fill - len(entities), [1 / len(entities)] * len(entities))
    words = []
    for ent, gap in zip(entities, gaps):
        words.append(ent)
        words.extend(fillers[j] for j in rng.integers(0, len(fillers), gap))
    return " ".join(words) + "."


class ServeCorpus:
    """Passages of a title line and 3-6 sentences; each sentence names 2-4
    two-word entities drawn Zipf-skewed from a pool, so the mock OpenIE
    builds a graph with hubs and multi-hop paths. Every passage opens with
    its title, an entity of its own."""

    def __init__(self, seed, passages, pool):
        self.rng = np.random.default_rng(seed)
        self.pool = _names(self.rng, pool + passages + 4 * SERVE["new_passages"])
        self.titles = self.pool[pool:]
        self.pool = self.pool[:pool]
        self.fillers = _words(self.rng, _FILLER_SYLLABLES, 2_000)
        weights = 1.0 / np.arange(1, pool + 1) ** ZIPF_S
        self.weights = weights / weights.sum()
        self.docs, self.entities = [], []
        for title in self.titles[:passages]:
            self._add(title, [])

    def _add(self, title, own):
        rng = self.rng
        n_sent = int(rng.integers(SERVE_SENTENCES[0], SERVE_SENTENCES[1] + 1))
        counts = rng.integers(SERVE_ENTITIES[0], SERVE_ENTITIES[1] + 1, n_sent)
        drawn = rng.choice(len(self.pool), int(counts.sum()), p=self.weights)
        sentences, names, at = [], {title: None, **dict.fromkeys(own)}, 0
        for i, c in enumerate(counts):
            ents = [self.pool[j] for j in drawn[at:at + c]]
            at += c
            ents[0] = title if i == 0 else ents[0]
            ents = list(dict.fromkeys(own + ents if i else ents[:1] + own + ents[1:]))
            names.update(dict.fromkeys(ents))
            sentences.append(_sentence(rng, ents, self.fillers))
        self.docs.append(title + "\n" + " ".join(sentences))
        self.entities.append(list(names))

    def add_new(self, count):
        """``count`` passages whose titles and own entity occur nowhere else."""
        start = len(self.docs)
        fresh = self.titles[len(self.docs):]
        for i in range(count):
            self._add(fresh[2 * i], [fresh[2 * i + 1]])
        return list(range(start, start + count))

    def query(self, i):
        """A question naming one or two entities of passage ``i``."""
        ents = self.entities[i]
        pick = self.rng.choice(len(ents), min(len(ents), int(self.rng.integers(1, 3))), replace=False)
        if len(pick) == 1:
            return f"Tell me about {ents[pick[0]]}."
        return f"What connects {ents[pick[0]]} and {ents[pick[1]]}?"


def _post(conn, path, payload):
    """POST JSON on a keep-alive connection, reconnecting once if the server
    closed it; returns (status, parsed body)."""
    import http.client

    body = json.dumps(payload)
    for attempt in (0, 1):
        try:
            conn.request("POST", path, body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        except (http.client.RemoteDisconnected, ConnectionResetError, BrokenPipeError):
            conn.close()
            if attempt:
                raise


def run_clients(port, requests, clients, on_done=None):
    """Closed-loop HTTP clients: each thread posts the next request and waits
    for its answer. Returns one (start s, end s, status, body) per request."""
    import http.client
    import threading

    records = [None] * len(requests)
    lock = threading.Lock()
    cursor = [0]

    def worker():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            while True:
                with lock:
                    i = cursor[0]
                    cursor[0] += 1
                if i >= len(requests):
                    return
                path, payload = requests[i]
                t0 = time.perf_counter()
                status, body = _post(conn, path, payload)
                records[i] = (t0, time.perf_counter(), status, body)
                if on_done is not None:
                    on_done()
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, name=f"client-{c}") for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(all(r is not None for r in records), "phase 6: a client died before its requests completed")
    return records


def latency_ms(records):
    ms = sorted((end - start) * 1e3 for start, end, _s, _b in records)
    if not ms:
        return None
    return {"p50": ms[len(ms) // 2], "p99": ms[min(len(ms) - 1, int(len(ms) * 0.99))],
            "mean": float(np.mean(ms)), "n": len(ms)}


def parity_trades(requests, records, direct, atol):
    """Served rankings against ``rag.retrieve`` of the same queries: a
    position may hold another passage only where the two passages' direct
    scores lie within ``atol``; every served score within ``atol`` of its
    direct score. Returns the number of traded positions."""
    trades = 0
    for (_path, payload), (_t0, _t1, status, body), sol in zip(requests, records, direct):
        check(status == 200, f"phase 6 parity: status {status} for {payload['query']!r}")
        want = dict(zip(sol.docs, sol.doc_scores.tolist()))
        check(len(body["docs"]) == min(payload["top_k"], len(sol.docs)),
              f"phase 6 parity: {len(body['docs'])} docs for top_k {payload['top_k']}")
        for pos, (doc, score) in enumerate(zip(body["docs"], body["doc_scores"])):
            check(doc in want, f"phase 6 parity: a served passage is not in the direct ranking of {payload['query']!r}")
            check(abs(score - want[doc]) <= atol,
                  f"phase 6 parity: score {score} vs direct {want[doc]} for {payload['query']!r}")
            if doc != sol.docs[pos]:
                trades += 1
                check(abs(want[doc] - float(sol.doc_scores[pos])) <= atol,
                      f"phase 6 parity: rank {pos} of {payload['query']!r} differs beyond a near tie")
    return trades


def serve_traffic(corpus, sizes, hot):
    """The main window's requests: ``/retrieve`` with mixed top_k (every
    eighth a hot query) and ``/qa`` spread evenly among them."""
    rng = corpus.rng
    n_ret, n_qa = sizes["retrieve_requests"], sizes["qa_requests"]
    qa_every = max(1, n_ret // max(1, n_qa))
    out, n_asked = [], 0
    for i in range(n_ret):
        q = hot[(i // HOT_EVERY) % len(hot)] if i % HOT_EVERY == 0 else corpus.query(
            int(rng.integers(0, sizes["passages"])))
        out.append(("/retrieve", {"query": q, "top_k": TOP_KS[i % len(TOP_KS)]}))
        if n_asked < n_qa and i % qa_every == qa_every - 1:
            out.append(("/qa", {"query": corpus.query(int(rng.integers(0, sizes["passages"]))), "top_k": 5}))
            n_asked += 1
    return out


# the orchestrator's retrieve stages, by the span that times each
ENGINE_SPANS = {"retrieve": "retrieve", "query_embed": "retrieve/embed", "fact_topk": "retrieve/fact_topk",
                "rerank": "retrieve/filter", "graph_search_and_rank": "retrieve/graph_search"}


def engine_seconds(spans, since_ns):
    """The orchestrator's retrieve stage clocks (host wall): the summed
    seconds of each stage's spans among ``spans`` that started at or after
    ``since_ns`` (``time.time_ns()``)."""
    check(dropped_spans() == 0, "the span log dropped spans: the engine clocks would undercount")
    return {key: sum(s.seconds for s in spans if s.name == name and s.start_ns >= since_ns)
            for key, name in ENGINE_SPANS.items()}


def short_window(port, corpus, sizes, hot, gone, what):
    """``stdlib_requests`` retrieve-only requests (no /qa, no mutation)."""
    requests = serve_traffic(corpus, {**sizes, "retrieve_requests": sizes["stdlib_requests"], "qa_requests": 0}, hot)
    t0 = time.perf_counter()
    records = run_clients(port, requests, sizes["clients"])
    wall = time.perf_counter() - t0
    check(all(r[2] in (200, 503) for r in records), f"phase 6: {what} front end status")
    ok = [r for r in records if r[2] == 200]
    check(not any(gone & set(r[3]["docs"]) for r in ok), f"phase 6: a deleted passage appears on the {what} front end")
    return {"wall_s": wall, "requests": len(records), "shed": len(records) - len(ok),
            "retrieve_per_s": len(ok) / wall, "retrieve_latency_ms": latency_ms(ok)}


def index_corpus(rag, docs):
    """Index ``docs`` and build the device state; wall seconds by stage."""
    t0 = time.perf_counter()
    rag.index(docs)
    index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rag.prepare_retrieval_objects()
    sync()
    totals = dict(rag.timers.totals)
    knn = totals.get("index/synonymy_knn", 0.0)
    return {
        "openie_s": totals.get("index/openie", 0.0),
        "encoding_s": sum(totals.get(f"index/embed_{k}", 0.0) for k in ("chunks", "entities", "facts")),
        "synonymy_knn_s": knn,
        "graph_build_s": totals.get("index/graph_build", 0.0) - knn,
        "prepare_retrieval_objects_s": time.perf_counter() - t0,
        "index_wall_s": index_s,
    }


def phase6(device, sizes=None, seed=0, served=None):
    """Index the synthetic corpus, check served against direct rankings,
    then drive the native and the stdlib front ends with concurrent clients
    while ``/index`` and ``/delete`` mutate the live index. ``served(rag,
    parity_queries)``, when given, runs last on the live index; its result
    is ``out["served_extra"]``."""
    import threading

    from hipporag_tpu_torch.serving import RetrievalService
    from hipporag_tpu_torch.serving.http_server import make_server
    from hipporag_tpu_torch.serving.native_http import make_native_server

    sizes = sizes or SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    corpus = ServeCorpus(seed, sizes["passages"], sizes["entity_pool"])
    out = {"passages": sizes["passages"], "corpus_generate_s": time.perf_counter() - t0}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp, recording() as rec:
        cfg = BaseConfig(save_dir=tmp, **SERVE_CONFIG)
        rag = HippoRAG(cfg, device=device)
        docs = list(corpus.docs)
        out["index"] = index_corpus(rag, docs)
        out["graph"] = rag.get_graph_info()
        log(f"phase 6 index: {len(docs)} passages; " + json.dumps(out["index"]) + "; graph " + json.dumps(out["graph"]))
        check(out["graph"]["num_passage_nodes"] == len(docs), "phase 6: passages missing from the graph")

        # parity window: the direct batch path first, then the same distinct queries served
        # (passages share hub entities, so draws repeat a query now and then)
        parity = {}
        while len(parity) < sizes["parity_queries"]:
            parity.setdefault(corpus.query(int(corpus.rng.integers(0, sizes["passages"]))), None)
        parity = list(parity)
        parity_requests = [("/retrieve", {"query": q, "top_k": TOP_KS[i % len(TOP_KS)]})
                           for i, q in enumerate(parity)]
        direct = rag.retrieve(parity, num_to_retrieve=cfg.retrieval_top_k)
        hot = [corpus.query(int(i)) for i in corpus.rng.choice(sizes["passages"], HOT_QUERIES, replace=False)]
        traffic = serve_traffic(corpus, sizes, hot)

        fused_topk.SCAN_LAUNCHES.reset()
        k2_since = k2_reset()
        svc = RetrievalService(rag, max_wait_ms=SERVE_MAX_WAIT_MS, response_cache_size=SERVE_CACHE)
        try:
            server = make_native_server(svc, port=0, num_workers=2 * sizes["clients"])
            port = server.server_address[1]
            thread = threading.Thread(target=server.serve_forever, name="native-http")
            thread.start()
            try:
                records = run_clients(port, parity_requests, sizes["clients"])
                out["parity_trades"] = parity_trades(parity_requests, records, direct, PARITY_ATOL)
                out["parity_latency_ms"] = latency_ms(records)
                log(f"phase 6 parity: {len(parity)} distinct queries served concurrently rank as "
                    f"rag.retrieve; {out['parity_trades']} near-tie trades (|Δ| ≤ {PARITY_ATOL})")

                before, window_ns = svc.stats(), time.time_ns()
                mutations = {}
                done = [0]
                lock = threading.Lock()
                third = threading.Event()
                two_thirds = threading.Event()

                def progress():
                    with lock:
                        done[0] += 1
                        if done[0] >= len(traffic) // 3:
                            third.set()
                        if done[0] >= 2 * len(traffic) // 3:
                            two_thirds.set()

                new_ids = corpus.add_new(sizes["new_passages"])
                deleted = [int(i) for i in corpus.rng.choice(sizes["passages"], sizes["deleted"], replace=False)]

                def mutate():
                    import http.client

                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                    try:
                        third.wait()
                        t = time.perf_counter()
                        status, body = _post(conn, "/index", {"docs": [corpus.docs[i] for i in new_ids]})
                        mutations["index"] = {"status": status, "ms": (time.perf_counter() - t) * 1e3, "body": body}
                        probes = []
                        for i in new_ids[:NEW_PASSAGE_PROBES]:
                            own = corpus.entities[i][1]
                            status, body = _post(conn, "/retrieve", {"query": f"Tell me about {own}.", "top_k": 5})
                            probes.append((status, corpus.docs[i] in body.get("docs", [])))
                        mutations["index_probes"] = probes
                        two_thirds.wait()
                        t = time.perf_counter()
                        status, body = _post(conn, "/delete", {"docs": [corpus.docs[i] for i in deleted]})
                        mutations["delete"] = {"status": status, "ms": (time.perf_counter() - t) * 1e3, "body": body}
                        mutations["deleted_at"] = time.perf_counter()
                        probes = []
                        for i in deleted[:NEW_PASSAGE_PROBES]:
                            status, body = _post(conn, "/retrieve", {"query": f"Tell me about {corpus.titles[i]}.",
                                                                     "top_k": 200})
                            probes.append((status, corpus.docs[i] in body.get("docs", [])))
                        mutations["delete_probes"] = probes
                    except Exception as exc:  # noqa: BLE001 - reported as a failed check below
                        mutations["error"] = repr(exc)
                    finally:
                        conn.close()

                mutator = threading.Thread(target=mutate, name="mutator")
                mutator.start()
                t0 = time.perf_counter()
                records = run_clients(port, traffic, sizes["clients"], on_done=progress)
                wall = time.perf_counter() - t0
                third.set()
                two_thirds.set()
                mutator.join(timeout=600)
                check(not mutator.is_alive(), "phase 6: the /index or /delete request did not return")
                check("error" not in mutations, f"phase 6: mutation failed: {mutations.get('error')}")
                after = svc.stats()
                clocks = engine_seconds(rec.spans(), window_ns)
                gone = {corpus.docs[i] for i in deleted}
                # the same kind of window on both front ends: retrieve only, after the mutations
                native_short = short_window(port, corpus, sizes, hot, gone, "native")
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=60)

            check(mutations["index"]["status"] == 200 and mutations["delete"]["status"] == 200,
                  f"phase 6: /index {mutations['index']} /delete {mutations['delete']}")
            check(all(s == 200 and found for s, found in mutations["index_probes"]),
                  f"phase 6: a new passage is not in the top 5 for its own entity: {mutations['index_probes']}")
            check(all(s == 200 and not found for s, found in mutations["delete_probes"]),
                  "phase 6: a deleted passage is still served")
            late = [r for r in records if r[0] > mutations["deleted_at"] and r[2] == 200]
            check(not any(gone & set(r[3]["docs"]) for r in late),
                  "phase 6: a deleted passage appears in a response after /delete returned")
            statuses = [r[2] for r in records]
            check(set(statuses) <= {200, 503}, f"phase 6: statuses {sorted(set(statuses))}")
            ret = [r for (path, _), r in zip(traffic, records) if path == "/retrieve" and r[2] == 200]
            qa = [r for (path, _), r in zip(traffic, records) if path == "/qa" and r[2] == 200]
            check(all(r[3]["answer"] for r in qa), "phase 6: a /qa response has no answer")

            std = make_server(svc, port=0)
            std_thread = threading.Thread(target=std.serve_forever, name="stdlib-http")
            std_thread.start()
            try:
                std_short = short_window(std.server_address[1], corpus, sizes, hot, gone, "stdlib")
            finally:
                std.shutdown()
                std.server_close()
                std_thread.join(timeout=60)
            final = svc.stats()
        finally:
            svc.close()
        sync()
        launches = fused_topk.SCAN_LAUNCHES.count
        k2_path("phase6_serving", k2_since)
        peak = peak_memory()
        check(launches > 0, "phase 6: serving did not launch the fused kernel")
        for lane in ("retrieve", "qa"):
            check(final[lane]["failed_batches"] == 0 and final[lane]["pending"] == 0,
                  f"phase 6: {lane} lane {final[lane]}")
        # phase 7 (d, e) on the same live index
        extra = served(rag, parity) if served is not None else None

    lane = {k: after["retrieve"][k] - before["retrieve"][k] for k in ("requests", "batches", "shed")}
    out.update({
        "native": {
            "wall_s": wall, "requests": len(traffic), "retrieve_ok": len(ret), "qa_ok": len(qa),
            "shed": statuses.count(503),
            "retrieve_per_s": len(ret) / wall, "requests_per_s": len(records) / wall,
            "retrieve_latency_ms": latency_ms(ret), "qa_latency_ms": latency_ms(qa),
            "mean_batch_size": lane["requests"] / max(1, lane["batches"]),
            "dedup_saved": after["dedup_saved"] - before["dedup_saved"],
            "cache_hits": after["response_cache"]["hits"] - before["response_cache"]["hits"],
            "engine_s": clocks,
        },
        "native_retrieve_only": native_short,
        "stdlib": std_short,
        "index_ms": mutations["index"]["ms"], "delete_ms": mutations["delete"]["ms"],
        "kernel_launches": launches, "peak_memory_bytes": peak,
        "service": {k: final[k] for k in ("dedup_saved", "response_cache")},
        "lanes": {k: {f: final[k][f] for f in ("requests", "batches", "failed_batches", "shed", "pending",
                                               "mean_batch_size")} for k in ("retrieve", "qa")},
    })
    log("phase 6: " + json.dumps(out))
    out["served_extra"] = extra
    return out


def phase6_lifecycle(device):
    """index -> delete -> retrieve -> re-index -> retrieve on the sample
    corpus, held to the JAX package's fixture in float32 and bfloat16."""
    with open(LIFECYCLE_FIXTURE) as fh:
        fixture = json.load(fh)
    data = load_dataset("sample", os.path.join(ROOT, "data"))
    worst = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for dtype, want in fixture["records"].items():
            cfg = BaseConfig(save_dir=os.path.join(tmp, dtype), compute_dtype=dtype, **fixture["config"])
            got = lifecycle_record(HippoRAG(cfg, device=device), data)
            worst[dtype] = compare_lifecycle(got, want, LIFECYCLE_SCORE_ATOL[dtype])
    log(f"phase 6 lifecycle: index -> delete -> retrieve -> re-index -> retrieve equals the JAX package "
        f"(float32 and bfloat16); max score diff {json.dumps(worst)}")
    return worst


# ----------------------------------------------------------------------
# Phase 7: the COO operator, Chebyshev, profile_log_dir, the adapter and
# the multihop harness
# ----------------------------------------------------------------------
def coo_record(rag, data):
    """index -> retrieve -> rag_qa on the sample ``data``, in the fixture's form."""
    docs, queries, gold_docs, gold_answers = data
    rag.index(docs)
    return {
        "hipporag.retrieve": _solutions(rag.retrieve(queries)),
        "hipporag.rag_qa": _rag_qa(rag.rag_qa(queries, gold_docs=gold_docs, gold_answers=gold_answers)),
    }


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


def top_agreement(got, want, k=20):
    """(mean top-k set overlap, share of rows with the same top-k order) of
    two [B, N] score tensors; orders from a stable descending sort."""
    g = torch.sort(got, dim=1, descending=True, stable=True).indices[:, :k].cpu().numpy()
    w = torch.sort(want, dim=1, descending=True, stable=True).indices[:, :k].cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(g, w)]))
    return overlap, float(np.mean([np.array_equal(a, b) for a, b in zip(g, w)]))


def bucket_reset(bucket):
    """The phase-2 bucket's [B, N_cap] PPR resets, as graph_search_batch builds them."""
    sizes, index = bucket["sizes"], bucket["index"]
    k = sizes["link_top_k"]
    dpr = batched_scores(bucket["qp"], bucket["passage_emb"])
    cand_vals, cand_idx = fact_topk(bucket["qf"], bucket["fact_emb"], sizes["facts"], k)
    reset, _dpr_norm, _p_valid = seed_reset_batch(index, cand_vals, cand_idx, fallback_mask(bucket), dpr, k, 0.05)
    return reset


def phase7_graph(device, bucket):
    """(a) COO PPR and (b) Chebyshev at the bench headline graph, on the
    phase-2 bucket's resets, held to the ELL power iteration (all 128
    queries) and to float64 scipy (the first ``SCIPY_QUERIES``)."""
    sizes, index = bucket["sizes"], bucket["index"]
    n = sizes["nodes"]
    s2, d2, w2, dangling = bucket["coo"]
    coo = COOGraph(src=s2, dst=d2, w_norm=w2, dangling=dangling, num_nodes=np.asarray(n, np.int32)).to(device)
    reset = bucket_reset(bucket)
    kw = dict(damping=DAMPING, max_iters=PPR_MAX_ITERS, tol=PPR_TOL, return_iters=True)
    solvers = {
        "ell_power": lambda: batched_ppr_ell(index.graph, reset, **kw),
        "ell_chebyshev": lambda: batched_ppr_ell(index.graph, reset, accel="chebyshev", **kw),
        **{f"coo_f32_chunks{c}": (lambda c=c: batched_ppr(coo, reset, edge_chunks=c, **kw)) for c in COO_EDGE_CHUNKS},
        "coo_bf16_chunks1": lambda: batched_ppr(coo, reset, compute_dtype="bfloat16", **kw),
    }
    runs, results = {}, {}
    for name, fn in solvers.items():
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        p, iters = fn()
        sync()
        peak = peak_memory() - base
        ms = time_ms(fn, reps=3)
        it = int(iters.max())
        results[name] = p[:, :n]
        runs[name] = {"iters_per_tile": iters[::128].tolist(), "ms": ms, "ms_per_iter": ms / it,
                      "peak_bytes_above_inputs": peak}
    again, _ = solvers["coo_f32_chunks1"]()
    check(torch.equal(again[:, :n], results["coo_f32_chunks1"]), "phase 7a: a COO rerun is not bit-identical")

    ref = scipy_ppr(s2, d2, w2, dangling, n, reset[:SCIPY_QUERIES, :n].cpu().numpy(), DAMPING)
    ref_t = bucket["scipy_ref"] = torch.from_numpy(ref).to(device)
    ell = results["ell_power"]
    bf16_bound = BF16_TERM_RTOL / (1 - DAMPING) * float(ell.max()) + PPR_TOL
    for name, p in results.items():
        r = runs[name]
        bound = bf16_bound if "bf16" in name else 1e-6
        r["bound"] = bound
        r["max_abs_vs_ell"] = float((p - ell).abs().max())
        r["max_abs_vs_scipy"] = float((p[:SCIPY_QUERIES].double() - ref_t).abs().max())
        r["top20_vs_ell"] = top_agreement(p, ell)
        r["top20_vs_scipy"] = top_agreement(p[:SCIPY_QUERIES].double(), ref_t)
        check(r["max_abs_vs_scipy"] <= bound, f"phase 7 {name}: max|err| vs float64 scipy {r['max_abs_vs_scipy']} > {bound}")
        check(r["max_abs_vs_ell"] <= bound, f"phase 7 {name}: max|err| vs the ELL solver {r['max_abs_vs_ell']} > {bound}")
        if "bf16" not in name:
            check(r["top20_vs_ell"][0] == 1.0 and r["top20_vs_scipy"][0] == 1.0,
                  f"phase 7 {name}: top-20 agreement {r['top20_vs_ell']} / {r['top20_vs_scipy']}")
    log(f"phase 7a/b: PPR at {n} nodes, {len(s2)} directed entries, B={reset.shape[0]}, d={DAMPING}, "
        f"tol {PPR_TOL}; COO rerun bit-identical; " + json.dumps(runs))
    return runs


def trace_summary(path, annotation="retrieve/graph_search"):
    """Device busy time, span and idle share of a chrome trace, and the
    host time of the ``annotation`` ranges beside the device time inside them."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("name") == annotation and e.get("cat") == "user_annotation"]
    busy = merged_busy_us(intervals)
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) if intervals else 0.0
    range_host = sum(e - s for s, e in ranges)
    range_dev = sum(merged_busy_us([(max(s, a), min(e, b)) for s, e in intervals if s < b and e > a])
                    for a, b in ranges)
    kernels = sorted({e["name"] for e in dev if e.get("cat") == "kernel"})
    ops = sorted({e["name"] for e in events if e.get("cat") == "cpu_op"})
    return {
        "device_activities": len(dev), "device_busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
        "idle_share": 1.0 - busy / span if span > 0 else None,
        "graph_search_ranges": len(ranges), "graph_search_host_ms": range_host / 1e3,
        "graph_search_device_busy_ms": range_dev / 1e3,
        "graph_search_device_share": range_dev / range_host if range_host > 0 else None,
        "k1_kernels": [k for k in kernels if "scan_kernel" in k],
        "k2_kernels": [k[:80] for k in kernels if "items_kernel" in k or "combine_kernel" in k],
        "gather_kernels": [k[:80] for k in kernels if "gather" in k or "index_elementwise" in k or "indexSelect" in k],
        "gather_ops": [o for o in ops if o in ("aten::index", "aten::index_select")],
    }


def near_tie_trades(got, want, atol, what):
    """Two rankings of the same queries: at every rank the scores agree
    within ``atol``, and where the passages differ they are a near tie.
    Returns the number of traded positions."""
    trades = 0
    for g, w in zip(got, want):
        check(g.question == w.question and len(g.docs) == len(w.docs), f"{what}: {w.question!r} differs in length")
        want_score = dict(zip(w.docs, w.doc_scores.tolist()))
        for pos, (doc, score) in enumerate(zip(g.docs, g.doc_scores.tolist())):
            check(abs(score - float(w.doc_scores[pos])) <= atol, f"{what}: rank {pos} of {w.question!r} scores apart")
            if doc != w.docs[pos]:
                trades += 1
                check(doc not in want_score or abs(want_score[doc] - float(w.doc_scores[pos])) <= atol,
                      f"{what}: rank {pos} of {w.question!r} differs beyond a near tie")
    return trades


def phase7_served(rag, parity):
    """(d) the served index re-prepared as COO: rankings equal to the ELL
    path's, both held to the native float64 serial solver with the NumPy
    twin beside them; (e) one ``profile_log_dir`` retrieve on ELL first."""
    import glob
    import shutil

    from hipporag_tpu_torch.evaluation.twiki import _twin_seeds, exact_rank_check, numpy_retrieval_twin
    from hipporag_tpu_torch.graph import native

    cfg = rag.global_config
    out = {}
    t0 = time.perf_counter()
    ell_sols = rag.retrieve(parity, num_to_retrieve=cfg.retrieval_top_k)
    out["ell_retrieve_s"] = time.perf_counter() - t0

    # (e) profile_log_dir on the ELL path
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    cfg.profile_log_dir = PROFILE_DIR
    fused_topk.SCAN_LAUNCHES.reset()
    k2_since = k2_reset()
    t0 = time.perf_counter()
    with recording():
        rag.retrieve(parity[:PROFILE_QUERIES], num_to_retrieve=cfg.retrieval_top_k)
    out["profiled_retrieve_s"] = time.perf_counter() - t0
    out["profiled_k1_launches"] = fused_topk.SCAN_LAUNCHES.count
    k2_path("phase7e_profiled_retrieve", k2_since)
    cfg.profile_log_dir = None
    traces = glob.glob(os.path.join(PROFILE_DIR, "trace-*.json"))
    check(len(traces) == 1, f"phase 7e: expected one trace in {PROFILE_DIR}, found {traces}")
    prof = out["profile"] = {"trace": os.path.relpath(traces[0], ROOT), **trace_summary(traces[0])}
    check(prof["device_activities"] > 0, "phase 7e: the trace holds no device activity")
    check(bool(prof["k1_kernels"]), "phase 7e: the trace does not name K1's kernel")
    check(bool(prof["k2_kernels"]), "phase 7e: the trace does not name K2's kernels (the PageRank steps)")
    check(prof["graph_search_ranges"] > 0, "phase 7e: no retrieve/graph_search range in the trace")
    log("phase 7e: profile_log_dir over one retrieve of "
        f"{PROFILE_QUERIES} queries on the served index: " + json.dumps(prof))

    # (d) the same index as COO
    cfg.ppr_format = "coo"
    t0 = time.perf_counter()
    rag.prepare_retrieval_objects()
    sync()
    out["coo_prepare_s"] = time.perf_counter() - t0
    graph = rag._backend.index.graph
    check(type(graph) is COOGraph and graph.src.device.type == torch.device(rag.device).type,
          "phase 7d: the served index is not a COO operator on the card")
    fused_topk.SCAN_LAUNCHES.reset()
    k2_since = k2_reset()
    t0 = time.perf_counter()
    with recording():
        coo_sols = rag.retrieve(parity, num_to_retrieve=cfg.retrieval_top_k)
    out["coo_retrieve_s"] = time.perf_counter() - t0
    out["coo_k1_launches"] = fused_topk.SCAN_LAUNCHES.count
    k2_path("phase7d_served_coo", k2_since, kernel=False)
    check(out["coo_k1_launches"] > 0, "phase 7d: the COO retrieve did not launch the fused kernel")
    out["coo_vs_ell_trades"] = near_tie_trades(coo_sols, ell_sols, PARITY_ATOL, "phase 7d COO vs ELL")

    check(native.native_available(), f"phase 7d: the native graph core did not build: {native.build_error}")
    t0 = time.perf_counter()
    seeds = _twin_seeds(rag, parity)
    twin = numpy_retrieval_twin(rag, parity, top_k=EXACT_TOP_K, seeds=seeds)
    exact = {name: exact_rank_check(rag, parity, docs, top_k=EXACT_TOP_K, seeds=seeds)
             for name, docs in (("ell", [s.docs for s in ell_sols]), ("coo", [s.docs for s in coo_sols]),
                                ("numpy_twin", twin))}
    out["exact_check_s"] = time.perf_counter() - t0
    out["exact"] = exact
    out["twin_vs_ell_overlap"] = float(np.mean([
        len(set(t) & set(s.docs[:EXACT_TOP_K])) / max(1, min(EXACT_TOP_K, len(s.docs)))
        for t, s in zip(twin, ell_sols)]))
    for name in ("ell", "coo"):
        check(exact[name]["solver"] == "native_ppr_serial", f"phase 7d: exact solver {exact[name]['solver']}")
        check(exact[name]["agreement"] >= EXACT_AGREEMENT_MIN,
              f"phase 7d: {name} top-{EXACT_TOP_K} agreement with ppr_serial {exact[name]['agreement']} "
              f"< {EXACT_AGREEMENT_MIN}")
    log(f"phase 7d: {len(parity)} parity queries on the served index as COO rank as ELL "
        f"({out['coo_vs_ell_trades']} near-tie trades, |Δ| ≤ {PARITY_ATOL}); " + json.dumps(
            {k: v for k, v in out.items() if k != "profile"}))
    return out


def phase7_sample(device):
    """(c) ``HippoRAG(ppr_format="coo")`` on the sample corpus in float32
    and bfloat16, held to the JAX package's fixture."""
    with open(COO_FIXTURE) as fh:
        fixture = json.load(fh)
    data = load_dataset("sample", os.path.join(ROOT, "data"))
    out = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for dtype, want in fixture["records"].items():
            cfg = BaseConfig(save_dir=os.path.join(tmp, dtype), compute_dtype=dtype, **fixture["config"])
            rag = HippoRAG(cfg, device=device)
            fused_topk.SCAN_LAUNCHES.reset()
            k2_since = k2_reset()
            with recording():
                got = coo_record(rag, data)
            launches = fused_topk.SCAN_LAUNCHES.count
            k2_path(f"phase7c_coo_sample_{dtype}", k2_since, kernel=False)
            graph = rag._backend.index.graph
            check(type(graph) is COOGraph and graph.src.device.type == torch.device(device).type,
                  f"phase 7c ({dtype}): not a COO operator on the card")
            check(launches > 0, f"phase 7c ({dtype}): retrieve did not launch the fused kernel")
            out[dtype] = {"max_score_diff": compare_records(got, want, COO_SCORE_ATOL[dtype]),
                          "kernel_launches": launches}
    log("phase 7c: HippoRAG(ppr_format='coo') on the sample corpus equals the JAX package (float32 and "
        "bfloat16); " + json.dumps(out))
    return out


def adapter_flops(dim, hidden, pairs):
    """Products of one step: forward x·w_in, h·w_out and the [B, B] logits
    (2 B D H + 2 B H D + 2 B B D), backward twice that."""
    return 3 * (4 * pairs * dim * hidden + 2 * pairs * pairs * dim)


def adapter_inputs(device, sizes=ADAPTER, seed=0):
    """Phase 7f's (query, positive) pairs and initial parameters, from ``seed``."""
    from hipporag_tpu_torch.models.adapter import init_adapter

    d, h, b = sizes["dim"], sizes["hidden"], sizes["pairs"]
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((b, d), dtype=np.float32)
    rot = torch.linalg.qr(torch.from_numpy(rng.standard_normal((d, d))).to(device))[0]
    # unit rows, as the embedders give them: raw Gaussian rows of norm
    # sqrt(D) = 64 make the logits ~64x larger and the loss reaches 0 in
    # four steps, which leaves nothing to compare
    q = torch.nn.functional.normalize(torch.from_numpy(queries).to(device), dim=1)
    pos = torch.nn.functional.normalize((q.double() @ rot).float(), dim=1)
    return q, pos, init_adapter(d, h, generator=torch.Generator().manual_seed(seed), device=device)


def phase7_adapter(device, sizes=ADAPTER, seed=0):
    """(f) AdamW steps of the adapter at NV-Embed-v2's width on (query,
    positive) pairs, positives a random rotation of the queries (as
    ``tests/test_parallel.py`` builds them, then L2-normalized); the first
    steps equal the same steps on the CPU."""
    from hipporag_tpu_torch.models.adapter import AdapterParams, adamw, make_train_step

    d, h, b = sizes["dim"], sizes["hidden"], sizes["pairs"]
    q, pos, params = adapter_inputs(device, sizes, seed)
    cpu_params = AdapterParams(*(p.detach().cpu().clone().requires_grad_() for p in params))

    step = make_train_step(adamw(params, sizes["lr"]))
    losses = [step(params, q, pos)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(sizes["steps"] - 1):
        losses.append(step(params, q, pos))
    end.record()
    sync()
    ms = start.elapsed_time(end) / (sizes["steps"] - 1)
    losses = torch.stack(losses).cpu().tolist()

    t0 = time.perf_counter()
    cpu_step = make_train_step(adamw(cpu_params, sizes["lr"]))
    q_cpu, pos_cpu = q.cpu(), pos.cpu()
    cpu_losses = [float(cpu_step(cpu_params, q_cpu, pos_cpu)) for _ in range(sizes["cpu_steps"])]
    cpu_s = time.perf_counter() - t0
    flops = adapter_flops(d, h, b)
    out = {"dim": d, "hidden": h, "pairs": b, "steps": sizes["steps"], "lr": sizes["lr"],
           "ms_per_step": ms, "gflop_per_step": flops / 1e9, "f32_tflops": flops / ms / 1e9,
           "bound_ms": flops / F32_PEAK_FLOPS * 1e3, "first_losses": losses[:sizes["cpu_steps"]],
           "cpu_losses": cpu_losses, "last_loss": losses[-1], "cpu_s": cpu_s}
    check(all(np.isfinite(losses)), "phase 7f: a loss is not finite")
    check(np.allclose(losses[:sizes["cpu_steps"]], cpu_losses, rtol=1e-4, atol=0.0),
          f"phase 7f: the card's first losses {losses[:5]} differ from the CPU's {cpu_losses}")
    check(losses[-1] < losses[0], f"phase 7f: the loss did not fall ({losses[0]} -> {losses[-1]})")
    log("phase 7f: adapter AdamW steps: " + json.dumps(out))
    return out


def phase7_multihop(device):
    """(g) ``run_multihop_eval`` on the card, held to the JAX package's numbers."""
    from hipporag_tpu_torch.evaluation.multihop import run_multihop_eval

    with open(MULTIHOP_FIXTURE) as fh:
        want = json.load(fh)["result"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        fused_topk.SCAN_LAUNCHES.reset()
        k2_since = k2_reset()
        t0 = time.perf_counter()
        with recording():
            got = run_multihop_eval(save_dir=tmp, device=device)
        wall = time.perf_counter() - t0
        launches = fused_topk.SCAN_LAUNCHES.count
        k2_path("phase7g_multihop", k2_since)
    check("multihop3_error" not in got, f"phase 7g: {got.get('multihop3_error')}")
    check(got == want, f"phase 7g: {got} != the JAX package's {want}")
    check(launches > 0, "phase 7g: the multihop runs did not launch the fused kernel")
    out = {"result": got, "wall_s": wall, "kernel_launches": launches}
    log("phase 7g: run_multihop_eval on the card equals the JAX package: " + json.dumps(out))
    return out


# ----------------------------------------------------------------------
# Phase 8: the multi-device path on virtual shards of the one card
# ----------------------------------------------------------------------
def shard_devices(device):
    """The mesh devices of phase 8: ``SHARDS`` virtual shards of ``device``."""
    return [device] * SHARDS


def phase8_scoring(device, bucket):
    """(a) ``make_sharded_score_topk`` at phase 2's shape on (1, 4) and
    (2, 2), held to the single-device plain path; placing the keys on
    virtual shards of the card that holds them allocates nothing."""
    sizes = bucket["sizes"]
    qf, keys, n, k = bucket["qf"], bucket["fact_emb"], sizes["facts"], sizes["link_top_k"]
    want_vals, want_idx = fact_topk(qf, keys, n, k, use_pallas=False)
    want_norm = batched_normalized_scores(qf, keys, n)
    out = {"plain_fact_topk_ms": time_ms(lambda: fact_topk(qf, keys, n, k, use_pallas=False), reps=3)}
    for shape in SHARD_MESHES:
        mesh = make_mesh(shape, devices=shard_devices(device))
        sync()
        before = torch.cuda.memory_allocated()
        grid = corpus_sharded(mesh).place(keys)
        placed_bytes = torch.cuda.memory_allocated() - before
        check(placed_bytes == 0, f"phase 8a {shape}: placing the keys on virtual shards allocated {placed_bytes} B")
        run = make_sharded_score_topk(mesh, k=k)
        norm, vals, idx = run(qf, grid, n)
        check(torch.equal(idx, want_idx), f"phase 8a {shape}: sharded top-k indices differ from the plain path")
        norm_err = float((norm - want_norm).abs().max())
        vals_err = float((vals - want_vals).abs().max())
        check(norm_err <= SHARDED_SCORE_ATOL and vals_err <= SHARDED_SCORE_ATOL,
              f"phase 8a {shape}: norm max|err| {norm_err}, values {vals_err} > {SHARDED_SCORE_ATOL}")
        out[str(shape)] = {"norm_max_abs_err": norm_err, "vals_max_abs_err": vals_err,
                           "placed_bytes": placed_bytes, "ms": time_ms(lambda: run(qf, grid, n), reps=3)}
    log(f"phase 8a: sharded scoring at B={qf.shape[0]} N={n} D={keys.shape[1]} k={k} on virtual shards: "
        + json.dumps(out))
    return out


def phase8_ppr(device, bucket):
    """(b) sharded ELL PPR at (1, 4) and (2, 2), held to ``batched_ppr_ell``
    on each dp group's columns and to float64 scipy; (c) sharded COO PPR at
    (1, 4), held to the single-device COO solve, a rerun bit-identical."""
    sizes, index = bucket["sizes"], bucket["index"]
    n = sizes["nodes"]
    s2, d2, w2, dangling = bucket["coo"]
    coo = COOGraph(src=s2, dst=d2, w_norm=w2, dangling=dangling, num_nodes=np.asarray(n, np.int32))
    reset = bucket_reset(bucket)
    b, n_cap = reset.shape
    kw = dict(damping=DAMPING, max_iters=PPR_MAX_ITERS, tol=PPR_TOL)
    out = {}
    for shape in SHARD_MESHES:
        dp, corpus = shape
        mesh = make_mesh(shape, devices=shard_devices(device))
        t0 = time.perf_counter()
        sg = shard_graph_ell(coo, num_shards=corpus)
        sg_dev = put_sharded_ell(mesh, sg)
        build_s = time.perf_counter() - t0
        r = torch.nn.functional.pad(reset, (0, corpus * sg.shard_nodes - n_cap))
        run = make_sharded_ppr_ell(mesh, **kw)
        p, iters = run(sg_dev, r, return_iters=True)
        lane = b // dp
        want = [batched_ppr_ell(index.graph, reset[g * lane:(g + 1) * lane], return_iters=True, **kw)
                for g in range(dp)]
        want_p, want_it = torch.cat([w[0] for w in want]), torch.cat([w[1] for w in want])
        check(torch.equal(iters, want_it), f"phase 8b {shape}: iterations {iters.tolist()} != {want_it.tolist()}")
        torch.testing.assert_close(p[:, :n_cap], want_p, rtol=SHARDED_ELL_RTOL, atol=SHARDED_ELL_ATOL)
        check(not bool(p[:, n_cap:].any()), f"phase 8b {shape}: mass on padding columns")
        scipy_err = float((p[:SCIPY_QUERIES, :n].double() - bucket["scipy_ref"]).abs().max())
        check(scipy_err <= 1e-6, f"phase 8b {shape}: max|err| vs float64 scipy {scipy_err} > 1e-6")
        ms = time_ms(lambda: run(sg_dev, r), reps=2)
        it = int(iters.max())
        out[f"ell {shape}"] = {
            "iters_per_tile": iters[::max(1, min(lane, 128))].tolist(), "ms": ms, "ms_per_iter": ms / it,
            "max_abs_vs_single": float((p[:, :n_cap] - want_p).abs().max()), "max_abs_vs_scipy": scipy_err,
            "host_build_s": build_s, "counters": sharded_ell_counters(sg, b, dp)}

    mesh = make_mesh(SHARD_MESHES[0], devices=shard_devices(device))
    sg = shard_graph(coo, num_shards=SHARDS)
    sg_dev = put_sharded_graph(mesh, sg)
    r = torch.nn.functional.pad(reset, (0, SHARDS * sg.shard_nodes - n_cap))
    run = make_sharded_ppr(mesh, **kw)
    p, iters = run(sg_dev, r, return_iters=True)
    check(torch.equal(run(sg_dev, r), p), "phase 8c: a sharded COO rerun is not bit-identical")
    want, want_it = batched_ppr(coo.to(device), reset, return_iters=True, **kw)
    coo_err = float((p[:, :n_cap] - want).abs().max())
    check(coo_err <= SHARDED_COO_ATOL, f"phase 8c: max|err| vs the single-device COO solve {coo_err}")
    ms = time_ms(lambda: run(sg_dev, r), reps=2)
    out[f"coo {SHARD_MESHES[0]}"] = {"iters_per_tile": iters[::128].tolist(), "single_iters": want_it[::128].tolist(),
                                     "ms": ms, "ms_per_iter": ms / int(iters.max()), "max_abs_vs_single": coo_err}
    log(f"phase 8b/c: sharded PPR at {n} nodes, {len(s2)} directed entries, B={b} on virtual shards: "
        + json.dumps(out))
    return out


def phase8_served(rag, parity):
    """(d) phase 6's live index re-prepared with ``mesh_shape=(1, 4)``: the
    parity queries rank as on one device; 256 served through the native front end."""
    import threading

    from hipporag_tpu_torch.serving import RetrievalService
    from hipporag_tpu_torch.serving.native_http import make_native_server

    cfg = rag.global_config
    cfg.ppr_format = "ell"  # phase 7d left the index as COO
    rag.prepare_retrieval_objects()
    t0 = time.perf_counter()
    direct = rag.retrieve(parity, num_to_retrieve=cfg.retrieval_top_k)
    out = {"single_retrieve_s": time.perf_counter() - t0}
    cfg.mesh_shape = SHARD_MESHES[0]
    rag.mesh_devices = shard_devices(rag.device)
    t0 = time.perf_counter()
    rag.prepare_retrieval_objects()
    sync()
    out["sharded_prepare_s"] = time.perf_counter() - t0
    check(isinstance(rag._backend, ShardedBackend) and rag._backend.mesh.corpus == SHARDS,
          "phase 8d: the sharded backend is not active")
    t0 = time.perf_counter()
    sharded = rag.retrieve(parity, num_to_retrieve=cfg.retrieval_top_k)
    out["sharded_retrieve_s"] = time.perf_counter() - t0
    out["trades_vs_single"] = near_tie_trades(sharded, direct, PARITY_ATOL, "phase 8d sharded vs single device")

    requests = [("/retrieve", {"query": q, "top_k": TOP_KS[i % len(TOP_KS)]}) for i, q in enumerate(parity)]
    with RetrievalService(rag, max_wait_ms=SERVE_MAX_WAIT_MS) as svc:
        server = make_native_server(svc, port=0, num_workers=2 * SERVE["clients"])
        thread = threading.Thread(target=server.serve_forever, name="native-http-sharded")
        thread.start()
        try:
            t0 = time.perf_counter()
            records = run_clients(server.server_address[1], requests, SERVE["clients"])
            wall = time.perf_counter() - t0
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
    check(all(r[2] == 200 for r in records), f"phase 8d: statuses {sorted({r[2] for r in records})}")
    out["served_trades_vs_sharded"] = parity_trades(requests, records, sharded, PARITY_ATOL)
    out["served"] = {"requests": len(records), "wall_s": wall, "retrieve_per_s": len(records) / wall,
                     "latency_ms": latency_ms(records)}
    cfg.mesh_shape = (1, 1)
    log(f"phase 8d: {len(parity)} parity queries on the live index with mesh_shape {SHARD_MESHES[0]} rank as one "
        f"device ({out['trades_vs_single']} near-tie trades, |Δ| ≤ {PARITY_ATOL}); " + json.dumps(out))
    return out


def phase8_adapter(device, single_losses, sizes=ADAPTER, seed=0):
    """(e) the dp+tp adapter step on (2, 2) over phase 7f's pairs: its
    first losses equal phase 7f's single-device steps."""
    from hipporag_tpu_torch.models.adapter import adamw, make_sharded_train_step

    q, pos, params = adapter_inputs(device, sizes, seed)
    mesh = make_mesh(SHARD_MESHES[1], devices=shard_devices(device))
    step, place = make_sharded_train_step(mesh, lambda ps: adamw(ps, sizes["lr"]))
    sharded, qb, pb = place(params, q, pos)
    losses = [float(step(sharded, qb, pb)) for _ in range(SHARDED_ADAPTER_STEPS)]
    ms = time_ms(lambda: step(sharded, qb, pb), reps=5)
    want = single_losses[:SHARDED_ADAPTER_STEPS]
    check(np.allclose(losses, want, rtol=SHARDED_ADAPTER_RTOL, atol=0.0),
          f"phase 8e: the sharded step's losses {losses} differ from the single-device {want}")
    out = {"mesh": list(SHARD_MESHES[1]), "losses": losses, "single_losses": want, "ms_per_step": ms,
           "w_in_shard_shape": list(sharded.w_in[0].shape)}
    log("phase 8e: dp+tp adapter steps: " + json.dumps(out))
    return out


def phase8_encoder(device):
    """(f) the 768x12 encoder with ``mesh_shape=(1, 4)``: 15 of phase 4's
    texts (the batch pads to 16), equal to the unsharded encoder and to the
    JAX package's fixture within phase 4's bounds."""
    fixture = np.load(ENCODER_FIXTURE)
    texts = [str(t) for t in fixture["texts"]][:15]
    bounds = {k: float(fixture[k]) for k in ("f32_max_abs", "bf16_max_abs", "bf16_min_cos")}
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for dt in ("bfloat16", "float32"):
            cfg = BaseConfig(embedding_model_name=ENCODER, embedding_model_dtype=dt, embedding_batch_size=ENCODE_BATCH,
                             save_dir=tmp, mesh_shape=SHARD_MESHES[0])
            sharded = TorchEncoderEmbeddingModel(cfg, device=device, mesh_devices=shard_devices(device))
            check(len(sharded._shard_encoders) == SHARDS and all(e is sharded.encoder for e in sharded._shard_encoders),
                  "phase 8f: virtual shards must share one copy of the weights")
            plain = encoder_model(device, dt, tmp)
            ids, mask = sharded.pretokenize(texts)
            got = sharded.encode_pretokenized(ids, mask).cpu().numpy()
            out[dt] = {
                "vs_unsharded": check_bounds(got, plain.encode_pretokenized(ids, mask).cpu().numpy(), bounds, dt,
                                             f"phase 8f ({dt}) vs the unsharded encoder"),
                "vs_fixture": check_bounds(got, fixture[f"embeddings_{dt}"][:15], bounds, dt,
                                           f"phase 8f ({dt}) vs the fixture"),
            }
            del sharded, plain
            torch.cuda.empty_cache()
    log("phase 8f: batch-sharded encoder: " + json.dumps(out))
    return out


def phase8_dryrun(device):
    """(g) ``parallel.dryrun`` at 4 virtual shards."""
    from hipporag_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(SHARDS, devices=shard_devices(device), log=lambda m: log(f"phase 8g: {m}"))
    log("phase 8g: " + json.dumps(out))
    return out


# ----------------------------------------------------------------------
# Phase 9: the quality sections through evaluation/bench_sections
# ----------------------------------------------------------------------
def phase9_sections(device):
    """``bench_sections.run_section`` on the card: ``multihop`` held to the
    JAX package's numbers; each corpus section run when its corpus file
    exists, and reported as skipped when it does not."""
    from hipporag_tpu_torch.evaluation import bench_sections

    with open(MULTIHOP_FIXTURE) as fh:
        want = json.load(fh)["result"]
    out = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        fused_topk.SCAN_LAUNCHES.reset()
        k2_since = k2_reset()
        t0 = time.perf_counter()
        with recording():
            got = bench_sections.run_section("multihop", os.path.join(tmp, "multihop"), device=device)
        wall = time.perf_counter() - t0
        launches = fused_topk.SCAN_LAUNCHES.count
        k2_path("phase9_multihop_section", k2_since, kernel=torch.device(device).type == "cuda")
        check("multihop3_error" not in got, f"phase 9 multihop: {got.get('multihop3_error')}")
        check(got == want, f"phase 9 multihop: {got} != the JAX package's {want}")
        check(launches > 0, "phase 9 multihop: the section did not launch the fused kernel")
        out["multihop"] = {"result": got, "wall_s": wall, "kernel_launches": launches}
        log("phase 9: run_section('multihop') on the card equals the JAX package: " + json.dumps(out["multihop"]))
        corpus = bench_sections.corpus_path()
        for section in CORPUS_SECTIONS:
            if not os.path.exists(corpus):
                out[section] = {"skipped": f"corpus absent: {corpus}"}
                log(f"phase 9: section {section} skipped: its corpus {corpus} is absent "
                    "(BENCH_2WIKI_CORPUS may name a copy of the 2WikiMultihopQA corpus)")
                continue
            t0 = time.perf_counter()
            result = bench_sections.run_section(section, os.path.join(tmp, section), device=device)
            out[section] = {"result": result, "wall_s": time.perf_counter() - t0}
            log(f"phase 9: section {section}: " + json.dumps(out[section], default=str))
    return out


# ----------------------------------------------------------------------
# Phase 10: K2, the ELL PageRank step kernel
# ----------------------------------------------------------------------
def hub_heavy_graph(nodes=3_000, hubs=3, hub_degree=1_500, isolated=10, seed=0):
    """A graph with every bucket width up to 256, hubs spanning several
    512-wide chunk rows, zero-in-degree nodes and capacity padding rows."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(nodes):
        deg = hub_degree if v < hubs else int(rng.integers(1, 300 if v % 10 == 0 else 17))
        nb = rng.choice(nodes, size=deg, replace=False)
        nb = nb[nb != v]
        src.append(np.full(len(nb), v))
        dst.append(nb)
    src, dst = np.concatenate(src), np.concatenate(dst)
    w = rng.uniform(0.1, 1.0, len(src)).astype(np.float32)
    n = nodes + isolated
    cap = -(-(n + 1) // 128) * 128
    s2, d2, w2, dang = normalize_symmetric_coo(src, dst, w, n, cap)
    return ell_from_coo(s2, d2, w2, dang, n, cap)


def k2_resets(rng, graph, batch, passage_nodes=None):
    """[batch, N_pad] resets: 5 weighted seeds per query, plus passage seeds
    (0.05 x a uniform DPR score on every passage) where the graph has them."""
    n = int(graph.num_nodes)
    reset = np.zeros((batch, graph.local_inv.shape[0]), np.float32)
    for i in range(batch):
        reset[i, rng.choice(n, 5, replace=False)] = rng.uniform(0.1, 1.0, 5)
    if passage_nodes is not None:
        reset[:, passage_nodes] += PASSAGE_WEIGHT * rng.uniform(0.0, 1.0, (batch, len(passage_nodes)))
    return torch.from_numpy(reset).to(graph.slot_to_node.device)


def k2_slot_state(graph, reset, ld):
    """A tile's slot-space reset [S, ld] (zero columns past the batch) and R_d."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    r = ell_ops._normalized_reset(reset, graph.num_nodes.to(reset.device)).T.contiguous()
    r_slot = torch.cat([r, r.new_zeros(1, r.shape[1])])[graph.slot_to_node]
    rdm = (r * graph.dangling[:, None]).sum(0)
    return torch.nn.functional.pad(r_slot, (0, ld - r.shape[1])).contiguous(), rdm.contiguous()


def k2_torch_stepper(graph, gather_dtype):
    """The plain torch step on the card (``_spmv_ell`` and the affine update of
    ``batched_ppr_ell``), as ``fn(p, r, c, rdm, b) -> (p_next [S, b], c_next)``
    over the first b columns of [S, ld] states; the hub row map and d are
    made once, as a solve makes them."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    hub_rows = ell_ops._hub_rows(graph)
    d = torch.tensor(DAMPING, dtype=torch.float32, device=graph.slot_to_node.device)

    def step(p, r, c, rdm, b):
        y = ell_ops._spmv_ell(graph, p[:, :b].contiguous(), hub_rows, gather_dtype)
        dm = c[None, :b] * rdm[None, :b]
        return (1.0 - d) * r[:, :b] + d * (y + dm * r[:, :b]), ((1.0 - d) + d * dm)[0]

    return step


def k2_step_bound(plan, graph, p, b, gather_dtype):
    """Elementwise bound on |kernel - torch| of one step: both sum a slot's
    n non-negative terms in float32 in some order, each within
    (n - 1) 2^-24 of the exact sum y (float64 here), d y enters p_next, and
    the affine update adds a few roundings of p_next's size."""
    ent = plan.ent.long()
    items = plan.items.long()
    lens = items[:, 2]
    slot_of_entry = torch.zeros(ent.shape[0], dtype=torch.long, device=p.device)
    order = torch.repeat_interleave(items[:, 1] - (torch.cumsum(lens, 0) - lens), lens) + torch.arange(
        int(lens.sum()), device=p.device)
    slot_of_entry[order] = torch.repeat_interleave(items[:, 0], lens)
    w = ent[:, 1].int().view(torch.float32).double()
    src = p[:, :b].double()
    if gather_dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).double()
        src = p[:, :b].to(torch.bfloat16).double()
    y = torch.zeros(p.shape[0], b, dtype=torch.float64, device=p.device)
    y.index_add_(0, slot_of_entry, src[ent[:, 0]] * w[:, None])
    n = torch.bincount(slot_of_entry, minlength=p.shape[0]).double()[:, None]
    return DAMPING * 2 * torch.clamp_min(n - 1, 0) * 2.0**-24 * y, y


def k2_check_step(tag, graph, plan, reset, b, gather_dtype):
    """One kernel step against the torch step at b columns; the kernel's own
    residual, bf16 copy and determinism. Returns max |kernel - torch| and the
    largest share of the stated bound it used."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    ld = -(-b // 4) * 4
    r, rdm = k2_slot_state(graph, reset[:b], ld)
    # a state a few steps in: the reset moved by two torch steps
    p, c = r, torch.ones(b, device=r.device)
    f32_step = k2_torch_stepper(graph, None)
    for _ in range(2):
        p_b, c = f32_step(p, r, c, rdm, b)
        p = torch.nn.functional.pad(p_b, (0, ld - b)).contiguous()
    bf16 = gather_dtype == torch.bfloat16
    pg = p.to(torch.bfloat16) if bf16 else p

    def run():
        out = (torch.empty_like(p), torch.empty_like(pg) if bf16 else None, torch.empty_like(c),
               p.new_empty(plan.n_parts, ld), p.new_empty(1))
        ell_ops.ell_step(plan, pg, p, r, c, rdm, DAMPING, out[0], out[1], out[2], out[3], out[4])
        sync()
        return out

    first, second = run(), run()
    for a, z, name in zip(first, second, ("p_next", "pg_next", "c_next", "partials", "resid")):
        if a is not None and name != "partials":
            check(torch.equal(a, z), f"phase 10 ({tag}, b={b}): two runs give different {name}")
    p_next, pg_next, c_next, _, resid = first
    want = torch.maximum((p_next[:, :b] - p[:, :b]).abs().amax(), (c_next - c).abs().amax())
    check(torch.equal(resid[0], want), f"phase 10 ({tag}, b={b}): the kernel's residual {resid.item()} is not "
          f"the max over its own outputs {want.item()}")
    check(bool((p_next[:, b:] == 0).all()), f"phase 10 ({tag}, b={b}): columns past b are not masked")
    if bf16:
        check(torch.equal(pg_next, p_next.to(torch.bfloat16)), f"phase 10 ({tag}, b={b}): bf16 copy differs")
    torch_next, torch_c = k2_torch_stepper(graph, gather_dtype)(p, r, c, rdm, b)
    check(torch.equal(c_next, torch_c), f"phase 10 ({tag}, b={b}): c_next differs from the torch step")
    bound, _ = k2_step_bound(plan, graph, p, b, gather_dtype)
    diff = (p_next[:, :b] - torch_next).abs().double()
    slack = bound + 4 * 2.0**-24 * torch_next.abs().double()
    check(bool((diff <= slack).all()), f"phase 10 ({tag}, b={b}): kernel step off the torch step by "
          f"{float(diff.max())} beyond the stated bound")
    return float(diff.max()), float((diff / slack.clamp_min(1e-30)).max())


def k2_solves(tag, graph, cpu_graph, reset, gather):
    """Full solves on the card (the kernel route) against the same solves
    on the CPU (the torch step): per-tile iteration counts equal, max |Δp|,
    launches; the card's solve never runs ``_spmv_ell``."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    out = {}
    for accel in ("power", "chebyshev"):
        kw = dict(damping=DAMPING, max_iters=PPR_MAX_ITERS, tol=PPR_TOL, compute_dtype=gather,
                  accel=accel, return_iters=True)
        p_torch, it_torch = batched_ppr_ell(cpu_graph, reset.cpu(), **kw)
        p_torch, it_torch = p_torch.to(reset.device), it_torch.to(reset.device)
        spmv = ell_ops._spmv_ell

        def refuse(*args, **kwargs):
            raise AssertionError("phase 10: the kernel route ran the torch SpMV")

        before = ell_ops.ELL_STEP_LAUNCHES.count
        try:
            ell_ops._spmv_ell = refuse
            with recording(), span("retrieve/ppr") as counted:
                p_k, it_k = batched_ppr_ell(graph, reset, **kw)
            p_k2, _ = batched_ppr_ell(graph, reset, **kw)
        finally:
            ell_ops._spmv_ell = spmv
        sync()
        launches = ell_ops.ELL_STEP_LAUNCHES.count - before
        tile_iters = it_k[::128].tolist()
        check(torch.equal(it_k, it_torch), f"phase 10 ({tag}, {accel}, {gather}): iterations {it_k.unique().tolist()}"
              f" on the card, {it_torch.unique().tolist()} on the CPU's torch step")
        check(torch.equal(p_k, p_k2), f"phase 10 ({tag}, {accel}, {gather}): two kernel solves differ")
        check(launches == 2 * sum(tile_iters),
              f"phase 10 ({tag}, {accel}): {launches} launches for {sum(tile_iters)} steps x 2 solves")
        attrs = counted.attrs
        check(attrs.get("kernel_iterations") == attrs.get("iterations") == sum(tile_iters),
              f"phase 10 ({tag}, {accel}): span counts {attrs}, want {sum(tile_iters)} kernel iterations")
        out[f"{accel}_{gather or 'float32'}"] = {
            "iters_per_tile": tile_iters,
            "max_abs_vs_torch": float((p_k - p_torch).abs().max()),
            "launches_per_solve": launches // 2,
        }
    return out


def k2_timing(graph, plan, reset, b=128):
    """CUDA-event ms per step at b columns: the kernel (f32 and bf16 gathers)
    and the torch step, against the least time of one iteration; and whole
    solves on the card, ms per iteration of host time."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    ld = b
    r, rdm = k2_slot_state(graph, reset[:b], ld)
    c = torch.ones(b, device=r.device)
    out = {}
    for tag, gdt in (("float32", None), ("bfloat16", torch.bfloat16)):
        pg = r.to(gdt) if gdt is not None else r
        bufs = (torch.empty_like(r), torch.empty_like(pg) if gdt is not None else None, torch.empty_like(c),
                r.new_empty(plan.n_parts, ld), r.new_empty(1))
        out[f"kernel_ms_{tag}"] = time_ms(lambda: ell_ops.ell_step(plan, pg, r, r, c, rdm, DAMPING, *bufs), reps=50)
        torch_step = k2_torch_stepper(graph, gdt)
        out[f"torch_step_ms_{tag}"] = time_ms(lambda: torch_step(r, r, c, rdm, b), reps=10)
    entries, nodes = int(plan.ent.shape[0]), int(graph.num_nodes)
    least_bytes = 8 * entries + 2 * 4 * nodes * b
    out["least_ms"] = least_bytes / HBM_BYTES_PER_S * 1e3
    out["least_bytes"] = least_bytes
    out["gathered_row_bytes"] = entries * 4 * b
    out["roofline_share_float32"] = out["least_ms"] / out["kernel_ms_float32"]
    kw = dict(damping=DAMPING, max_iters=PPR_MAX_ITERS, tol=PPR_TOL, return_iters=True)
    _, iters = batched_ppr_ell(graph, reset[:b], **kw)
    sync()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        batched_ppr_ell(graph, reset[:b], **kw)
    sync()
    wall = (time.perf_counter() - t0) / reps
    out["kernel_solve_ms"] = wall * 1e3
    out["kernel_solve_ms_per_iter"] = wall * 1e3 / int(iters[0])
    return out


def k2_plan_stats(graph, plan):
    items = plan.items
    return {
        "slots": plan.n_slots, "nodes": int(graph.num_nodes), "entries": int(plan.ent.shape[0]),
        "ell_entries_with_padding": ell_gathered_rows_per_iter(graph), "items": int(items.shape[0]),
        "wide_slots": int(plan.multi.shape[0]), "partial_rows": plan.n_parts,
        "max_partials_per_slot": int(plan.multi[:, 2].max()) if plan.multi.shape[0] else 0,
        "hub_chunk_rows": int(graph.hub_idx.shape[0]), "buckets": len(graph.bucket_idx),
        "plan_bytes": sum(t.nbytes for t in (plan.ent, plan.items, plan.multi)),
    }


def phase10_k2(device, bench_seed=K2_BENCH_SEED):
    """K2 on the card, on a small hub-heavy graph and on the benchmark's
    graph (``perfbench``'s ``nvembed2-musique`` deployment at ``bench_seed``):
    one step against the torch step at b = 8, 32, 104, 128 with f32 and
    bf16 gathers (within the stated bound, the kernel's residual equal to
    the max over its outputs, bit-identical reruns), whole power and
    Chebyshev solves with the iteration counts of the CPU's torch step,
    then times."""
    from hipporag_tpu_torch.ops import pagerank as ell_ops

    start = time.perf_counter()
    ell_ops._step_fn()
    build_s, build_log = _kernels.build_info.get("ell_ppr_step", (0.0, ""))
    log(f"phase 10: kernel build: ell_ppr_step.cu {build_s:.1f} s (load {time.perf_counter() - start:.1f} s)")
    for line in build_log.strip().splitlines():
        log(f"  nvcc: {line}")
    rng = np.random.default_rng(10)
    graphs = {"hub_heavy": (hub_heavy_graph().to(device), None)}
    from perfbench.deployment import Deployment

    t0 = time.perf_counter()
    with open(os.path.join(ROOT, "perfbench", "configs", "nvembed2-musique.json")) as fh:
        dep = Deployment(json.load(fh), bench_seed, device)
    index = dep.rag._backend.index
    passages = index.passage_node_ids[:index.num_passages].cpu().numpy()
    graphs["benchmark"] = (index.graph, passages)
    log(f"phase 10: the benchmark's graph (seed {bench_seed}) built in {time.perf_counter() - t0:.1f} s")
    out = {}
    for tag, (graph, pnodes) in graphs.items():
        plan = ell_ops.ell_plan(graph)
        cpu_graph = graph.to("cpu")
        rec = {"plan": k2_plan_stats(graph, plan), "step": {}}
        reset = k2_resets(rng, graph, 128, pnodes)
        for gather in (None, torch.bfloat16):
            for b in K2_WIDTHS:
                err, used = k2_check_step(tag, graph, plan, reset, b, gather)
                rec["step"][f"b{b}_{'bfloat16' if gather is not None else 'float32'}"] = {
                    "max_abs_vs_torch": err, "share_of_bound": used}
        rec["solves"] = {}
        for b in K2_WIDTHS + (200,):
            res = k2_resets(rng, graph, b, pnodes)
            for gather in (None, "bfloat16"):
                rec["solves"][f"b{b}"] = {**rec["solves"].get(f"b{b}", {}),
                                          **k2_solves(tag, graph, cpu_graph, res, gather)}
        rec["timing_b128"] = k2_timing(graph, plan, reset)
        out[tag] = rec
        log(f"phase 10 ({tag}): " + json.dumps(rec))
    dep.close()
    return out


# ----------------------------------------------------------------------
# Phase 11: NV-Embed-v2's decoder-layer kernels (csrc/nvembed_layer.cu)
# ----------------------------------------------------------------------
def nv_rope_tables(l, hd, device):
    """(cos, signed sin) [l, 1, hd], as ``NVEmbedV2Encoder.rope_tables`` makes them."""
    inv_freq = 1.0 / 10000.0 ** (torch.arange(0, hd, 2, device=device).float() / hd)
    angles = torch.arange(l, device=device).float()[:, None] * inv_freq
    return (torch.cat((angles.cos(), angles.cos()), -1)[:, None],
            torch.cat((-angles.sin(), angles.sin()), -1)[:, None])


def nv_op_cases(b, l, widths, device, dtype, gen=None):
    """case -> (op, draw, bytes): ``draw()`` gives fresh random inputs of one
    of the five layer ops at B = ``b``, L = ``l`` and ``widths``
    (``NV_WIDTHS``' keys), writing operands in ``dtype``; add_rms_norm with
    the residual's add and without it (the first layer). ``bytes`` reads
    each input once and writes each output once."""
    d, f, heads, kv, hd = (widths[k] for k in ("d", "f", "heads", "kv_heads", "head_dim"))
    m, rep, ob = b * l, heads // kv, torch.empty((), dtype=dtype).element_size()
    width = (heads + 2 * kv) * hd

    def randn(*size, scale=1.0):
        return scale * torch.randn(*size, generator=gen, device=device)

    scale = 1 + 0.1 * randn(d)
    cos, sin = nv_rope_tables(l, hd, device)
    lengths = torch.tensor([max(1, l - (i % 5)) for i in range(b)], device=device)
    return {
        "add_rms_norm": ("add_rms_norm", lambda: (randn(m, d), randn(m, d), scale, 1e-5, dtype),
                         m * d * (12 + ob) + 4 * d),
        "add_rms_norm.first_layer": ("add_rms_norm", lambda: (randn(m, d), None, scale, 1e-5, dtype),
                                     m * d * (4 + ob) + 4 * d),
        "rope_qkv": ("rope_qkv", lambda: (randn(b, l, width), cos, sin, heads, kv, dtype),
                     m * width * (4 + ob) + 8 * l * hd),
        "masked_softmax": ("masked_softmax", lambda: (randn(b * kv, rep * l, l, scale=8.0), lengths, hd ** -0.5,
                                                      dtype),
                           b * kv * rep * l * l * (4 + ob) + 8 * b),
        "ungroup_operand": ("ungroup_operand", lambda: (randn(b * kv, rep * l, hd), b, heads, dtype),
                            m * heads * hd * (4 + ob)),
        "swiglu": ("swiglu", lambda: (randn(m, 2 * f, scale=2.0), dtype), m * f * (8 + ob)),
    }


def bf16_steps_apart(got, want):
    """Elementwise: the bfloat16 steps (of the larger magnitude's binade)
    between two bfloat16 tensors."""
    g, w = got.float(), want.float()
    _m, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    return (g - w).abs() / torch.ldexp(torch.ones_like(g), e - 8)


def _fresh(args):
    return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]


def nv_held_to_plain(case, op, args):
    """Run ``op``'s kernel and its plain version on copies of ``args`` and
    hold every output (add_rms_norm's residual, updated in place, too) to
    the plain one: bfloat16 at most one step apart, on at most
    ``NV_DIFFER_SHARE`` of the elements (add_rms_norm: only at rounding ties
    of the exact value), float32 within ``NV_F32_RTOL``. Returns what
    differs."""
    from hipporag_tpu_torch.embedding import nvembed_encoder as nv

    kernel_args, plain_args = _fresh(args), _fresh(args)
    got, want = getattr(nv, op)(*kernel_args), getattr(nv, op + "_plain")(*plain_args)
    pairs = [(g, w, None) for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,))))]
    if op == "add_rms_norm":
        x, scale, eps = plain_args[0].double(), args[2].double(), args[3]
        pairs = [(got, want, x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale),
                 (kernel_args[0], plain_args[0], None)]
    rec = {"bf16_differ": 0, "bf16_elements": 0, "max_bf16_steps": 0.0, "untied": 0, "f32_max_rel": 0.0}
    for g, w, exact in pairs:
        check(g.dtype == w.dtype and g.shape == w.shape and g.device == w.device,
              f"{case}: kernel gave {g.dtype} {tuple(g.shape)}, plain {w.dtype} {tuple(w.shape)}")
        if g.dtype == torch.bfloat16:
            differ = g != w
            rec["max_bf16_steps"] = max(rec["max_bf16_steps"], bf16_steps_apart(g, w).max().item())
            rec["bf16_differ"] += int(differ.sum())
            rec["bf16_elements"] += g.numel()
            if exact is not None:
                mid, e = (g[differ].double() + w[differ].double()) / 2, exact[differ]
                rec["untied"] += int(((e - mid).abs() > NV_TIE_RTOL * e.abs()).sum())
        else:
            over = int(((g - w).abs() > NV_F32_RTOL * w.abs()).sum())
            rel = ((g - w).abs() / w.abs()).nan_to_num(nan=0.0).max().item()
            check(over == 0, f"{case}: {over} float32 elements beyond {NV_F32_RTOL} relative (max {rel})")
            rec["f32_max_rel"] = max(rec["f32_max_rel"], rel)
    share_ok = op == "add_rms_norm" or rec["bf16_differ"] <= NV_DIFFER_SHARE * max(1, rec["bf16_elements"])
    check(rec["max_bf16_steps"] <= 1.0 and rec["untied"] == 0 and share_ok,
          f"{case}: {rec['bf16_differ']} of {rec['bf16_elements']} bf16 elements differ, by up to "
          f"{rec['max_bf16_steps']} steps, {rec['untied']} of them off a rounding tie")
    return rec


def nv_graph_us(fn, arg_sets, calls=NV_TIMED_CALLS):
    """Device microseconds per call of ``fn(*args)``: ``calls`` calls cycling
    through ``arg_sets`` (cold inputs), captured as one CUDA graph as the
    forward runs them (no host launch time), the second replay timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    sync()
    return 1e3 * start.elapsed_time(end) / calls


def nv_kernels_in_replay(graph):
    """(kernels one replay launches, launches of each layer kernel), from a
    ``torch.profiler`` trace of the replay. A first replay, traced and
    dropped, starts the tracer: a replay traced from a cold start can lose
    its first kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            graph.replay()
            sync()
            prof.step()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    return len(names), {op: sum(kernel in n for n in names) for op, kernel in NV_KERNELS.items()}


def nv_forward_inputs(b, l, device):
    g = torch.Generator(device).manual_seed(b * 1000 + l)
    lengths = torch.tensor([l - (i % 5) for i in range(b)], device=device)
    ids = torch.randint(3, 32000, (b, l), generator=g, device=device) * (
        torch.arange(l, device=device) < lengths[:, None])
    return ids, lengths, torch.full((b,), 12, device=device).minimum(lengths)


def nv_forward(enc, b, l, replays=20):
    """One forward of [b, l] through the kernels: its launches eager (reset
    just before), captured (``fused_launches``) and replayed (device trace);
    against the same forward captured through the plain versions: unit rows
    within ``NV_FORWARD_L2``, CUDA-event ms per replay in turns."""
    from unittest import mock

    from hipporag_tpu_torch.embedding import nvembed_encoder as nv

    layers = len(enc.layers)
    want = {op: (2 if op == "add_rms_norm" else 1) * layers for op in NV_OPS}
    inputs = nv_forward_inputs(b, l, enc.device)
    with torch.inference_mode():
        sync()
        for counter in nv.LAUNCHES.values():
            counter.reset()
        nv._forward(enc, *inputs)
        sync()
        eager = {op: nv.LAUNCHES[op].count for op in NV_OPS}
        check(eager == want, f"{b}x{l}: an eager forward launched {eager}; want {want}")
        rows = enc.encode_forward(*inputs)
        check(enc.fused_launches((b, l)) == 6 * layers,
              f"{b}x{l}: the captured forward holds {enc.fused_launches((b, l))} layer kernels; want {6 * layers}")
        kernel_graph = enc._graphs[(b, l)][0]
        with mock.patch.multiple(nv, **{op: getattr(nv, op + "_plain") for op in NV_OPS}):
            plain = enc._capture(*inputs)  # (graph, its static inputs, its output, 0): kept whole while it replays
        plain_graph = plain[0]
        plain_graph.replay()
        plain_rows = plain[2].clone()
    total, replayed = nv_kernels_in_replay(kernel_graph)
    check(replayed == want, f"{b}x{l}: a replay launched {replayed} layer kernels; want {want}")
    plain_total, _ = nv_kernels_in_replay(plain_graph)
    err = torch.linalg.vector_norm(rows - plain_rows, dim=-1).max().item()
    check(err <= NV_FORWARD_L2, f"{b}x{l}: unit rows {err} in L2 from the plain forward's; limit {NV_FORWARD_L2}")
    times = {"kernels": [], "plain": []}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(replays):
        for name in (("kernels", "plain") if i % 2 == 0 else ("plain", "kernels")):
            graph = kernel_graph if name == "kernels" else plain_graph
            graph.replay()
            sync()
            start.record()
            graph.replay()
            end.record()
            sync()
            times[name].append(start.elapsed_time(end))
    del plain, plain_graph
    return {"forward_ms": float(np.median(times["kernels"])), "plain_forward_ms": float(np.median(times["plain"])),
            "kernels_per_forward": total, "plain_kernels_per_forward": plain_total, "rows_l2_vs_plain": err,
            "launches_eager": eager, "launches_replayed": replayed, "launches_captured": enc.fused_launches((b, l))}


def phase11_nvembed(device):
    """NV-Embed-v2's layer kernels on the card: each held to its plain
    version at the cell's forwards and published widths and at a ragged
    shape, in bfloat16 and float32; each timed against its plain version
    and its least time by bytes; the published model's forward through the
    kernels against the forward through the plain versions; and the
    ``retrieve/embed`` span's ``fused_kernels`` against its ``forwards``.
    Returns (record, the five kernels' entries of the ``kernels`` line)."""
    from hipporag_tpu_torch.embedding import nvembed_encoder as nv

    start = time.perf_counter()
    _kernels.load("nvembed_layer")
    build_s, build_log = _kernels.build_info.get("nvembed_layer", (0.0, ""))
    log(f"phase 11: kernel build: nvembed_layer.cu {build_s:.1f} s (load {time.perf_counter() - start:.1f} s)")
    for line in build_log.strip().splitlines():
        log(f"  nvcc: {line}")
    gen = torch.Generator(device).manual_seed(11)
    rec = {"build_s": build_s, "checks": {}, "ops": {}, "forwards": {}}
    b, l, ragged = NV_RAGGED
    for shape, widths in [(s, NV_WIDTHS) for s in NV_SHAPES] + [((b, l), ragged)]:
        for dtype in (torch.bfloat16, torch.float32):
            for case, (op, draw, _bytes) in nv_op_cases(*shape, widths, device, dtype, gen).items():
                tag = f"{case}.{shape[0]}x{shape[1]}.{str(dtype)[6:]}{'.ragged' if widths is ragged else ''}"
                rec["checks"][tag] = nv_held_to_plain(tag, op, draw())
    log("phase 11: kernels against plain versions: " + json.dumps(rec["checks"]))
    for b, l in NV_SHAPES:
        for case, (op, draw, nbytes) in nv_op_cases(b, l, NV_WIDTHS, device, torch.bfloat16, gen).items():
            arg_sets = [draw() for _ in range(max(2, -(-NV_COLD_BYTES // nbytes)))]
            least = 1e6 * nbytes / HBM_BYTES_PER_S
            kernel_us = nv_graph_us(getattr(nv, op), arg_sets)
            rec["ops"][f"{case}.{b}x{l}"] = {
                "us": kernel_us, "plain_us": nv_graph_us(getattr(nv, op + "_plain"), arg_sets), "bound_us": least,
                "bytes": nbytes, "roofline_pct": 100.0 * least / kernel_us}
            del arg_sets
            torch.cuda.empty_cache()
    log("phase 11: kernel and plain times: " + json.dumps(rec["ops"]))
    t0 = time.perf_counter()
    cfg = BaseConfig(embedding_model_name=nv.ROUTE, embedding_model_dtype="bfloat16", embedding_batch_size=16)
    model = nv.NVEmbedV2DeviceEmbeddingModel(cfg, device)
    log(f"phase 11: the published model drawn in {time.perf_counter() - t0:.1f} s")
    for b, l in NV_SHAPES:
        rec["forwards"][f"{b}x{l}"] = nv_forward(model.encoder, b, l)
        log(f"phase 11 forward {b}x{l}: " + json.dumps(rec["forwards"][f"{b}x{l}"]))
    texts = [" ".join(f"w{i}x{j}" for j in range(12 + i % 5)) for i in range(40)]
    with recording() as rec_spans:
        with span("retrieve/embed"):
            model.batch_encode(texts, instruction="Given a question, retrieve passages", norm=True)
    (embed,) = [s for s in rec_spans.spans() if s.name == "retrieve/embed"]
    layers = len(model.encoder.layers)
    check(embed.attrs["fused_kernels"] == 6 * layers * embed.attrs["forwards"],
          f"retrieve/embed: fused_kernels {embed.attrs['fused_kernels']} over {embed.attrs['forwards']} forwards")
    rec["retrieve_embed"] = {k: embed.attrs[k] for k in ("forwards", "fused_kernels")}
    del model
    torch.cuda.empty_cache()
    entries = []
    for op in NV_OPS:
        entry = {"name": op, "route": "cuda", "source": "hipporag_tpu_torch/csrc/nvembed_layer.cu",
                 "replaces": "none: the JAX package has no NV-Embed-v2",
                 "launches_by_path": {
                     **{f"forward_{s}_{how}": f[f"launches_{how}"][op]
                        for s, f in rec["forwards"].items() for how in ("eager", "replayed")},
                     "retrieve_embed_all_kernels": rec["retrieve_embed"]}}
        for b, l in NV_SHAPES:
            t = rec["ops"][f"{op}.{b}x{l}"]
            suffix = "" if (b, l) == NV_SHAPES[-1] else f"_{b}x{l}"
            entry.update({f"ms{suffix}": t["us"] / 1e3, f"plain_ms{suffix}": t["plain_us"] / 1e3,
                          f"bound_ms{suffix}": t["bound_us"] / 1e3, f"bound_by{suffix}": "bytes"})
        if op == "add_rms_norm":
            t = rec["ops"][f"add_rms_norm.first_layer.{NV_SHAPES[-1][0]}x{NV_SHAPES[-1][1]}"]
            entry.update({"ms_first_layer": t["us"] / 1e3, "plain_ms_first_layer": t["plain_us"] / 1e3,
                          "bound_ms_first_layer": t["bound_us"] / 1e3})
        entry["max_bf16_steps"] = max(c["max_bf16_steps"] for t, c in rec["checks"].items() if t.startswith(op + "."))
        entry["f32_max_rel"] = max(c["f32_max_rel"] for t, c in rec["checks"].items() if t.startswith(op + "."))
        entries.append(entry)
    return rec, entries


# ----------------------------------------------------------------------
# Phase 12: GritLM-8x7B's mixture-of-experts kernels (ops/moe.py)
# ----------------------------------------------------------------------
def moe_inputs(b, l, device, gen, empty=None):
    """(normed operand y [b * l, D] bf16, lengths [b], router logits [b * l,
    E] float32) of a forward of ``b`` texts padded to ``l``; with ``empty``,
    that expert's logits are pushed far down, so that no token chooses it."""
    d, n_exp = MOE_WIDTHS["d"], MOE_WIDTHS["experts"]
    lengths = torch.tensor([max(1, l - (i % 5)) for i in range(b)], device=device)
    y = torch.randn(b * l, d, generator=gen, device=device).to(torch.bfloat16)
    router = (0.02 * torch.randn(d, n_exp, generator=gen, device=device)).to(torch.bfloat16)
    logits = torch.mm(y, router, out_dtype=torch.float32)
    if empty is not None:
        logits[:, empty] = -1e4
    return y, lengths, logits


def moe_block(ops, y, lengths, logits, gate, up, down, stats=None):
    """The MoE block through ``ops`` (``moe`` or its plain versions):
    (routing, gate_up rows, down rows, output)."""
    from hipporag_tpu_torch.embedding import nvembed_encoder as nv

    r = ops["moe_route"](logits, lengths, MOE_WIDTHS["top_k"], stats)
    gate_up = ops["moe_gate_up"](y, gate, up, r)
    rows = ops["moe_down"](nv.swiglu(gate_up, y.dtype), down, r)
    return r, gate_up, rows, ops["moe_combine"](rows, r)


def moe_held(tag, got, want, got_stats, want_stats):
    """Hold the kernels' block (``got``) to the plain versions' (``want``)
    on the same inputs: the same choices, rows, offsets and counters, the
    gates within ``MOE_GATE_ATOL``, each product's routed rows and the
    output within ``MOE_PRODUCT_RTOL`` of their largest magnitude."""
    (gr, g_gu, g_rows, g_out), (wr, w_gu, w_rows, w_out) = got, want
    routed = int(wr.offsets[-1])
    same = {"experts": torch.equal(gr.experts, wr.experts), "slots": torch.equal(gr.slots, wr.slots),
            "offsets": torch.equal(gr.offsets, wr.offsets),
            "tokens": torch.equal(gr.tokens[:routed], wr.tokens[:routed]),
            "stats": torch.equal(got_stats, want_stats)}
    check(all(same.values()), f"{tag}: the routing differs from the plain version's: {same}")
    rec = {"routed": routed, "empty_experts": int((wr.offsets[1:] == wr.offsets[:-1]).sum()),
           "gate_max_abs": float((gr.gates - wr.gates).abs().max())}
    check(rec["gate_max_abs"] <= MOE_GATE_ATOL, f"{tag}: gates {rec['gate_max_abs']} from the plain version's")
    for name, g, w in (("gate_up", g_gu[:routed], w_gu[:routed]), ("down", g_rows[:routed], w_rows[:routed]),
                       ("combine", g_out, w_out)):
        rec[f"{name}_max_rel"] = float((g - w).abs().max()) / float(w.abs().max())
    check(all(rec[f"{name}_max_rel"] <= MOE_PRODUCT_RTOL for name in ("gate_up", "down", "combine")),
          f"{tag}: the products differ from the plain versions' beyond {MOE_PRODUCT_RTOL}: {rec}")
    return rec


def moe_kernels_in_replay(graph, lead=4):
    """(kernels one replay launches, launches of each MoE and layer kernel),
    from a ``torch.profiler`` trace of the replay. Two replays, traced and
    dropped, start the tracer, and ``lead`` small kernels open each traced
    step: a tracer started cold can lose a step's first kernels (it lost a
    replay's first two once, with one replay to warm it)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    filler = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=2, active=1, repeat=1)) as prof:
        for _ in range(3):
            for _ in range(lead):
                filler.add_(1)
            graph.replay()
            sync()
            prof.step()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    counts = {op: sum(n.startswith(op + "_kernel") for n in names) for op in MOE_OPS}
    counts.update({op: sum(kernel in n for n in names) for op, kernel in NV_KERNELS.items()})
    return len(names) - lead, counts


def moe_work(op, b, l, routed, tokens):
    """(flops, bytes) an op needs at B = ``b``, L = ``l`` with ``routed``
    pairs of ``tokens`` real tokens: each input byte read once, each output
    byte written once; the products read every expert's weights once."""
    d, f, n_exp, k = MOE_WIDTHS["d"], MOE_WIDTHS["f"], MOE_WIDTHS["experts"], MOE_WIDTHS["top_k"]
    t = b * l
    return {"moe_route": (0.0, 4 * t * n_exp + 8 * b + 4 * (3 * t * k + routed + n_exp + 1)),
            "moe_gate_up": (4.0 * routed * d * f, 2 * n_exp * d * 2 * f + 2 * tokens * d + 4 * routed * 2 * f),
            "moe_down": (2.0 * routed * f * d, 2 * n_exp * f * d + 2 * routed * f + 4 * routed * d),
            "moe_combine": (2.0 * routed * d, 4 * routed * d + 4 * t * d + 8 * t * k)}[op]


def moe_timed(ops, plain_ops, args, b, l, r):
    """Each op's device microseconds inside a CUDA graph (``nv_graph_us``),
    its plain version's eager (CUDA events; the plain products read the
    offsets on the host), and its least time."""
    from hipporag_tpu_torch.embedding import nvembed_encoder as nv

    y, lengths, logits, gate, up, down = args
    routed = int(r.offsets[-1])
    h = nv.swiglu(ops["moe_gate_up"](y, gate, up, r), y.dtype)
    rows = ops["moe_down"](h, down, r)
    calls = {"moe_route": lambda o: o(logits, lengths, MOE_WIDTHS["top_k"]),
             "moe_gate_up": lambda o: o(y, gate, up, r), "moe_down": lambda o: o(h, down, r),
             "moe_combine": lambda o: o(rows, r)}
    out = {}
    for op in MOE_OPS:
        flops, nbytes = moe_work(op, b, l, routed, routed // MOE_WIDTHS["top_k"])
        least_us = 1e6 * max(flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
        big = op in ("moe_gate_up", "moe_down")
        if big:  # the weights are 0.9 to 1.9 GB, past the 50 MB L2
            us = nv_graph_us(lambda fn=ops[op], call=calls[op]: call(fn), [()], calls=20)
        elif op == "moe_route":
            sets = [(logits.clone(),) for _ in range(8)]
            us = nv_graph_us(lambda x: ops[op](x, lengths, MOE_WIDTHS["top_k"]), sets)
        else:  # inputs cycled over twice the L2
            sets = [(rows.clone(),) for _ in range(max(2, -(-NV_COLD_BYTES // rows.numel() // 4)))]
            us = nv_graph_us(lambda x: ops[op](x, r), sets)
        out[op] = {"us": us, "plain_eager_us": 1e3 * time_ms(lambda: calls[op](plain_ops[op]), reps=5 if big else 20),
                   "bound_us": least_us, "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_PEAK_FLOPS
                   else "flops", "roofline_pct": 100.0 * least_us / us}
    return out


def moe_forward(model, b, l, replays=10):
    """One forward of [b, l] of the cell's layers through the kernels: its
    MoE and layer kernels' launches eager (reset just before), captured and
    in a traced replay; the replay's unit rows against the eager forward's
    (``MOE_REPLAY_L2``) and against the same forward through the plain
    versions held to the kernels' expert choices (``MOE_FORWARD_L2``); the
    plain forward left to route itself: its rows' distance and the share of
    expert choices that differ, layer by layer; the replay's and the plain
    forward's CUDA-event ms."""
    from unittest import mock

    from hipporag_tpu_torch.embedding import nvembed_encoder as nv
    from hipporag_tpu_torch.ops import moe

    enc = model.encoder
    layers = len(enc.layers)
    inputs = nv_forward_inputs(b, l, enc.device)
    want = {**{op: layers for op in MOE_OPS}, **{op: (2 if op == "add_rms_norm" else 1) * layers for op in NV_OPS}}
    route = moe.moe_route
    chosen, forced = [], []

    def recorded(logits, lengths, top_k, stats=None):
        chosen.append(route(logits, lengths, top_k, stats))
        return chosen[-1]

    def held(logits, lengths, top_k, stats=None):
        forced.append(moe.moe_route_plain(logits, lengths, top_k))
        return chosen[len(forced) - 1]

    plain_ops = {**{op: getattr(nv, op + "_plain") for op in NV_OPS}}
    with torch.inference_mode():
        sync()
        for counter in (*moe.LAUNCHES.values(), *nv.LAUNCHES.values()):
            counter.reset()
        with mock.patch.object(moe, "moe_route", recorded):
            eager_rows = enc.run(*inputs)
        sync()
        eager = {**{op: moe.LAUNCHES[op].count for op in MOE_OPS}, **{op: nv.LAUNCHES[op].count for op in NV_OPS}}
        check(eager == want, f"{b}x{l}: an eager forward launched {eager}; want {want}")
        rows = enc.encode_forward(*inputs)
        captured = enc.launches((b, l))
        check(captured == {"fused_kernels": 6 * layers, "moe_kernels": 4 * layers},
              f"{b}x{l}: the captured forward holds {captured}")
        graph = enc._graphs[(b, l)][0]
        with mock.patch.multiple(nv, **plain_ops), mock.patch.multiple(
                moe, **{op: getattr(moe, op + "_plain") for op in MOE_OPS}):
            plain_rows = enc.run(*inputs)
            plain_ms = time_ms(lambda: enc.run(*inputs), reps=3)
            with mock.patch.object(moe, "moe_route", held):
                forced_rows = enc.run(*inputs)
    total, replayed = moe_kernels_in_replay(graph)
    check(replayed == want, f"{b}x{l}: a replay launched {replayed}; want {want}")
    real = (torch.arange(l, device=enc.device)[None, :] < inputs[1][:, None]).reshape(-1)
    flips = [1.0 - float((k.experts[real].long()[:, :, None] == p.experts[real].long()[:, None, :]).any(-1)
                         .float().mean()) for k, p in zip(chosen, forced)]
    out = {"rows_l2_replay_vs_eager": torch.linalg.vector_norm(rows - eager_rows, dim=-1).max().item(),
           "rows_l2_vs_plain_held_to_kernel_choices": torch.linalg.vector_norm(rows - forced_rows, dim=-1).max().item(),
           "rows_l2_vs_plain_routing_itself": torch.linalg.vector_norm(rows - plain_rows, dim=-1).max().item(),
           "choices_differing_from_plain_by_layer": flips}
    check(out["rows_l2_replay_vs_eager"] <= MOE_REPLAY_L2 and out["rows_l2_vs_plain_held_to_kernel_choices"]
          <= MOE_FORWARD_L2, f"{b}x{l}: unit rows apart: {out}")
    times = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return {"forward_ms": float(np.median(times)), "plain_eager_forward_ms": plain_ms, "kernels_per_forward": total,
            **out, "launches_eager": eager, "launches_replayed": replayed, "launches_captured": captured}


def moe_against_reference(model, weights, config, texts, instruction):
    """The port's forward of ``texts`` (replayed, bf16 kernels) against the
    plain float32 reference on the same weights: the rows' L2 distance and,
    layer by layer, the share of real tokens' expert choices that differ
    (an eager forward through the kernels records the port's)."""
    from unittest import mock

    from hipporag_tpu_torch.ops import moe
    from perfbench.reference.encoders import gritlm as plain

    port_choices, ref_choices = [], []
    route = moe.moe_route

    def recorded_route(logits, lengths, top_k, stats=None):
        r = route(logits, lengths, top_k, stats)
        port_choices.append(r.experts.clone())
        return r

    ref_moe = plain._moe

    def recorded_moe(hs, p, cfg, mm):
        probs = plain._softmax(mm(hs.reshape(-1, hs.shape[-1]), p["router_w"]))
        order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
        ref_choices.append(order[:, :cfg["num_experts_per_tok"]])
        return ref_moe(hs, p, cfg, mm)

    formatted = [model.format_with_instruction(t, instruction) for t in texts]
    ids, lengths = model.tokenizer(formatted, model.global_config.embedding_max_seq_len)
    dev = model.encoder.device
    pool_from = np.minimum(model._masked_positions(instruction), lengths)
    args = [torch.from_numpy(a).to(dev) for a in (ids, lengths, pool_from)]
    rows = model.encoder.encode_forward(*args)
    with torch.inference_mode(), mock.patch.object(moe, "moe_route", recorded_route):
        model.encoder.run(*args)
    with mock.patch.object(plain, "_moe", recorded_moe):
        ref_rows = plain.encode(config, weights, [plain.format_query(config, instruction, t) for t in texts], dev)
    real = (torch.arange(ids.shape[1], device=dev)[None, :] < args[1][:, None]).reshape(-1)
    shares = []
    for got, want in zip(port_choices, ref_choices):
        g, w = got[real].long(), want[real]
        kept = (g[:, :, None] == w[:, None, :]).any(-1).sum().item()
        shares.append(1.0 - kept / g.numel())
    return {"rows_l2_vs_reference": torch.linalg.vector_norm(rows - ref_rows, dim=-1).max().item(),
            "flip_share_by_layer": shares, "flip_share": float(np.mean(shares)),
            "real_tokens": int(real.sum()), "texts": len(texts)}


def phase12_moe(device):
    """GritLM-8x7B's mixture-of-experts kernels on the card: each held to
    its plain version at the cell's forwards and published widths and at a
    ragged shape that leaves one expert with no rows, eager and inside a
    traced CUDA-graph replay; each timed against its plain version and its
    least time; the cell's 16 published layers' forward through the kernels
    against the forward through the plain versions and against the float32
    reference (rows and the share of expert choices that differ); and the
    ``retrieve/embed`` span's counters. Returns (record, the four kernels'
    entries of the ``kernels`` line)."""
    from hipporag_tpu_torch.embedding import gritlm_encoder as grit
    from hipporag_tpu_torch.ops import moe
    from perfbench.encoders import gritlm as grit_bench
    from perfbench.reference.encoders import gritlm as plain

    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(12)
    d, f, n_exp = MOE_WIDTHS["d"], MOE_WIDTHS["f"], MOE_WIDTHS["experts"]
    gate, up = ((0.02 * torch.randn(n_exp, d, f, generator=gen, device=device)).to(torch.bfloat16) for _ in range(2))
    down = (0.02 * torch.randn(n_exp, f, d, generator=gen, device=device)).to(torch.bfloat16)
    kernels = {op: getattr(moe, op) for op in MOE_OPS}
    plain_ops = {op: getattr(moe, op + "_plain") for op in MOE_OPS}
    rec = {"checks": {}, "ops": {}, "forwards": {}}
    for (b, l), empty in [(s, None) for s in MOE_SHAPES] + [(MOE_RAGGED, MOE_EMPTY_EXPERT)]:
        tag = f"{b}x{l}" + ("" if empty is None else f".expert{empty}_empty")
        y, lengths, logits = moe_inputs(b, l, device, gen, empty)
        stats = {k: torch.zeros(2, dtype=torch.int64, device=device) for k in ("kernel", "plain", "graph")}
        want = moe_block(plain_ops, y, lengths, logits, gate, up, down, stats["plain"])
        got = moe_block(kernels, y, lengths, logits, gate, up, down, stats["kernel"])
        sync()
        rec["checks"][tag + ".eager"] = moe_held(tag + " eager", got, want, stats["kernel"], stats["plain"])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_block(kernels, y, lengths, logits, gate, up, down)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = moe_block(kernels, y, lengths, logits, gate, up, down, stats["graph"])
        _total, launched = moe_kernels_in_replay(graph)  # three replays, each adding to the graph's counter
        check(all(launched[op] == 1 for op in MOE_OPS), f"{tag}: a replay launched {launched}")
        rec["checks"][tag + ".replay"] = moe_held(tag + " replay", replayed, want, stats["graph"] // 3,
                                                  stats["plain"])
        if empty is not None:
            check(rec["checks"][tag + ".eager"]["empty_experts"] >= 1, f"{tag}: no expert was left empty")
        else:
            rec["ops"][f"{b}x{l}"] = moe_timed(kernels, plain_ops, (y, lengths, logits, gate, up, down), b, l, want[0])
        del graph, replayed, got, want
        torch.cuda.empty_cache()
    log("phase 12: kernels against plain versions: " + json.dumps(rec["checks"]))
    log("phase 12: kernel and plain times: " + json.dumps(rec["ops"]))
    del gate, up, down
    torch.cuda.empty_cache()

    config = grit_bench.cell_config()
    t1 = time.perf_counter()
    weights = plain.weights(config, MOE_SEED, device)
    cfg = BaseConfig(embedding_model_name=grit_bench.embedding_name(config), embedding_model_dtype="bfloat16",
                     embedding_batch_size=16, embedding_max_seq_len=config["max_position_embeddings"])
    model = grit.GritLMDeviceEmbeddingModel(cfg, device, params=weights)
    log(f"phase 12: the cell's {len(model.encoder.layers)} layers drawn in {time.perf_counter() - t1:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    for b, l in MOE_SHAPES:
        rec["forwards"][f"{b}x{l}"] = moe_forward(model, b, l)
        log(f"phase 12 forward {b}x{l}: " + json.dumps(rec["forwards"][f"{b}x{l}"]))
    rng = np.random.default_rng(12)
    texts = [" ".join(f"w{rng.integers(1 << 20)}" for _ in range(4 + i % 7)) for i in range(16)]
    instruction = "Given a question, retrieve triplet facts that match it."
    rec["reference"] = moe_against_reference(model, weights, config, texts, instruction)
    log("phase 12 against the float32 reference: " + json.dumps(rec["reference"]))
    with recording() as rec_spans:
        with span("retrieve/embed"):
            model.batch_encode(texts + texts[:7], instruction=instruction, norm=True)
    (embed,) = [s for s in rec_spans.spans() if s.name == "retrieve/embed"]
    layers = len(model.encoder.layers)
    a = embed.attrs
    check(a["moe_kernels"] == 4 * layers * a["forwards"] and a["fused_kernels"] == 6 * layers * a["forwards"]
          and a["routed"] == 2 * layers * a["tokens"] and layers * a["tokens"] // 4 <= a["expert_rows_max"]
          <= a["routed"], f"retrieve/embed: {a}")
    rec["retrieve_embed"] = dict(a)
    rec["wall_s"] = time.perf_counter() - t0
    del model, weights
    torch.cuda.empty_cache()
    entries = []
    for op in MOE_OPS:
        entry = {"name": op, "route": "cuda (triton)", "source": "hipporag_tpu_torch/ops/moe.py",
                 "replaces": "none: the JAX package has no mixture of experts",
                 "launches_by_path": {
                     **{f"forward_{s}_{how}": fw[f"launches_{how}"][op]
                        for s, fw in rec["forwards"].items() for how in ("eager", "replayed")},
                     "retrieve_embed_all_moe_kernels": {k: rec["retrieve_embed"][k] for k in ("forwards",
                                                                                               "moe_kernels")}}}
        for b, l in MOE_SHAPES:
            t = rec["ops"][f"{b}x{l}"][op]
            suffix = "" if (b, l) == MOE_SHAPES[-1] else f"_{b}x{l}"
            entry.update({f"ms{suffix}": t["us"] / 1e3, f"plain_eager_ms{suffix}": t["plain_eager_us"] / 1e3,
                          f"bound_ms{suffix}": t["bound_us"] / 1e3, f"bound_by{suffix}": t["bound_by"]})
        entries.append(entry)
    return rec, entries


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

    start = time.perf_counter()
    from hipporag_tpu_torch.graph import native as graph_native

    check(graph_native.native_available(), f"the native graph core did not build: {graph_native.build_error}")
    log(f"native graph core: {os.path.relpath(graph_native.library_path(), ROOT)} "
        f"({time.perf_counter() - start:.1f} s to build and load)")

    run_start = time.perf_counter()
    phase1_grid(device)
    phase1_near_ties(device)
    big, launches, detail, bucket = phase2(device, FULL)
    p7 = {"graph": phase7_graph(device, bucket)}
    p8, p8_s = {}, {}
    t0 = time.perf_counter()
    p8["scoring"] = phase8_scoring(device, bucket)
    p8["ppr"] = phase8_ppr(device, bucket)
    p8_s["a-c"] = time.perf_counter() - t0
    del bucket
    torch.cuda.empty_cache()
    detail["phase3"] = {dt: phase3(device, dt) for dt in ("float32", "bfloat16")}
    log("phase 3: " + json.dumps(detail["phase3"]))
    phase4(device)
    p5 = phase5(device)
    def served(rag, parity):
        """Phases 7d/e and 8d on phase 6's live index."""
        extra = phase7_served(rag, parity)
        t0 = time.perf_counter()
        p8["served"] = phase8_served(rag, parity)
        p8_s["d"] = time.perf_counter() - t0
        return extra

    p6 = phase6(device, served=served)
    lifecycle = phase6_lifecycle(device)
    native, std = p6["native"], p6["stdlib"]
    log(f"phase 6 summary on {smi}: " + json.dumps({
        "passages": p6["passages"], "index_wall_s": p6["index"]["index_wall_s"],
        "native_retrieve_per_s": native["retrieve_per_s"], "native_latency_ms": native["retrieve_latency_ms"],
        "native_retrieve_only_per_s": p6["native_retrieve_only"]["retrieve_per_s"],
        "native_retrieve_only_latency_ms": p6["native_retrieve_only"]["retrieve_latency_ms"],
        "engine_s": native["engine_s"],
        "stdlib_retrieve_per_s": std["retrieve_per_s"], "stdlib_latency_ms": std["retrieve_latency_ms"],
        "mean_batch_size": native["mean_batch_size"], "dedup_saved": native["dedup_saved"],
        "cache_hits": native["cache_hits"],
        "shed": native["shed"] + std["shed"] + p6["native_retrieve_only"]["shed"],
        "index_ms": p6["index_ms"], "delete_ms": p6["delete_ms"], "parity_trades": p6["parity_trades"],
        "kernel_launches": p6["kernel_launches"], "peak_memory_bytes": p6["peak_memory_bytes"],
        "lifecycle_max_score_diff": lifecycle,
    }))
    p7["served"] = p6["served_extra"]
    p7["sample"] = phase7_sample(device)
    p7["adapter"] = phase7_adapter(device)
    p7["multihop"] = phase7_multihop(device)
    graph, served = p7["graph"], p7["served"]
    log(f"phase 7 summary on {smi}: " + json.dumps({
        "ppr_ms": {k: v["ms"] for k, v in graph.items()},
        "ppr_ms_per_iter": {k: v["ms_per_iter"] for k, v in graph.items()},
        "ppr_iters": {k: v["iters_per_tile"] for k, v in graph.items()},
        "ppr_peak_bytes_above_inputs": {k: v["peak_bytes_above_inputs"] for k, v in graph.items()},
        "ppr_max_abs_vs_scipy": {k: v["max_abs_vs_scipy"] for k, v in graph.items()},
        "served_coo_vs_ell_trades": served["coo_vs_ell_trades"],
        "served_exact": served["exact"], "served_profile": served["profile"],
        "adapter_ms_per_step": p7["adapter"]["ms_per_step"], "multihop": p7["multihop"]["result"],
    }))
    t0 = time.perf_counter()
    p8["adapter"] = phase8_adapter(device, p7["adapter"]["first_losses"])
    p8["encoder"] = phase8_encoder(device)
    p8["dryrun"] = phase8_dryrun(device)
    p8_s["e-g"] = time.perf_counter() - t0
    dry = p8["dryrun"]
    weak = dry["weak_scaling"]
    log(f"phase 8 summary on {smi} ({SHARDS} virtual shards of one card: correctness and per-shard work, "
        "not scaling): " + json.dumps({
            "wall_s": {**p8_s, "total": sum(p8_s.values())},
            "scoring_ms": {k: v["ms"] for k, v in p8["scoring"].items() if isinstance(v, dict)},
            "plain_fact_topk_ms": p8["scoring"]["plain_fact_topk_ms"],
            "ppr_ms_per_iter": {k: v["ms_per_iter"] for k, v in p8["ppr"].items()},
            "ppr_iters": {k: v["iters_per_tile"] for k, v in p8["ppr"].items()},
            "served_trades_vs_single": p8["served"]["trades_vs_single"],
            "served_retrieve_per_s": p8["served"]["served"]["retrieve_per_s"],
            "adapter_ms_per_step": p8["adapter"]["ms_per_step"],
            "dryrun_scale": {k: dry["scale"][k] for k in ("host_build_s", "solve_s", "iters", "ms_per_iter")},
            "dryrun_capacity": dry["capacity"],
            "dryrun_weak_scaling": {k: weak[k] for k in ("shards", "host_build_s", "solve_s", "scale_solve_s",
                                                         "rows_ratio")},
        }))
    t0 = time.perf_counter()
    p9 = phase9_sections(device)
    log(f"phase 9 summary on {smi}: " + json.dumps({
        "wall_s": time.perf_counter() - t0,
        **{name: v.get("skipped", "ran") for name, v in p9.items() if name != "multihop"},
        "multihop": p9["multihop"]["result"]}))
    t0 = time.perf_counter()
    p10 = phase10_k2(device)
    log(f"phase 10 summary on {smi}: " + json.dumps({
        "wall_s": time.perf_counter() - t0,
        **{tag: {"plan": rec["plan"], "timing_b128": rec["timing_b128"]} for tag, rec in p10.items()}}))
    t0 = time.perf_counter()
    p11, nv_kernels = phase11_nvembed(device)
    log(f"phase 11 summary on {smi}: " + json.dumps({
        "wall_s": time.perf_counter() - t0, "build_s": p11["build_s"], "forwards": p11["forwards"],
        "retrieve_embed": p11["retrieve_embed"]}))
    p12, moe_kernels = phase12_moe(device)
    log(f"phase 12 summary on {smi}: " + json.dumps({
        "wall_s": p12["wall_s"], "forwards": p12["forwards"], "reference": p12["reference"],
        "retrieve_embed": p12["retrieve_embed"]}))
    log(f"chip_smoke: phases 1-12 passed in {time.perf_counter() - run_start:.1f} s")

    f32, bf16 = big["f32"], big["bf16"]
    kernels = [{
        "name": "fused_topk_scan",
        "route": "cuda",
        "source": "hipporag_tpu_torch/csrc/fused_topk_scan.cu",
        "replaces": "hipporag_tpu/ops/fused_topk.py:125",
        "launches": launches,
        "launches_by_path": {
            "phase2_bucket": launches,
            **{f"phase3_{dt}": d["kernel_launches"] for dt, d in detail["phase3"].items()},
            "phase5_retrieve": p5["kernel_launches"],
            "phase6_serving": p6["kernel_launches"],
            **{f"phase7c_coo_sample_{dt}": d["kernel_launches"] for dt, d in p7["sample"].items()},
            "phase7d_served_coo": served["coo_k1_launches"],
            "phase7e_profiled_retrieve": served["profiled_k1_launches"],
            "phase7g_multihop": p7["multihop"]["kernel_launches"],
            "phase2_bf16_default_route": big["bf16_route"]["kernel_launches"],
            "phase9_multihop_section": p9["multihop"]["kernel_launches"],
        },
        "max_abs_err": f32["err"],
        "delta_bound": f32["delta"],
        "ms": f32["ms"]["scan_kernel"],
        "plain_ms": f32["ms"]["scan_plain"],
        "bound_ms": f32["bound"]["bound_ms"],
        "bound_by": f32["bound"]["bound_by"],
        "split_products_ms": f32["bound"]["split_products_ms"],
        "library_ms": f32["ms"]["library_matmul"],
        "max_abs_err_bf16": bf16["err"],
        "delta_bound_bf16": bf16["delta"],
        "ms_bf16": bf16["ms"]["scan_kernel"],
        "plain_ms_bf16": bf16["ms"]["scan_plain"],
        "bound_ms_bf16": bf16["bound"]["bound_ms"],
        "bound_by_bf16": bf16["bound"]["bound_by"],
        "fact_topk_bf16_default_route": big["bf16_route"],
    }, {
        "name": "ell_ppr_step",
        "route": "cuda",
        "source": "hipporag_tpu_torch/csrc/ell_ppr_step.cu",
        "replaces": "none: the JAX package's ELL step is XLA (hipporag_tpu/ops/pagerank.py _spmv_ell)",
        "launches_by_path": K2_PATHS,
        **{f"{tag}_b128": rec["timing_b128"] for tag, rec in p10.items()},
    }, *nv_kernels, *moe_kernels]
    stray = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hipporag_tpu"))
    check(not stray, f"the port imported {stray[:5]}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
