"""Dataset-scale replay harness over the 2WikiMultihopQA corpus (port's copy
of ``hipporag_tpu/evaluation/twiki.py``, driving the port's ``HippoRAG``).

The reference ships the real 6k-passage corpus
(``reproduce/dataset/2wikimultihopqa_corpus.json``, loaded by
main.py:76-79) without its query file, and the harness runs with no live
LLM. It therefore measures retrieval quality at corpus scale with fully
deterministic components:

- **Rule-based OpenIE stand-in**: the deterministic MockLLM's capitalized-
  phrase NER + co-sentence relation extraction (llm/mock.py) — driven
  through the UNMODIFIED production pipeline (index/retrieve), exactly as a
  real LLM would be.
- **Deterministic embedder**: the hashing n-gram model (embedding/hashing.py)
  gives real lexical similarity with no model weights.
- **Synthesized 2-hop queries** from real title cross-references: passage A
  mentions passage B's title; the question quotes A's opening (with the
  bridge mention REMOVED) and asks about the linked subject. Dense
  retrieval can find A but by construction shares no tokens with B; graph
  retrieval must hop A -> bridge entity -> B. Gold = {A, B}. Real text,
  real entity aliasing, real distractors — synthetic only in the pairing.
- **NumPy twin**: an independent host-side implementation of the
  reference's retrieval math (fact scoring -> recognition-memory filter ->
  seed construction -> PPR -> ranking; HippoRAG.py:1427-1656) used to
  verify the device pipeline's rankings at scale (rank agreement >= 0.99);
  ``exact_rank_check`` holds them to the native float64 serial solver.
"""

from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Tuple

import numpy as np

from ..utils.logging import get_logger
from ..utils.misc import compute_mdhash_id

logger = get_logger(__name__)

_TOKEN = re.compile(r"[a-z0-9]+")


def load_corpus(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        corpus = json.load(f)
    return corpus


def doc_text(item: Dict[str, str]) -> str:
    return f"{item['title']}\n{item['text']}"


def synthesize_multihop_queries(
    corpus: List[Dict[str, str]],
    max_queries: int = 600,
    min_title_len: int = 10,
) -> List[Tuple[str, List[str], str]]:
    """Deterministic 2-hop (question, gold_docs, bridge_title) triples.

    For passages A != B where A's text mentions B's title verbatim: the
    question is A's opening words with every bridge mention removed, plus a
    fixed connective suffix. One query per bridge title (first mention in
    corpus order), capped at ``max_queries``.
    """
    # first-word index over eligible titles keeps the scan near-linear
    # (a naive title x passage substring scan is ~40M checks on 6k docs)
    by_first_word: Dict[str, List[Tuple[str, int]]] = {}
    for i, item in enumerate(corpus):
        title = item["title"]
        if len(title) < min_title_len or " " not in title:
            continue
        by_first_word.setdefault(title.split()[0], []).append((title, i))

    queries: List[Tuple[str, List[str], str]] = []
    used_bridges = set()
    for a_idx, item in enumerate(corpus):
        text = item["text"]
        for word in dict.fromkeys(text.split()):
            for title, b_idx in by_first_word.get(word.strip(",.;:()'\""), ()):
                if (
                    b_idx == a_idx
                    or title in used_bridges
                    or title not in text
                    or title in item["title"]
                    or item["title"] in title
                ):
                    continue
                lead = text.replace(title, " ").split()
                question = (
                    " ".join(lead[:24])
                    + " — which subject is this connected to, and what is known about it?"
                )
                queries.append(
                    (question, [doc_text(item), doc_text(corpus[b_idx])], title)
                )
                used_bridges.add(title)
                if len(queries) >= max_queries:
                    return queries
    return queries


# ----------------------------------------------------------------------
# NumPy twin of the retrieval math (independent derivation)
# ----------------------------------------------------------------------
def _mock_filter_kept(question: str, cands: List[Tuple[str, str, str]]) -> List[int]:
    """Replicates MockLLM's recognition-memory rule (llm/mock.py): keep the
    candidate facts sharing a token with the question (score order), fall
    back to all when none overlap."""
    q_tokens = set(_TOKEN.findall(question.lower()))
    kept = [
        i
        for i, fact in enumerate(cands)
        if q_tokens & set(_TOKEN.findall(" ".join(map(str, fact)).lower()))
    ]
    return kept if kept else list(range(len(cands)))


def _twin_seeds(rag, queries: List[str]) -> Dict:
    """Host-side operator + seed construction shared by the NumPy twin and
    the exact-solver rank check (independent derivation of ref
    HippoRAG.py:1427-1644 — everything up to the PPR solve)."""
    from ..parallel.seeds import build_reset_vectors
    from ..prompts.linking import get_query_instruction

    cfg = rag.global_config
    graph = rag.graph
    n = graph.num_nodes
    link_top_k = cfg.linking_top_k

    # independent graph operator from the builder's edge dict
    src, dst, w = graph.symmetric_coo()
    strength = np.zeros(n, dtype=np.float64)
    np.add.at(strength, src, w.astype(np.float64))
    w_norm = w.astype(np.float64) / np.maximum(strength[src], 1e-300)
    dangling = (strength == 0).astype(np.float64)

    fact_keys = rag.fact_node_keys
    passage_keys = rag.passage_node_keys
    fact_emb = rag.fact_embedding_store.get_embeddings_matrix(fact_keys)
    passage_emb = rag.chunk_embedding_store.get_embeddings_matrix(passage_keys)

    fact_subj = np.zeros(len(fact_keys), dtype=np.int64)
    fact_obj = np.zeros(len(fact_keys), dtype=np.int64)
    for i, triple in enumerate(rag._fact_tuples):
        fact_subj[i] = graph.node_to_idx[compute_mdhash_id(triple[0], prefix="entity-")]
        fact_obj[i] = graph.node_to_idx[compute_mdhash_id(triple[2], prefix="entity-")]
    passage_node_ids = np.asarray(
        [graph.node_to_idx[k] for k in passage_keys], dtype=np.int64
    )
    chunk_counts = np.zeros(n, dtype=np.float64)
    for ent, chunks in graph.ent_node_to_chunk_ids.items():
        idx = graph.node_to_idx.get(ent)
        if idx is not None:
            chunk_counts[idx] = len(chunks)

    qf = rag.embedding_model.batch_encode(
        queries, instruction=get_query_instruction("query_to_fact"), norm=True
    )
    qp = rag.embedding_model.batch_encode(
        queries, instruction=get_query_instruction("query_to_passage"), norm=True
    )
    b = len(queries)
    k = min(link_top_k, len(fact_keys))

    # fact scoring + mock recognition memory (ref 1427-1465, 1659-1707)
    raw_f = qf @ fact_emb.T  # [B, F]
    lo = raw_f.min(axis=1, keepdims=True)
    rng = raw_f.max(axis=1, keepdims=True) - lo
    norm_f = np.where(rng == 0, 1.0, (raw_f - lo) / np.where(rng == 0, 1.0, rng))
    top_idx = np.zeros((b, k), dtype=np.int64)
    top_mask = np.zeros((b, k), dtype=np.float32)
    sel_scores = np.zeros((b, k), dtype=np.float32)
    for i in range(b):
        cand = np.argsort(-norm_f[i], kind="stable")[:k]
        kept = _mock_filter_kept(queries[i], [rag._fact_tuples[j] for j in cand])
        for slot, ci in enumerate(kept[:k]):
            top_idx[i, slot] = cand[ci]
            top_mask[i, slot] = 1.0
            sel_scores[i, slot] = norm_f[i, cand[ci]]

    # seeds (host twin, parity-pinned vs the device builder)
    dpr_raw = qp @ passage_emb.T  # [B, P]
    reset, dpr_norm, has_facts = build_reset_vectors(
        sel_scores, top_idx, top_mask, dpr_raw,
        fact_subj, fact_obj, passage_node_ids, chunk_counts,
        num_nodes=n, n_total=n, link_top_k=link_top_k,
        passage_node_weight=cfg.passage_node_weight,
    )
    doc_texts = [rag.chunk_embedding_store.get_row(kk)["content"] for kk in passage_keys]
    return {
        "n": n, "src": src, "dst": dst, "w_norm": w_norm,
        "dangling": dangling, "reset": reset, "dpr_norm": dpr_norm,
        "has_facts": has_facts, "passage_node_ids": passage_node_ids,
        "doc_texts": doc_texts, "damping": cfg.damping,
    }


def _slice_seeds(s: Dict, n: int) -> Dict:
    """First-n-queries view of a _twin_seeds dict (per-query arrays are
    sliced; the shared operator arrays pass through)."""
    out = dict(s)
    for key in ("reset", "dpr_norm", "has_facts"):
        out[key] = s[key][:n]
    return out


def numpy_retrieval_twin(
    rag, queries: List[str], top_k: int = 20, seeds: Dict | None = None
) -> List[List[str]]:
    """Host-side reimplementation of retrieve() (ref HippoRAG.py:1427-1656).

    Uses only host data (GraphBuilder dicts, the stores, the embedder)
    and scipy/numpy math — no torch. Returns top_k doc texts per query.
    ``seeds`` (a precomputed ``_twin_seeds`` dict covering at least these
    queries) avoids re-deriving the operator and seed construction.
    """
    import scipy.sparse as sp

    cfg = rag.global_config
    s = _slice_seeds(seeds, len(queries)) if seeds else _twin_seeds(rag, queries)
    n, d = s["n"], s["damping"]
    T = sp.csr_matrix((s["w_norm"], (s["dst"], s["src"])), shape=(n, n))
    dangling = s["dangling"]
    b = len(queries)

    r = s["reset"].astype(np.float64)
    rs = r.sum(axis=1, keepdims=True)
    r = np.where(rs > 0, r / np.where(rs > 0, rs, 1.0), 1.0 / n)
    p = r.copy()
    for _ in range(cfg.ppr_max_iters):
        y = p @ T.T  # y[b, v] = sum_u T[v, u] p[b, u]
        dm = p @ dangling
        p_next = (1 - d) * r + d * (y + dm[:, None] * r)
        if np.max(np.abs(p_next - p)) < cfg.ppr_tol:
            p = p_next
            break
        p = p_next

    doc_scores = np.where(
        s["has_facts"][:, None], p[:, s["passage_node_ids"]], s["dpr_norm"]
    )
    results = []
    for i in range(b):
        order = np.argsort(-doc_scores[i], kind="stable")[:top_k]
        results.append([s["doc_texts"][j] for j in order])
    return results


def exact_rank_check(
    rag,
    queries: List[str],
    device_doc_lists: List[List[str]],
    top_k: int = 20,
    seeds: Dict | None = None,
) -> Dict:
    """Bound the production solver's ranking drift against the EXACT solver:
    solve every query's PPR with the native serial float64 power iteration
    at tol 1e-12 (graph/native/graph_core.cpp ppr_serial — the prpack
    equivalent, ref HippoRAG.py:1736-1743) over the same seeds, and compare
    document rankings. When the native library is unavailable the same
    iteration runs in scipy, and ``solver`` says which one ran.

    Returns mean top-k overlap (``agreement``), the worst per-query
    overlap, and the max rank displacement of any of the device's top-k
    docs in the exact full ranking.
    """
    from ..graph import native as _native

    s = _slice_seeds(seeds, len(queries)) if seeds else _twin_seeds(rag, queries)
    n, d = s["n"], s["damping"]
    src32 = np.ascontiguousarray(s["src"], np.int32)
    dst32 = np.ascontiguousarray(s["dst"], np.int32)
    wn32 = np.ascontiguousarray(s["w_norm"], np.float32)
    pn = s["passage_node_ids"]
    text_to_pos = {t: j for j, t in enumerate(s["doc_texts"])}

    solver = "native_ppr_serial"
    T = None
    if not _native.native_available():
        import scipy.sparse as sp

        T = sp.csr_matrix((s["w_norm"], (s["dst"], s["src"])), shape=(n, n))
        solver = "scipy_float64"

    overlaps, max_disp = [], 0
    n_displaced = 0  # queries with ANY top-k position differing
    iters_used = []
    for i, q in enumerate(queries):
        reset = s["reset"][i].astype(np.float64)
        if T is None:
            p, iters = _native.ppr_serial(
                src32, dst32, wn32, s["dangling"], n, reset,
                damping=d, max_iters=200, tol=1e-12,
            )
        else:
            r = reset.copy()
            rs = r.sum()
            r = r / rs if rs > 0 else np.full(n, 1.0 / n)
            p = r.copy()
            iters = 0
            for iters in range(1, 201):
                y = T @ p
                dm = float(s["dangling"] @ p)
                p_next = (1 - d) * r + d * (y + dm * r)
                if np.max(np.abs(p_next - p)) < 1e-12:
                    p = p_next
                    break
                p = p_next
        iters_used.append(iters)
        if s["has_facts"][i]:
            doc_scores = p[pn]
        else:
            doc_scores = s["dpr_norm"][i]
        exact_order = np.argsort(-doc_scores, kind="stable")
        exact_rank = np.empty(len(pn), dtype=np.int64)
        exact_rank[exact_order] = np.arange(len(pn))
        exact_top = {int(j) for j in exact_order[:top_k]}

        got = [text_to_pos[t] for t in device_doc_lists[i][:top_k]]
        overlaps.append(len(set(got) & exact_top) / max(len(exact_top), 1))
        q_disp = 0
        for pos_dev, j in enumerate(got):
            q_disp = max(q_disp, abs(int(exact_rank[j]) - pos_dev))
        max_disp = max(max_disp, q_disp)
        n_displaced += q_disp > 0

    return {
        "solver": solver,
        "queries": len(queries),
        "agreement": round(float(np.mean(overlaps)), 4),
        "worst_overlap": round(float(np.min(overlaps)), 4),
        "max_rank_displacement": int(max_disp),
        "queries_with_displacement": int(n_displaced),
        "mean_exact_iters": round(float(np.mean(iters_used)), 1),
    }


# ----------------------------------------------------------------------
# End-to-end runner
# ----------------------------------------------------------------------
def run_2wiki_eval(
    corpus_path: str,
    save_dir: str,
    n_queries: int = 600,
    n_docs: int | None = None,
    top_k: int = 20,
    twin_queries: int | None = None,
    exact_queries: int | None = None,
    config_overrides: Dict | None = None,
    device="cuda",
) -> Dict:
    """Index the real corpus through the production pipeline on ``device``
    and measure:

    - graph vs dense Recall@{1,2,5,10,20} on synthesized 2-hop queries;
    - rank agreement (mean top-k overlap fraction) between the device pipeline
      and the NumPy twin on ``twin_queries`` queries (default: all);
    - with ``exact_queries`` set (0 = all), ranking drift vs the native
      float64 tol-1e-12 serial solver (``exact_rank_check``).
    """
    from ..config import BaseConfig
    from ..hipporag import HippoRAG
    from .metrics import RetrievalRecall

    corpus = load_corpus(corpus_path)
    if n_docs:
        corpus = corpus[:n_docs]
    docs = [doc_text(item) for item in corpus]
    # n_queries=0 means "every synthesizable query" (the full corpus
    # yields 1206 bridge pairs): the largest paired sample it supports
    queries = synthesize_multihop_queries(
        corpus, max_queries=n_queries or 10**9
    )
    if not queries:
        raise ValueError("no multi-hop queries could be synthesized")
    questions = [q for q, _, _ in queries]
    gold_docs = [g for _, g, _ in queries]

    cfg_kw = dict(
        llm_name="mock",
        embedding_model_name="hashing",
        save_dir=save_dir,
        embedding_dim=1024,
        retrieval_top_k=top_k,
        embedding_batch_size=256,
        # Harness seeding calibration (the JAX package's
        # scripts/twiki_sweep.py): the hashing n-gram embedder's DPR scores
        # are much flatter than the NV-Embed scale the reference's
        # passage_node_weight=0.05 was tuned for, which under-anchors the
        # dense-findable doc; 0.1 restores the anchor without drowning
        # graph mass, and link_top_k=3 drops the noisiest seed facts.
        # Framework DEFAULTS are unchanged (reference parity for real
        # embedders).
        passage_node_weight=0.1,
        linking_top_k=3,
    )
    cfg_kw.update(config_overrides or {})
    rag = HippoRAG(global_config=BaseConfig(**cfg_kw), device=device)

    # shared index -> warm -> retrieve -> dense -> paired-stats protocol
    # (small deltas must carry error bars)
    from .harness import graph_vs_dense_eval

    out = graph_vs_dense_eval(rag, docs, questions, gold_docs)
    results = out.pop("results")
    out.pop("dense_results")

    nt = twin_queries or len(questions)
    ne = (
        None if exact_queries is None else (exact_queries or len(questions))
    )
    # one seed-construction pass covers both the NumPy twin and the
    # exact-solver check (operator build + fact scoring + reset vectors
    # are the dominant host cost and identical for both)
    seeds = _twin_seeds(rag, questions[: max(nt, ne or 0)])
    t0 = time.time()
    twin_docs = numpy_retrieval_twin(
        rag, questions[:nt], top_k=top_k, seeds=seeds
    )
    twin_s = time.time() - t0
    overlaps = []
    for got, want in zip(results[:nt], twin_docs):
        a, b = set(got.docs[:top_k]), set(want[:top_k])
        overlaps.append(len(a & b) / max(len(b), 1))
    agreement = float(np.mean(overlaps))
    twin_recall, _ = RetrievalRecall(rag.global_config).calculate_metric_scores(
        gold_docs[:nt], twin_docs, [2, 5, top_k]
    )

    exact = None
    if ne is not None:
        t0 = time.time()
        exact = exact_rank_check(
            rag, questions[:ne], [r.docs for r in results[:ne]], top_k=top_k,
            seeds=seeds,
        )
        exact["check_s"] = round(time.time() - t0, 1)
        logger.info("2wiki exact-solver check: %s", exact)

    return {
        **({"exact": exact} if exact is not None else {}),
        **out,
        "twin_s": round(twin_s, 1),
        "twin_recall": {kk: twin_recall[f"Recall@{kk}"] for kk in (2, 5, top_k)},
        "rank_agreement": round(agreement, 4),
        "twin_queries": nt,
    }
