"""Thread-safe online serving facade over a prepared HippoRAG instance.

``RetrievalService`` is what a production deployment instantiates once
per replica: concurrent callers (HTTP handler threads, RPC workers)
call :meth:`retrieve` / :meth:`qa` from any thread; a per-lane
:class:`~hipporag_tpu_torch.serving.batcher.MicroBatcher` coalesces them
into device batches and serializes access to the underlying (not
thread-safe) :class:`~hipporag_tpu_torch.hipporag.HippoRAG` or
:class:`~hipporag_tpu_torch.standard_rag.StandardRAG`.

The reference has no online serving surface at all — its entry point is
a one-shot batch experiment script (ref ``main.py:113-160``). Batching is
how an accelerator earns its keep under concurrent load (see
``batcher.py``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ..utils.logging import get_logger
from ..utils.misc import QuerySolution
from .batcher import BatcherClosed, MicroBatcher

logger = get_logger(__name__)

__all__ = ["RetrievalService"]


def _slice_solution(sol: QuerySolution, top_k: int) -> QuerySolution:
    """Trim a batched solution down to one caller's requested top_k.

    Everything mutable is COPIED — with hot-query dedup several callers
    share one engine solution, and an ndarray slice is a view: a caller
    reweighting its doc_scores in place must not corrupt another
    caller's response (or the engine's own buffers)."""
    return QuerySolution(
        question=sol.question,
        docs=list(sol.docs[:top_k]),
        doc_scores=(
            sol.doc_scores[:top_k].copy() if sol.doc_scores is not None else None
        ),
        answer=sol.answer,
        gold_answers=(list(sol.gold_answers) if sol.gold_answers else None),
        gold_docs=(list(sol.gold_docs) if sol.gold_docs else None),
        thoughts=(list(sol.thoughts) if sol.thoughts else None),
        doc_metadata=(
            [dict(m) for m in sol.doc_metadata[:top_k]]
            if sol.doc_metadata is not None
            else None
        ),
        graph_seeds=(list(sol.graph_seeds) if sol.graph_seeds else None),
    )


class RetrievalService:
    """Concurrent retrieve/QA serving over one HippoRAG index replica.

    Parameters
    ----------
    rag:
        An indexed :class:`HippoRAG` (or :class:`StandardRAG`-compatible)
        instance. Retrieval state is prepared eagerly at construction so
        the first request doesn't pay graph upload + executable warmup.
    max_batch_size:
        Coalescing cap per lane; defaults to the engine's
        ``ppr_batch_size`` (the largest pre-compiled sub-bucket).
    max_wait_ms:
        Coalescing window — the p50 latency tax a lone request pays to
        let concurrent arrivals merge; 8 ms default.
    max_pending:
        Per-lane queue bound; submissions beyond it raise
        :class:`BatcherSaturated` (HTTP 503) instead of growing latency
        without bound. ``None`` disables shedding.
    response_cache_size:
        LRU cache of retrieve-lane responses keyed by query (a hit must
        hold at least the requested top_k docs): a trending query served
        across SEPARATE batches costs zero device work after the first
        (in-batch duplicates are already deduped). Invalidated whole on
        :meth:`index`/:meth:`delete`. ``0`` disables (default — enable
        per deployment policy).
    """

    def __init__(
        self,
        rag,
        *,
        max_batch_size: Optional[int] = None,
        max_wait_ms: float = 8.0,
        max_pending: Optional[int] = 1024,
        response_cache_size: int = 0,
    ):
        if response_cache_size < 0:
            raise ValueError(
                "response_cache_size must be >= 0 (0 disables; there is "
                "no 'unlimited' setting — entries hold full doc rankings)"
            )
        self._rag = rag
        cfg = rag.global_config
        if max_batch_size is None:
            max_batch_size = max(1, int(getattr(cfg, "ppr_batch_size", 128)))
        self._default_top_k = int(getattr(cfg, "retrieval_top_k", 200))
        if getattr(rag, "ready_to_retrieve", True) is False:
            rag.prepare_retrieval_objects()
        # Both lane workers call into the same (not thread-safe) engine;
        # this lock serializes them. A QA batch holds it across its LLM
        # round trips, so heavy QA traffic delays retrieve batches — the
        # price of one shared replica. Run separate replicas to decouple.
        self._engine_lock = threading.Lock()
        self._retrieve_lane = MicroBatcher(
            self._retrieve_batch,
            max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms,
            max_pending=max_pending,
            name="serve-retrieve",
        )
        self._qa_lane = MicroBatcher(
            self._qa_batch,
            max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms,
            max_pending=max_pending,
            name="serve-qa",
        )
        self._lock = threading.Lock()
        # bounded per-lane latency windows -> p50/p99 without unbounded growth
        self._latencies: Dict[str, deque] = {
            "retrieve": deque(maxlen=2048),
            "qa": deque(maxlen=2048),
        }
        self._dedup_saved = 0
        # LRU response cache: OrderedDict under self._lock (move-to-end
        # on hit); entries are engine solutions — sliced to fresh copies
        # on every hit, so cached buffers are never handed out directly
        self._cache_size = int(response_cache_size)
        self._response_cache: "OrderedDict[str, QuerySolution]" = OrderedDict()
        self._cache_hits = 0
        self._cache_gen = 0  # bumped on invalidate; guards late population
        self._started = time.time()
        self._closed = False

    # ------------------------------------------------------- batch fns
    # Run on the lane worker thread — the only thread touching self._rag.
    def _retrieve_batch(self, items: List[tuple]) -> List[QuerySolution]:
        # Hot-query dedup: N clients asking the same (trending) question
        # cost ONE device row, then fan back out. Every caller gets its
        # own sliced copy so nobody shares a mutable solution.
        # Solve at max(requested, engine default), as the JAX package
        # does (there, per-request k values would each compile a fresh
        # document top-k): one solve per batch serves every k <= default,
        # the extra rows are sliced off per caller below, and results
        # equal the JAX package's.
        solve_k = max(max(k for _, k in items), self._default_top_k)
        uniq = list(dict.fromkeys(q for q, _ in items))
        with self._lock:
            self._dedup_saved += len(items) - len(uniq)
        with self._engine_lock:
            sols = self._rag.retrieve(uniq, num_to_retrieve=solve_k)
            with self._lock:
                gen = self._cache_gen  # index()/delete() wait on the
                # engine lock, so results computed here belong to `gen`
        by_q = dict(zip(uniq, sols))
        if self._cache_size:
            with self._lock:
                if self._cache_gen == gen:  # don't resurrect pre-update results
                    for q, sol in by_q.items():
                        self._response_cache[q] = sol
                        self._response_cache.move_to_end(q)
                    while len(self._response_cache) > self._cache_size:
                        self._response_cache.popitem(last=False)
        return [_slice_solution(by_q[q], k) for q, k in items]

    def _cache_lookup(self, query: str, top_k: int) -> Optional[QuerySolution]:
        """Serve a hot query from the LRU if a deep-enough entry exists."""
        if not self._cache_size:
            return None
        with self._lock:
            sol = self._response_cache.get(query)
            if sol is None or len(sol.docs) < top_k:
                return None
            self._response_cache.move_to_end(query)
            self._cache_hits += 1
        return _slice_solution(sol, top_k)

    def _qa_batch(self, items: List[tuple]) -> List[QuerySolution]:
        solve_k = max(max(k for _, k in items), self._default_top_k)
        uniq = list(dict.fromkeys(q for q, _ in items))
        with self._lock:
            self._dedup_saved += len(items) - len(uniq)
        with self._engine_lock:
            sols = self._rag.retrieve(uniq, num_to_retrieve=solve_k)
            sols, _responses, _metadata = self._rag.qa(sols)
        by_q = dict(zip(uniq, sols))
        return [_slice_solution(by_q[q], k) for q, k in items]

    # -------------------------------------------------------- requests
    def retrieve_async(self, query: str, top_k: Optional[int] = None) -> Future:
        if self._closed:  # uniform closed behavior — no stale cache serves
            raise BatcherClosed("RetrievalService is closed")
        k = int(top_k or self._default_top_k)
        cached = self._cache_lookup(query, k)
        if cached is not None:
            fut: Future = Future()
            fut.set_result(cached)
            return fut
        return self._retrieve_lane.submit((query, k))

    def qa_async(self, query: str, top_k: Optional[int] = None) -> Future:
        return self._qa_lane.submit((query, int(top_k or self._default_top_k)))

    def retrieve(
        self, query: str, top_k: Optional[int] = None, timeout: Optional[float] = None
    ) -> QuerySolution:
        t0 = time.perf_counter()
        sol = self.retrieve_async(query, top_k).result(timeout=timeout)
        self._record("retrieve", time.perf_counter() - t0)
        return sol

    def qa(
        self, query: str, top_k: Optional[int] = None, timeout: Optional[float] = None
    ) -> QuerySolution:
        """Retrieve + answer. ``top_k`` bounds the RETURNED docs; the
        answer is always generated from the engine's ``qa_top_k`` context
        (same semantics as ``HippoRAG.rag_qa``)."""
        t0 = time.perf_counter()
        sol = self.qa_async(query, top_k).result(timeout=timeout)
        self._record("qa", time.perf_counter() - t0)
        return sol

    def warmup(self, query: str = "warmup query") -> None:
        """Compile/prime the single-request path before taking traffic."""
        self.retrieve(query, top_k=1)

    # --------------------------------------------- online index updates
    # Mutations take the engine lock directly: in-flight batches finish
    # first, queued requests resume against the updated index (the
    # engine re-prepares retrieval state lazily on its next retrieve).
    # Capacity-padded device buffers (graph/csr.py pick_capacity, the sticky
    # ELL caps) keep the layout stable across steady-state growth.
    def index(self, docs: List[str]) -> None:
        """Add documents to the live index between serving batches."""
        with self._engine_lock:
            self._rag.index(docs)
        self._invalidate_cache()

    def delete(self, docs: List[str]) -> None:
        """Remove documents from the live index between serving batches."""
        with self._engine_lock:
            self._rag.delete(docs)
        self._invalidate_cache()

    def _invalidate_cache(self) -> None:
        with self._lock:
            self._response_cache.clear()
            self._cache_gen += 1

    # ----------------------------------------------------------- admin
    def _record(self, lane: str, elapsed_s: float) -> None:
        with self._lock:
            self._latencies[lane].append(elapsed_s)

    def reset_stats(self) -> None:
        """Clear the latency windows (e.g. after warmup, before a
        measurement window). Lane batch/request counters are monotonic —
        snapshot and subtract those instead."""
        with self._lock:
            for dq in self._latencies.values():
                dq.clear()

    def health(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {"status": "ok", "uptime_s": round(time.time() - self._started, 1)}
        get_info = getattr(self._rag, "get_graph_info", None)
        if callable(get_info):
            try:
                info["graph"] = get_info()
            except Exception as exc:  # pragma: no cover — degraded, not dead
                info["graph_error"] = str(exc)
        return info

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lat = {}
            for lane in ("retrieve", "qa"):
                xs = sorted(self._latencies[lane])
                lat[lane] = (
                    {
                        "mean_ms": round(1e3 * sum(xs) / len(xs), 2),
                        "p50_ms": round(1e3 * xs[len(xs) // 2], 2),
                        "p99_ms": round(1e3 * xs[min(len(xs) - 1, int(len(xs) * 0.99))], 2),
                        "window": len(xs),
                    }
                    if xs
                    else None
                )
            dedup = self._dedup_saved
            cache = {
                "hits": self._cache_hits,
                "entries": len(self._response_cache),
                "size": self._cache_size,
            }
        return {
            "latency_ms": lat,
            "dedup_saved": dedup,
            "response_cache": cache,
            "retrieve": self._retrieve_lane.stats(),
            "qa": self._qa_lane.stats(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._retrieve_lane.close()
        self._qa_lane.close()

    def __enter__(self) -> "RetrievalService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
