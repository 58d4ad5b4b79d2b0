"""Front-end-agnostic HTTP route dispatch for :class:`RetrievalService`.

One dispatcher, two transports: the stdlib threaded server
(``http_server.py``) and the native C++ epoll front-end
(``native_http.py``) both feed parsed requests through
:func:`dispatch`, so the wire contract (paths, validation, status
codes, error strings) is defined exactly once and contract tests cover
both front-ends by construction.

Endpoints (JSON in/out unless noted):

- ``GET  /health``  — liveness + graph info
- ``GET  /stats``   — batcher/latency counters
- ``GET  /metrics`` — the same counters in Prometheus exposition format
  (text/plain; a ``str`` payload from :func:`dispatch` means text/plain)
- ``POST /retrieve`` ``{"query": str, "top_k": int?}`` → ranked docs
- ``POST /qa``       same body → docs + generated answer
- ``POST /index``   ``{"docs": [str, ...]}`` → add docs to the live index
- ``POST /delete``  same body → remove docs from the live index

The reference exposes no server (its ``main.py`` is a one-shot batch
experiment).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from ..utils.logging import get_logger
from ..utils.misc import QuerySolution
from .batcher import BatcherSaturated

logger = get_logger(__name__)

__all__ = [
    "MAX_BODY_BYTES",
    "MAX_INDEX_BODY_BYTES",
    "body_limit",
    "render_prometheus",
    "solution_to_json",
    "dispatch",
]

MAX_BODY_BYTES = 1 << 20  # 1 MiB — a retrieval query is a sentence, not a corpus
MAX_INDEX_BODY_BYTES = 64 << 20  # /index and /delete carry document batches

_GET_PATHS = ("/health", "/stats", "/metrics")
_POST_PATHS = ("/retrieve", "/qa", "/index", "/delete")


def body_limit(path: str) -> int:
    """Max request-body bytes for a POST path (front-ends may enforce it
    before buffering the body; :func:`dispatch` re-checks regardless)."""
    return MAX_INDEX_BODY_BYTES if path in ("/index", "/delete") else MAX_BODY_BYTES


def render_prometheus(stats: Dict[str, Any]) -> str:
    """Render :meth:`RetrievalService.stats` as Prometheus exposition text.

    Counters keep their monotone semantics (requests/batches/shed/dedup/
    cache hits accumulate for the service lifetime; the latency window is
    exposed as gauges since it is a sliding window, not a histogram).
    """
    lines = []

    def metric(name: str, mtype: str, help_text: str, samples):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lines.append(f"{name}{labels} {value}")

    lane_counter_keys = (
        ("requests", "hipporag_requests_total", "Requests accepted per lane"),
        ("batches", "hipporag_batches_total", "Device batches dispatched per lane"),
        ("failed_batches", "hipporag_failed_batches_total",
         "Batches whose batch_fn raised"),
        ("shed", "hipporag_shed_total",
         "Requests rejected at the max_pending bound (HTTP 503)"),
    )
    lane_gauge_keys = (
        ("pending", "hipporag_pending_requests", "Requests queued right now"),
        ("mean_batch_size", "hipporag_mean_batch_size",
         "Mean coalesced batch size"),
        ("mean_queue_wait_ms", "hipporag_mean_queue_wait_ms",
         "Mean wait in the coalescing window"),
    )
    lanes = [k for k in ("retrieve", "qa") if isinstance(stats.get(k), dict)]
    for key, name, help_text in lane_counter_keys:
        metric(name, "counter", help_text,
               [(f'{{lane="{ln}"}}', stats[ln].get(key, 0)) for ln in lanes])
    for key, name, help_text in lane_gauge_keys:
        metric(name, "gauge", help_text,
               [(f'{{lane="{ln}"}}', stats[ln].get(key, 0)) for ln in lanes])

    lat = stats.get("latency_ms") or {}
    lat_samples = []
    for ln, vals in lat.items():
        if not vals:
            continue
        for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
            lat_samples.append(
                (f'{{lane="{ln}",quantile="{q}"}}', vals.get(key, 0))
            )
    if lat_samples:
        metric("hipporag_latency_ms", "gauge",
               "End-to-end request latency over the sliding window",
               lat_samples)

    metric("hipporag_dedup_saved_total", "counter",
           "Device rows saved by hot-query dedup",
           [("", stats.get("dedup_saved", 0))])
    cache = stats.get("response_cache") or {}
    metric("hipporag_response_cache_hits_total", "counter",
           "Responses served from the LRU cache",
           [("", cache.get("hits", 0))])
    metric("hipporag_response_cache_entries", "gauge",
           "Entries currently cached", [("", cache.get("entries", 0))])
    return "\n".join(lines) + "\n"


def solution_to_json(sol: QuerySolution) -> Dict[str, Any]:
    """Full (un-truncated) wire form of one solution."""
    return {
        "question": sol.question,
        "answer": sol.answer,
        "docs": list(sol.docs),
        "doc_scores": (
            [round(float(v), 6) for v in sol.doc_scores]
            if sol.doc_scores is not None
            else None
        ),
    }


def dispatch(
    service,
    method: str,
    path: str,
    body: bytes,
    request_timeout_s: Optional[float] = None,
) -> Tuple[int, Dict[str, Any]]:
    """Route one parsed HTTP request; returns ``(status, payload)`` where
    payload is a JSON-able dict — or a ``str`` for pre-rendered text
    responses (``/metrics``), which transports send as text/plain.

    Never raises: service failures map to 5xx payloads so a transport
    can always write a well-formed JSON response.
    """
    if method == "GET":
        if path not in _GET_PATHS:
            return 404, {"error": f"unknown path {path}"}
        try:
            if path == "/health":
                payload = service.health()
            elif path == "/metrics":
                payload = render_prometheus(service.stats())
            else:
                payload = service.stats()
        except Exception as exc:  # noqa: BLE001 — degraded service, not a crash
            logger.exception("serving %s failed", path)
            return 500, {"error": f"{type(exc).__name__}: {exc}"}
        return 200, payload
    if method != "POST":
        return 405, {"error": f"unsupported method {method}"}
    if path not in _POST_PATHS:
        return 404, {"error": f"unknown path {path}"}
    if not body:
        return 400, {"error": "empty body"}
    if len(body) > body_limit(path):
        # 413 to match the native front-end, which rejects at header-parse
        # time before the body is ever buffered
        return 413, {"error": "body too large"}
    try:
        data = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        return 400, {"error": f"invalid JSON: {exc}"}
    if not isinstance(data, dict):
        return 400, {"error": "body must be a JSON object"}
    if path in ("/index", "/delete"):
        return _handle_update(service, path, data)
    return _handle_query(service, path, data, request_timeout_s)


def _handle_query(
    service, path: str, data: Dict[str, Any], request_timeout_s: Optional[float]
) -> Tuple[int, Dict[str, Any]]:
    query = data.get("query")
    if not isinstance(query, str) or not query.strip():
        return 400, {"error": "'query' must be a non-empty string"}
    top_k = data.get("top_k")
    if top_k is not None and (not isinstance(top_k, int) or top_k < 1):
        return 400, {"error": "'top_k' must be a positive integer"}
    try:
        if path == "/qa":
            sol = service.qa(query, top_k, timeout=request_timeout_s)
        else:
            sol = service.retrieve(query, top_k, timeout=request_timeout_s)
    except BatcherSaturated as exc:
        return 503, {"error": f"overloaded: {exc}"}
    except TimeoutError:
        return 504, {"error": "request timed out"}
    except Exception as exc:  # noqa: BLE001 — surface, don't crash the transport
        logger.exception("serving %s failed", path)
        return 500, {"error": f"{type(exc).__name__}: {exc}"}
    return 200, solution_to_json(sol)


def _handle_update(
    service, path: str, data: Dict[str, Any]
) -> Tuple[int, Dict[str, Any]]:
    docs = data.get("docs")
    if (
        not isinstance(docs, list)
        or not docs
        or not all(isinstance(d, str) and d.strip() for d in docs)
    ):
        return 400, {"error": "'docs' must be a non-empty list of strings"}
    try:
        if path == "/index":
            service.index(docs)
        else:
            service.delete(docs)
    except Exception as exc:  # noqa: BLE001 — surface, don't crash the transport
        logger.exception("serving %s failed", path)
        return 500, {"error": f"{type(exc).__name__}: {exc}"}
    return 200, {"ok": True, "docs": len(docs)}
