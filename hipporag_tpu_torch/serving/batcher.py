"""Micro-batching request coalescer for online serving.

The reference serves retrieval one query per Python-loop iteration
(ref ``HippoRAG.py:459-480`` — ``retrieve`` iterates queries serially;
there is no concurrent-serving story to port). On an accelerator batching
is THE serving lever: the device work of a retrieval bucket grows far
more slowly than its query count (one pass over the fact keys and one
PPR solve serve every column of the batch), so per-query cost falls with
the batch size. The micro-batcher converts N concurrent single-query
callers into one device batch: requests queue, a worker
drains up to ``max_batch_size`` of them after a bounded coalescing
window (``max_wait_ms`` past the first arrival), and each caller gets
its own result back through a Future.

Two properties matter for the device path downstream:

- Coalesced batches land on the same sub-bucket pads (8/32/128/...) the
  batch path uses (``hipporag.py::_retrieve_batches``), so serving
  traffic runs the shapes the batch path runs.
- The worker serializes calls into the (not thread-safe) HippoRAG
  instance, so concurrent callers need no locking of their own.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["BatcherClosed", "BatcherSaturated", "MicroBatcher"]


class BatcherClosed(RuntimeError):
    """Raised by submit() after close() — the worker is draining/gone."""


class BatcherSaturated(RuntimeError):
    """Raised by submit() when the queue is at max_pending — shed load
    instead of letting latency grow without bound (HTTP maps this to 503)."""


class MicroBatcher:
    """Coalesce concurrent ``submit(item)`` calls into ``batch_fn(items)``.

    ``batch_fn`` receives a list of items (submission order) and must
    return a sequence of results of the same length, position-aligned.
    A ``batch_fn`` exception fails every request in that batch (and only
    that batch — the worker keeps serving).

    ``max_wait_ms`` bounds the added p50 latency: the worker dispatches
    as soon as ``max_batch_size`` requests are queued, or that many
    milliseconds after the first queued arrival, whichever comes first.
    ``max_wait_ms=0`` dispatches whatever is queued immediately (pure
    opportunistic coalescing — concurrent arrivals still merge while a
    previous batch occupies the device).
    """

    def __init__(
        self,
        batch_fn: Callable[[List[Any]], Sequence[Any]],
        *,
        max_batch_size: int = 128,
        max_wait_ms: float = 8.0,
        max_pending: Optional[int] = None,
        name: str = "microbatcher",
    ):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self._fn = batch_fn
        self._max_batch = int(max_batch_size)
        self._max_wait_s = float(max_wait_ms) / 1000.0
        self._max_pending = max_pending
        self._cv = threading.Condition()
        self._pending: List[tuple] = []  # (item, Future, t_submit)
        self._closed = False
        # stats (mutated only under self._cv)
        self._n_requests = 0
        self._n_batches = 0
        self._n_failed_batches = 0
        self._n_shed = 0
        self._batch_size_counts: Dict[int, int] = {}
        self._total_queue_wait_s = 0.0
        self._max_queue_wait_s = 0.0
        self._worker = threading.Thread(target=self._run, daemon=True, name=name)
        self._worker.start()

    # ------------------------------------------------------------ API
    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise BatcherClosed("MicroBatcher is closed")
            if (
                self._max_pending is not None
                and len(self._pending) >= self._max_pending
            ):
                self._n_shed += 1
                raise BatcherSaturated(
                    f"{len(self._pending)} requests already queued "
                    f"(max_pending={self._max_pending})"
                )
            self._pending.append((item, fut, time.perf_counter()))
            self._n_requests += 1
            self._cv.notify_all()
        return fut

    def __call__(self, item: Any, timeout: Optional[float] = None) -> Any:
        """Synchronous convenience: submit and wait for the result."""
        return self.submit(item).result(timeout=timeout)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting requests; drain already-queued ones, then join."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            n_req, n_b = self._n_requests, self._n_batches
            return {
                "requests": n_req,
                "batches": n_b,
                "failed_batches": self._n_failed_batches,
                "shed": self._n_shed,
                "mean_batch_size": round(n_req / n_b, 3) if n_b else 0.0,
                "batch_size_counts": dict(sorted(self._batch_size_counts.items())),
                "mean_queue_wait_ms": (
                    round(1e3 * self._total_queue_wait_s / n_req, 3) if n_req else 0.0
                ),
                "max_queue_wait_ms": round(1e3 * self._max_queue_wait_s, 3),
                "pending": len(self._pending),
                "closed": self._closed,
            }

    # --------------------------------------------------------- worker
    def _take_batch(self) -> Optional[List[tuple]]:
        """Block for the next batch; None = closed and fully drained."""
        with self._cv:
            while not self._pending:
                if self._closed:
                    return None
                self._cv.wait()
            # Coalescing window: give concurrent callers max_wait_ms to
            # pile on, unless the batch is already full or we're draining
            # after close() (then latency no longer matters — go now).
            deadline = time.perf_counter() + self._max_wait_s
            while len(self._pending) < self._max_batch and not self._closed:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch = self._pending[: self._max_batch]
            del self._pending[: self._max_batch]
            return batch

    def _record_batch(self, batch: List[tuple]) -> None:
        """Count a batch that actually dispatched (post-cancellation)."""
        now = time.perf_counter()
        with self._cv:
            self._n_batches += 1
            size = len(batch)
            self._batch_size_counts[size] = self._batch_size_counts.get(size, 0) + 1
            for _, _, t in batch:
                wait = now - t
                self._total_queue_wait_s += wait
                if wait > self._max_queue_wait_s:
                    self._max_queue_wait_s = wait

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            # Transition futures to RUNNING before dispatch: after this,
            # Future.cancel() can no longer succeed, so set_result below
            # cannot race a cancellation into InvalidStateError (which
            # would kill this worker and hang every later request).
            # Already-cancelled requests drop out and cost no device work.
            batch = [
                b for b in batch if b[1].set_running_or_notify_cancel()
            ]
            if not batch:
                continue  # fully cancelled — no device work, no batch stats
            self._record_batch(batch)
            items = [b[0] for b in batch]
            try:
                results = self._fn(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(items)} items"
                    )
            except BaseException as exc:  # noqa: BLE001 — fail the batch, keep serving
                with self._cv:
                    self._n_failed_batches += 1
                for _, fut, _ in batch:
                    fut.set_exception(exc)
                continue
            for (_, fut, _), res in zip(batch, results):
                fut.set_result(res)
