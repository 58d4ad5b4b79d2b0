"""Online serving layer: micro-batching request coalescer, a thread-safe
service facade over a HippoRAG replica, and two HTTP front-ends (stdlib
threads and a native C++ epoll loop) sharing one route dispatcher.

The reference has no serving surface (its ``main.py`` runs one-shot batch
experiments). See ``batcher.py`` for why batching is the serving lever.
"""

from .batcher import BatcherClosed, BatcherSaturated, MicroBatcher
from .service import RetrievalService

__all__ = ["BatcherClosed", "BatcherSaturated", "MicroBatcher", "RetrievalService"]
