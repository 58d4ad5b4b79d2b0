"""Padded graph compilation (host, NumPy), port of ``hipporag_tpu/graph/csr.py``.

Converts the host ``GraphBuilder`` into the padded ``COOGraph`` that
``ops.pagerank.ell_from_coo`` packs for the device. Capacities grow
geometrically (config.graph_capacity_factor) and round to 128-row multiples,
exactly as in the JAX package, so the two packages build identical layouts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.pagerank import COOGraph
from .builder import GraphBuilder


def round_up(x: int, multiple: int) -> int:
    return ((max(x, 1) + multiple - 1) // multiple) * multiple


def pick_capacity(n: int, current: Optional[int], factor: float, multiple: int) -> int:
    """Keep the current capacity while it fits; otherwise grow by ``factor``.

    The capacity is always strictly greater than ``n``: the last slot is
    the padding/garbage slot (graph_search routes masked endpoints there),
    so it must never alias a real node.
    """
    if current is not None and n < current:
        return current
    return round_up(int(np.ceil(max(n, 1) * factor)) + 1, multiple)


def compile_device_graph(
    builder: GraphBuilder,
    node_capacity: Optional[int] = None,
    edge_capacity: Optional[int] = None,
    capacity_factor: float = 1.25,
) -> tuple[COOGraph, int, int]:
    """Build a padded NumPy COOGraph. Returns (graph, node_capacity, edge_capacity).

    Padding scheme:
    - nodes: indices >= num_nodes are isolated; they are excluded from the
      dangling mask so they contribute no teleport mass.
    - edges: appended with src=0, dst=node_capacity-1, w_norm=0 (keeps the
      dst-sorted invariant; ``ell_from_coo`` drops them).
    """
    src, dst, w = builder.symmetric_coo()
    n = builder.num_nodes
    e = len(src)

    node_cap = pick_capacity(n, node_capacity, capacity_factor, 128)
    edge_cap = pick_capacity(e, edge_capacity, capacity_factor, 1024)

    strength = np.zeros(node_cap, dtype=np.float64)
    np.add.at(strength, src, w.astype(np.float64))

    w_norm = np.zeros(edge_cap, dtype=np.float32)
    src_pad = np.zeros(edge_cap, dtype=np.int32)
    dst_pad = np.full(edge_cap, node_cap - 1, dtype=np.int32)
    if e:
        src_pad[:e] = src
        dst_pad[:e] = dst
        w_norm[:e] = (w.astype(np.float64) / strength[src]).astype(np.float32)

    dangling = np.zeros(node_cap, dtype=np.float32)
    real = np.arange(node_cap) < n
    dangling[real & (strength == 0)] = 1.0

    graph = COOGraph(
        src=src_pad,
        dst=dst_pad,
        w_norm=w_norm,
        dangling=dangling,
        num_nodes=np.asarray(n, dtype=np.int32),
    )
    return graph, node_cap, edge_cap
