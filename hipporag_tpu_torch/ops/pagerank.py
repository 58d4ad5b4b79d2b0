"""Batched Personalized PageRank (PyTorch port of ``hipporag_tpu/ops/pagerank.py``).

Two operators, as in the JAX package:

- **COO** (``batched_ppr``): gather + segment sum over the dst-sorted edge
  list, ``y[dst] += w_norm * p[src]``, with the batch as the trailing axis.
  The segment sum runs over dst row pointers (``torch.segment_reduce``),
  one fixed order per segment, so the result does not depend on how a
  device schedules the adds.
- **Bucketed ELL** (``batched_ppr_ell``): the host-side packing into the
  slot-space layout (NumPy, array for array the layout the JAX package
  builds) and the power or Chebyshev iteration. On a CUDA device each step
  is one call of the hand-written kernel ``csrc/ell_ppr_step.cu`` (K2:
  every bucket, the hub chunks, the affine update and the residual), over
  a plan of the operator built once per graph (``ell_plan``); on the CPU
  the step is torch ops (``_spmv_ell`` and the affine update).

Semantics are those of ``igraph.personalized_pagerank`` on a weighted
undirected graph:

- a random step from ``u`` moves to neighbour ``v`` with probability
  ``w(u,v) / strength(u)``;
- with probability ``1 - damping`` (and from zero-strength dangling nodes,
  with their full mass) the walker teleports to the L1-normalized reset.

Fixed point: ``p = (1-d) r + d (T p + (dangling . p) r)``.

The iterations are eager torch: each step's residual test reads one scalar
back to the host, which is where the per-column-tile early exit and the
two-in-a-row stall exit (``_stalled2``) are decided, in float32 exactly as
the JAX ``while_loop`` decides them.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..utils.timing import count
from ._kernels import LaunchCounter, load


class COOGraph(NamedTuple):
    """Normalized transition operator in COO form: host NumPy arrays as
    ``graph/csr.compile_device_graph`` builds it, tensors after ``.to(device)``.

    Attributes:
      src: [E] int32 source node per directed edge (padded with 0).
      dst: [E] int32 destination node per directed edge, sorted ascending.
      w_norm: [E] float32 ``w(src,dst)/strength(src)`` (0 for padding).
      dangling: [N] float32 mask, 1.0 where strength == 0 (real nodes only).
      num_nodes: [] int32 count of real (unpadded) nodes.
    """

    src: np.ndarray
    dst: np.ndarray
    w_norm: np.ndarray
    dangling: np.ndarray
    num_nodes: np.ndarray

    def to(self, device) -> "COOGraph":
        """The same operator as tensors on ``device``."""
        return COOGraph(*(torch.as_tensor(f).to(device) for f in self))


def normalize_symmetric_coo(src, dst, w, num_nodes: int, node_cap: int):
    """Host-side directed-COO → symmetric normalized transition operator.

    Symmetrizes (each directed entry contributes both directions),
    dst-sorts, divides by source strength, and derives the dangling mask.
    Returns (src [E2] i32, dst [E2] i32 sorted, w_norm [E2] f32,
    dangling [node_cap] f32).
    """
    s2 = np.concatenate([src, dst]).astype(np.int64)
    d2 = np.concatenate([dst, src]).astype(np.int64)
    w2 = np.concatenate([w, w]).astype(np.float64)
    order = np.argsort(d2, kind="stable")
    s2, d2, w2 = s2[order], d2[order], w2[order]
    strength = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(strength, s2, w2)
    w_norm = (w2 / np.maximum(strength[s2], 1e-300)).astype(np.float32)
    dangling = np.zeros(node_cap, dtype=np.float32)
    dangling[:num_nodes] = strength == 0
    return s2.astype(np.int32), d2.astype(np.int32), w_norm, dangling


def validate_symmetric_operator(src, dst, dangling, node_cap: int, who: str):
    """Reject directed operators before slot-space ELL packing.

    Slot-space iteration requires the SYMMETRIZED transition operator: a
    node with out-edges but zero in-degree has no slot, so its rank mass
    would silently never propagate, and a dangling node with in-edges would
    break the scalar dm recurrence. ``src``/``dst`` must already exclude
    padding entries.
    """
    indeg_chk = np.zeros(node_cap, dtype=np.int64)
    np.add.at(indeg_chk, dst, 1)
    if len(src) and np.any(indeg_chk[src] == 0):
        raise ValueError(
            f"{who}: operator has source nodes with zero in-degree "
            "(directed input?). The slot-space ELL solver requires the "
            "symmetrized transition."
        )
    dang_chk = np.asarray(dangling)
    if dang_chk.size and np.any(
        (dang_chk > 0) & (indeg_chk[: len(dang_chk)] > 0)
    ):
        raise ValueError(
            f"{who}: dangling nodes with incoming edges; the ELL dangling "
            "recurrence assumes a symmetric operator where dangling == isolated."
        )


def pack_ell_rows(src, w_norm, indeg, starts, nodes, row_width: int):
    """Vectorized ELL row fill: [len(nodes), row_width] (idx, wgt) numpy.

    ``src``/``w_norm`` are the dst-sorted edge arrays; ``indeg``/``starts``
    give each destination node's edge range.
    """
    nb = len(nodes)
    idx = np.zeros((nb, row_width), dtype=np.int32)
    wgt = np.zeros((nb, row_width), dtype=np.float32)
    if nb == 0:
        return idx, wgt
    lens = indeg[nodes]
    total = int(lens.sum())
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    src_pos = np.repeat(starts[nodes], lens) + within
    flat = np.repeat(np.arange(nb) * row_width, lens) + within
    idx.reshape(-1)[flat] = src[src_pos]
    wgt.reshape(-1)[flat] = w_norm[src_pos]
    return idx, wgt


def pack_hub_chunks(src, w_norm, indeg, starts, hub_nodes, hub_width: int):
    """Ragged hub chunk rows: ceil(deg/W) rows per hub, no cross-hub pad.

    Returns (hub_idx [R, W], hub_wgt [R, W], hub_seg [R]) numpy arrays;
    hub_seg holds the owning hub's rank (0..len(hub_nodes)-1), ascending.
    """
    if len(hub_nodes) == 0:
        return (
            np.zeros((0, hub_width), dtype=np.int32),
            np.zeros((0, hub_width), dtype=np.float32),
            np.zeros(0, dtype=np.int32),
        )
    deg = indeg[hub_nodes]
    chunks_per = (-(-deg // hub_width)).astype(np.int64)
    R = int(chunks_per.sum())
    hub_seg = np.repeat(np.arange(len(hub_nodes), dtype=np.int32), chunks_per)
    ci = np.arange(R) - np.repeat(np.cumsum(chunks_per) - chunks_per, chunks_per)
    chunk_lens = np.minimum(deg[hub_seg] - ci * hub_width, hub_width)
    chunk_starts = starts[hub_nodes][hub_seg] + ci * hub_width
    hub_idx = np.zeros((R, hub_width), dtype=np.int32)
    hub_wgt = np.zeros((R, hub_width), dtype=np.float32)
    total = int(chunk_lens.sum())
    within = np.arange(total) - np.repeat(
        np.cumsum(chunk_lens) - chunk_lens, chunk_lens
    )
    src_pos = np.repeat(chunk_starts, chunk_lens) + within
    flat = np.repeat(np.arange(R) * hub_width, chunk_lens) + within
    hub_idx.reshape(-1)[flat] = src[src_pos]
    hub_wgt.reshape(-1)[flat] = w_norm[src_pos]
    return hub_idx, hub_wgt, hub_seg


class ELLGraph(NamedTuple):
    """Transition operator in bucketed ELLPACK form, iterated in SLOT space.

    Rows with similar in-degree are grouped into buckets padded to a fixed
    width W, so each bucket's SpMV row block is a dense gather + weighted
    sum. Hub nodes (in-degree > the largest bucket width) are packed as
    ragged chunk rows of width W_hub, reduced densely per row and summed
    per hub in ``hub_seg`` order.

    ``bucket_idx``/``hub_idx`` hold *slot* ids — rows of the concatenated
    bucket/hub output layout — so the power iteration never leaves slot
    space. Zero-in-degree nodes share the single guaranteed-zero slot; their
    PPR values follow the scalar recurrence carried by ``batched_ppr_ell``.
    The field layout equals the JAX package's ``ELLGraph`` array for array.
    """

    bucket_idx: tuple  # per bucket: [nbcap_i, W_i] int32 SLOT ids (pad rows 0)
    bucket_wgt: tuple  # per bucket: [nbcap_i, W_i] float32 (0 = padding)
    hub_idx: torch.Tensor  # [Rcap, W_hub] int32 SLOT ids
    hub_wgt: torch.Tensor  # [Rcap, W_hub] float32
    hub_seg: torch.Tensor  # [Rcap] int32 — owning hub slot; pad rows -> n_hub_cap
    hub_zero: torch.Tensor  # [n_hub_cap] float32 zeros (hub slot count carrier)
    local_inv: torch.Tensor  # [N_pad] int32: node -> slot in concat(parts)
    slot_to_node: torch.Tensor  # [S] int32: slot -> node (junk/zero slots -> N_pad)
    dangling: torch.Tensor  # [N_pad] float32 (natural order)
    num_nodes: torch.Tensor  # [] int32 real node count

    def to(self, device) -> "ELLGraph":
        return ELLGraph(*(
            tuple(t.to(device) for t in f) if isinstance(f, tuple) else f.to(device)
            for f in self
        ))


# Default bucket widths: exact widths for the small degrees that dominate
# KG mass, then ~25%-step geometric growth (same as the JAX package, so the
# layouts compare array for array).
DEFAULT_BUCKET_WIDTHS = tuple(range(1, 17)) + (
    20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
)


def ell_caps(graph: ELLGraph) -> dict:
    """Shape capacities of an ELLGraph, for ``ell_from_coo(min_caps=...)``."""
    return {
        "bucket_rows": tuple(int(i.shape[0]) for i in graph.bucket_idx),
        "hub_rows": int(graph.hub_idx.shape[0]),
        "n_hub_cap": int(graph.hub_zero.shape[0]),
    }


def _apply_min_caps(b_idx, b_wgt, hub_idx, hub_wgt, hub_seg, n_hub_cap,
                    local_inv, min_caps):
    """Grow the packed ELL parts to at least the previous build's caps.

    Growth pads rows with weight-0 entries (free in the solve: they gather
    slot 0 with weight 0) and shifts the slot layout (local_inv / hub_seg)
    to the new block offsets.
    """
    old_caps = [int(a.shape[0]) for a in b_idx]
    want = list(min_caps.get("bucket_rows", ()))
    if len(want) != len(old_caps):
        return b_idx, b_wgt, hub_idx, hub_wgt, hub_seg, n_hub_cap, local_inv
    new_caps = [max(c, m) for c, m in zip(old_caps, want)]
    old_r = int(hub_idx.shape[0])
    new_r = max(old_r, int(min_caps.get("hub_rows", 0)))
    old_nh, new_nh = int(n_hub_cap), max(int(n_hub_cap), int(min_caps.get("n_hub_cap", 0)))
    if new_caps == old_caps and new_r == old_r and new_nh == old_nh:
        return b_idx, b_wgt, hub_idx, hub_wgt, hub_seg, n_hub_cap, local_inv

    b_idx = [
        np.pad(a, ((0, nc - oc), (0, 0)))
        for a, oc, nc in zip(b_idx, old_caps, new_caps)
    ]
    b_wgt = [
        np.pad(a, ((0, nc - oc), (0, 0)))
        for a, oc, nc in zip(b_wgt, old_caps, new_caps)
    ]
    hub_idx = np.pad(hub_idx, ((0, new_r - old_r), (0, 0)))
    hub_wgt = np.pad(hub_wgt, ((0, new_r - old_r), (0, 0)))
    hub_seg = np.pad(
        np.asarray(hub_seg), (0, new_r - old_r), constant_values=old_nh
    )
    # pad hub rows point at the discard segment, whose id is the hub cap
    hub_seg = np.where(hub_seg == old_nh, new_nh, hub_seg).astype(np.int32)

    old_bases = np.cumsum([0] + old_caps)
    new_bases = np.cumsum([0] + new_caps)
    old_zero = int(old_bases[-1]) + old_nh
    new_zero = int(new_bases[-1]) + new_nh
    li = np.asarray(local_inv)
    block = np.searchsorted(old_bases[1:], li, side="right")
    shift = np.concatenate(
        [new_bases[:-1] - old_bases[:-1], [new_bases[-1] - old_bases[-1]]]
    )
    out = li + shift[np.minimum(block, len(old_caps))]
    out[li == old_zero] = new_zero  # zero-row marker moves with the layout
    return b_idx, b_wgt, hub_idx, hub_wgt, hub_seg, new_nh, out.astype(np.int32)


def ell_from_coo(
    src,
    dst,
    w_norm,
    dangling,
    num_nodes: int,
    node_cap: int,
    bucket_widths=DEFAULT_BUCKET_WIDTHS,
    hub_width: int = 512,
    row_multiple: int = 128,
    min_caps: dict | None = None,
) -> ELLGraph:
    """Host-side conversion from dst-sorted COO (numpy) to an ELLGraph of
    CPU tensors (move it with ``.to(device)``).

    Padded COO entries (w_norm == 0) are dropped. Per-bucket idx/wgt
    arrays are padded to the bucket width with weight-0 entries, row counts
    round up to ``row_multiple``, and ``min_caps`` (from ``ell_caps`` of the
    previous build) pins every cap to at least its previous value.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    w_norm = np.asarray(w_norm, dtype=np.float32)
    real = w_norm != 0
    src, dst, w_norm = src[real], dst[real], w_norm[real]
    widths = sorted(bucket_widths)

    validate_symmetric_operator(src, dst, dangling, node_cap, "ell_from_coo")

    indeg = np.zeros(node_cap, dtype=np.int64)
    np.add.at(indeg, dst, 1)
    # dst-sorted: row ranges via cumsum
    starts = np.zeros(node_cap + 1, dtype=np.int64)
    np.cumsum(indeg, out=starts[1:])

    prev = 0
    bucket_node_arrays = []
    for wd in widths:
        bucket_node_arrays.append(
            np.nonzero((indeg > prev) & (indeg <= wd))[0].astype(np.int32)
        )
        prev = wd
    hub_nodes = np.nonzero(indeg > widths[-1])[0].astype(np.int32)

    def _cap(n: int) -> int:
        return ((n + row_multiple - 1) // row_multiple) * row_multiple if n else 0

    b_idx, b_wgt = [], []
    for nodes, wd in zip(bucket_node_arrays, widths):
        idx, wgt = pack_ell_rows(src, w_norm, indeg, starts, nodes, wd)
        cap = _cap(len(nodes))
        if cap > len(nodes):
            idx = np.pad(idx, ((0, cap - len(nodes)), (0, 0)))
            wgt = np.pad(wgt, ((0, cap - len(nodes)), (0, 0)))
        b_idx.append(idx)
        b_wgt.append(wgt)

    # hubs: ragged chunk rows [R, W_hub] + per-row hub id
    n_hub = len(hub_nodes)
    hub_idx, hub_wgt, hub_seg = pack_hub_chunks(
        src, w_norm, indeg, starts, hub_nodes, hub_width
    )
    r_cap = _cap(hub_idx.shape[0]) if hub_idx.shape[0] else 0
    n_hub_cap = ((n_hub + 127) // 128) * 128 if n_hub else 0
    if r_cap > hub_idx.shape[0]:
        pad = r_cap - hub_idx.shape[0]
        hub_idx = np.pad(hub_idx, ((0, pad), (0, 0)))
        hub_wgt = np.pad(hub_wgt, ((0, pad), (0, 0)))
        hub_seg = np.pad(hub_seg, (0, pad), constant_values=n_hub_cap)

    # local_inv: node -> row in concat(parts); layout = bucket row blocks,
    # hub slots, then one guaranteed-zero row (zero-in-degree + padding)
    caps = [i.shape[0] for i in b_idx]
    zero_row = sum(caps) + n_hub_cap
    local_inv = np.full(node_cap, zero_row, dtype=np.int32)
    base = 0
    for nodes, cap in zip(bucket_node_arrays, caps):
        local_inv[nodes] = base + np.arange(len(nodes), dtype=np.int32)
        base += cap
    local_inv[hub_nodes] = base + np.arange(n_hub, dtype=np.int32)

    if min_caps:
        (b_idx, b_wgt, hub_idx, hub_wgt, hub_seg, n_hub_cap,
         local_inv) = _apply_min_caps(
            b_idx, b_wgt, hub_idx, hub_wgt, hub_seg, n_hub_cap, local_inv,
            min_caps,
        )
    caps = [i.shape[0] for i in b_idx]
    zero_row = sum(caps) + n_hub_cap
    # slot -> node inverse (zero/junk slots -> node_cap = appended zero row)
    slot_to_node = np.full(zero_row + 1, node_cap, dtype=np.int32)
    nodes = np.arange(node_cap, dtype=np.int32)
    live = local_inv != zero_row
    slot_to_node[local_inv[live]] = nodes[live]
    # remap gather indices from natural node ids to slot ids so the
    # iteration never leaves slot space
    dang = np.zeros(node_cap, dtype=np.float32)
    dang[: len(dangling)] = dangling
    t = torch.from_numpy
    return ELLGraph(
        bucket_idx=tuple(t(local_inv[i]) for i in b_idx),
        bucket_wgt=tuple(t(np.ascontiguousarray(w)) for w in b_wgt),
        hub_idx=t(local_inv[hub_idx]),
        hub_wgt=t(np.ascontiguousarray(hub_wgt)),
        hub_seg=t(np.asarray(hub_seg, np.int32)),
        hub_zero=torch.zeros(n_hub_cap, dtype=torch.float32),
        local_inv=t(local_inv),
        slot_to_node=t(slot_to_node),
        dangling=t(dang),
        num_nodes=torch.tensor(num_nodes, dtype=torch.int32),
    )


def ell_gathered_rows_per_iter(graph: ELLGraph) -> int:
    """Gathered [B]-rows per PPR iteration over this ELL operator (every ELL
    entry, width and row padding included, costs one gathered row)."""
    rows = sum(int(i.shape[0]) * int(i.shape[1]) for i in graph.bucket_idx)
    rows += int(graph.hub_idx.shape[0]) * int(graph.hub_idx.shape[1])
    return rows


# ======================================================================
# Solver
# ======================================================================
# Per-bucket gathered-intermediate budget: the [rows, W, B] gather of one
# bucket is reduced in WIDTH blocks past this many bytes (row chunks when
# one whole column exceeds it), bounding the temporary at any graph size.
_ELL_GATHER_BYTES = 2 << 30
# Max width blocks per bucket before falling back to row chunking.
_ELL_MAX_WIDTH_BLOCKS = 64


def _bucket_plan(nb: int, w: int, b: int, itemsize: int):
    """Returns ``("oneshot", None)``, ``("width", wc)`` with block width wc,
    or ``("rowchunk", chunk)`` with row-chunk size chunk. The width path is
    only legal when at least one whole column fits the budget."""
    if nb * w * b * itemsize <= _ELL_GATHER_BYTES or nb < 2:
        return "oneshot", None
    wc = _ELL_GATHER_BYTES // (nb * b * itemsize)
    if wc >= 1 and -(-w // wc) <= _ELL_MAX_WIDTH_BLOCKS:
        return "width", wc
    chunk = max(1, _ELL_GATHER_BYTES // (w * b * itemsize))
    return "rowchunk", chunk


def _bucket_reduce(p_g: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """[nb, W] rows -> [nb, B] float32; width-blocked when the gather would be huge.

    Products are formed in float32 from the gather dtype (bfloat16 values
    are exact in float32) and accumulated in float32.
    """
    nb, w = idx.shape
    b = p_g.shape[1]

    def reduce_rows(i, g):
        return torch.einsum(
            "nwb,nw->nb", p_g[i].float(), g.to(p_g.dtype).float()
        )

    path, param = _bucket_plan(nb, w, b, p_g.element_size())
    if path == "oneshot":
        return reduce_rows(idx, wgt)
    if path == "width":
        out = reduce_rows(idx[:, :param], wgt[:, :param])
        for j in range(param, w, param):
            out = out + reduce_rows(idx[:, j:j + param], wgt[:, j:j + param])
        return out
    return torch.cat([
        reduce_rows(idx[s:s + param], wgt[s:s + param])
        for s in range(0, nb, param)
    ])


def _hub_rows(graph: ELLGraph) -> torch.Tensor:
    """[n_hub_cap, max_chunks] rows of the hub partial sums per hub slot
    (:func:`hub_row_map` of the graph's ``hub_seg``)."""
    return hub_row_map(graph.hub_seg, graph.hub_zero.shape[0])


def hub_row_map(hub_seg: torch.Tensor, n_hub_cap: int) -> torch.Tensor:
    """[n_hub_cap, max_chunks] rows of the hub partial sums per hub slot.

    ``hub_seg`` is sorted, so hub h owns a contiguous run of chunk rows;
    missing entries point at row Rcap, a zero row appended to the partials.
    Summing this padded gather along dim 1 is the deterministic, fixed-order
    replacement for the JAX sorted ``segment_sum``; segment ids at or past
    ``n_hub_cap`` (padding rows) are dropped.
    """
    r = hub_seg.shape[0]
    seg = hub_seg.long()
    counts = torch.bincount(seg, minlength=n_hub_cap + 1)[:n_hub_cap]
    starts = torch.cumsum(counts, 0) - counts
    width = max(int(counts.max()) if n_hub_cap else 0, 1)
    j = torch.arange(width, device=seg.device)
    rows = starts[:, None] + j[None, :]
    return torch.where(j[None, :] < counts[:, None], rows, torch.full_like(rows, r))


def _spmv_ell(graph: ELLGraph, p_slot: torch.Tensor, hub_rows: torch.Tensor,
              gather_dtype=None) -> torch.Tensor:
    """y_slot[S, B] = T @ p in SLOT space: per-bucket gather + reduce.

    Input and output live in the concatenated bucket/hub slot layout; junk
    capacity rows have all weights 0 and produce 0. ``hub_rows`` comes from
    ``_hub_rows`` (computed once per solve).
    """
    p_g = p_slot.to(gather_dtype) if gather_dtype is not None else p_slot
    b = p_slot.shape[1]
    parts = [
        _bucket_reduce(p_g, idx, wgt)
        for idx, wgt in zip(graph.bucket_idx, graph.bucket_wgt)
    ]
    if graph.hub_zero.shape[0]:
        partial = _bucket_reduce(p_g, graph.hub_idx, graph.hub_wgt)  # [Rcap, B]
        partial = torch.cat([partial, partial.new_zeros(1, b)])
        parts.append(partial[hub_rows].sum(1))
    parts.append(p_slot.new_zeros(1, b, dtype=torch.float32))
    return torch.cat(parts)


# ======================================================================
# The step kernel (K2, csrc/ell_ppr_step.cu)
# ======================================================================
# Entries one work item of the step kernel reduces at most: its schedule's
# grain (the kernel takes items of any length).
_ELL_SEGMENT = 32
# Query columns of one kernel step (the kernel's MAX_LD; = the batch tile).
_ELL_STEP_MAX_COLUMNS = 128

ELL_STEP_LAUNCHES = LaunchCounter()


class ELLStepPlan(NamedTuple):
    """The ELL operator as the step kernel reads it (``build_ell_plan``).

    ``ent`` holds every entry up to each row's last nonzero weight (the
    zero-weight padding after it adds nothing): bucket rows in slot order,
    then the hub chunk rows in ``hub_seg`` order. A slot whose entries make
    at most ``_ELL_SEGMENT`` is one work item that finishes it; a wider slot
    (wide bucket rows, every hub) is cut into items of at most that many
    entries, each writing one partial row, and ``multi`` sums a slot's
    partial rows in item order. Items are sorted heaviest first (stable).
    """

    ent: torch.Tensor  # [E, 2] int32: (source slot, float32 weight bits)
    items: torch.Tensor  # [n_items, 4] int32: (slot, first entry, entries, partial row or -1)
    multi: torch.Tensor  # [n_multi, 4] int32: (slot, first partial row, partial rows, 0)
    n_parts: int
    n_slots: int


def _row_lengths(wgt: np.ndarray) -> np.ndarray:
    """Entries of each [rows, W] row up to and including its last nonzero weight."""
    if wgt.shape[0] == 0 or wgt.shape[1] == 0:
        return np.zeros(wgt.shape[0], np.int64)
    nz = wgt != 0
    last = wgt.shape[1] - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(1), last, 0).astype(np.int64)


def build_ell_plan(graph: ELLGraph) -> ELLStepPlan:
    """The step kernel's plan of ``graph`` (host NumPy, once per graph), as
    tensors on the graph's device. Every slot row is finished by exactly
    one item (single) or one ``multi`` row; rows with no entries (capacity
    rows, unused hub slots, the zero row) are items of 0 entries."""
    def host(t):
        return t.detach().cpu().numpy()

    n_slots = int(graph.slot_to_node.shape[0])
    n_hub_cap = int(graph.hub_zero.shape[0])
    slots, idx_blocks, wgt_blocks = [], [], []
    base = 0
    for idx, wgt in zip(graph.bucket_idx, graph.bucket_wgt):
        slots.append(base + np.arange(idx.shape[0], dtype=np.int64))
        idx_blocks.append(host(idx))
        wgt_blocks.append(host(wgt))
        base += int(idx.shape[0])
    hub_seg = host(graph.hub_seg).astype(np.int64)
    live = hub_seg < n_hub_cap  # pad chunk rows point past the hub slots
    slots.append(base + hub_seg[live])
    idx_blocks.append(host(graph.hub_idx)[live])
    wgt_blocks.append(host(graph.hub_wgt)[live])

    row_slot = np.concatenate(slots)
    if np.any(np.diff(row_slot) < 0):
        raise ValueError("build_ell_plan: hub_seg must be sorted")
    row_len = np.concatenate([_row_lengths(w) for w in wgt_blocks])
    keep = [np.arange(i.shape[1]) < n[:, None] for i, n in
            zip(idx_blocks, np.split(row_len, np.cumsum([i.shape[0] for i in idx_blocks])[:-1]))]
    ent_idx = np.concatenate([i[k] for i, k in zip(idx_blocks, keep)]).astype(np.int32)
    ent_wgt = np.concatenate([w[k] for w, k in zip(wgt_blocks, keep)]).astype(np.float32)
    if len(ent_idx) >= 2**31 or n_slots >= 2**31:
        raise ValueError("build_ell_plan: the kernel indexes entries and slots with int32")

    # items of at most _ELL_SEGMENT entries, in row order
    segment = _ELL_SEGMENT
    row_beg = np.cumsum(row_len) - row_len
    n_seg = -(-row_len // segment)
    seg_row = np.repeat(np.arange(len(row_len)), n_seg)
    k = np.arange(len(seg_row)) - np.repeat(np.cumsum(n_seg) - n_seg, n_seg)
    seg_slot = row_slot[seg_row]
    seg_beg = row_beg[seg_row] + k * segment
    seg_len = np.minimum(row_len[seg_row] - k * segment, segment)
    slot_segs = np.bincount(seg_slot, minlength=n_slots)
    wide = slot_segs[seg_slot] > 1
    part = np.full(len(seg_row), -1, dtype=np.int64)
    part[wide] = np.arange(int(wide.sum()))
    # rows come grouped by slot in ascending order, so a wide slot's
    # partial rows are consecutive and in item order
    m_slot = np.nonzero(slot_segs > 1)[0]
    m_count = slot_segs[m_slot]
    m_first = np.cumsum(m_count) - m_count
    empty = np.nonzero(slot_segs == 0)[0]
    zeros = np.zeros(len(empty), np.int64)
    items = np.stack([
        np.concatenate([seg_slot, empty]), np.concatenate([seg_beg, zeros]),
        np.concatenate([seg_len, zeros]), np.concatenate([part, zeros - 1]),
    ], axis=1)
    items = items[np.argsort(-items[:, 2], kind="stable")]
    multi = np.stack([m_slot, m_first, m_count, np.zeros_like(m_slot)], axis=1)

    dev = graph.slot_to_node.device
    ent = np.stack([ent_idx, ent_wgt.view(np.int32)], axis=1)
    return ELLStepPlan(
        ent=torch.from_numpy(np.ascontiguousarray(ent)).to(dev),
        items=torch.from_numpy(items.astype(np.int32)).to(dev),
        multi=torch.from_numpy(multi.astype(np.int32).reshape(-1, 4)).to(dev),
        n_parts=int(wide.sum()),
        n_slots=n_slots,
    )


_plans: dict = {}
_plans_lock = threading.Lock()


def _graph_tensors(graph: ELLGraph):
    return [*graph.bucket_idx, *graph.bucket_wgt, graph.hub_idx, graph.hub_wgt, graph.hub_seg,
            graph.hub_zero, graph.slot_to_node]


def ell_plan(graph: ELLGraph) -> ELLStepPlan:
    """``build_ell_plan(graph)``, built on first use and kept while the
    graph's tensors live: keyed by their identity, dropped when any of them
    is freed. The first solve on the card builds it; a caller's warm-up
    call does so in set-up."""
    tensors = _graph_tensors(graph)
    key = tuple(id(t) for t in tensors)
    with _plans_lock:
        plan = _plans.get(key)
    if plan is not None:
        return plan
    plan = build_ell_plan(graph)
    with _plans_lock:
        if key not in _plans:
            _plans[key] = plan
            for t in tensors:
                weakref.finalize(t, _plans.pop, key, None)
        return _plans[key]


def check_step_args(plan: ELLStepPlan, pg, p, r, c, rdm, p_next, pg_next, c_next, partials, resid) -> None:
    """Raise unless the step kernel takes these operands (device aside)."""
    f32 = torch.float32
    named = dict(p=p, r=r, c=c, rdm=rdm, p_next=p_next, c_next=c_next, partials=partials, resid=resid)
    for name, t in named.items():
        if t.dtype != f32:
            raise TypeError(f"ell_step: {name} must be float32, got {t.dtype}")
    if pg.dtype not in (f32, torch.bfloat16):
        raise TypeError(f"ell_step: the gathered state must be float32 or bfloat16, got {pg.dtype}")
    if (pg_next is None) != (pg.dtype == f32) or (pg_next is not None and pg_next.dtype != pg.dtype):
        raise TypeError("ell_step: a bfloat16 gathered state needs a bfloat16 pg_next, a float32 one none")
    for name, t in (("ent", plan.ent), ("items", plan.items), ("multi", plan.multi)):
        if t.dtype != torch.int32:
            raise TypeError(f"ell_step: the plan's {name} must be int32, got {t.dtype}")
    if p.dim() != 2:
        raise ValueError(f"ell_step: the state must be [S, ld], got {tuple(p.shape)}")
    s, ld = p.shape
    b = c.numel()
    if s != plan.n_slots or ld % 4 or not 0 < b <= ld <= _ELL_STEP_MAX_COLUMNS:
        raise ValueError(
            f"ell_step: state [{s}, {ld}] with b = {b} columns; the kernel needs S = {plan.n_slots}, "
            f"ld % 4 == 0 and 0 < b <= ld <= {_ELL_STEP_MAX_COLUMNS}"
        )
    rows = dict(pg=pg, r=r, p_next=p_next, **({"pg_next": pg_next} if pg_next is not None else {}))
    for name, t in rows.items():
        if tuple(t.shape) != (s, ld):
            raise ValueError(f"ell_step: {name} is {tuple(t.shape)}, want {(s, ld)}")
    for name, t in (("rdm", rdm), ("c_next", c_next)):
        if t.numel() != b:
            raise ValueError(f"ell_step: {name} has {t.numel()} columns, c has {b}")
    if tuple(partials.shape) != (plan.n_parts, ld) or resid.numel() != 1:
        raise ValueError(f"ell_step: partials {tuple(partials.shape)} (want {(plan.n_parts, ld)}) "
                         f"or resid of {resid.numel()} elements (want 1)")
    if (plan.ent.dim() != 2 or plan.ent.shape[1] != 2 or plan.items.dim() != 2 or plan.items.shape[1] != 4
            or plan.multi.dim() != 2 or plan.multi.shape[1] != 4):
        raise ValueError("ell_step: the plan's tables must be [E, 2], [n_items, 4] and [n_multi, 4]")
    everything = dict(named, pg=pg, ent=plan.ent, items=plan.items, multi=plan.multi,
                      **({"pg_next": pg_next} if pg_next is not None else {}))
    for name, t in everything.items():
        if not t.is_contiguous():
            raise ValueError(f"ell_step: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"ell_step: {name} must be 16-byte aligned")


def ell_step(plan: ELLStepPlan, pg, p, r, c, rdm, damping, p_next, pg_next, c_next, partials, resid) -> None:
    """One power step of the K2 kernel into the given outputs.

    ``pg`` is the state the gathers read: ``p`` itself, or its bfloat16
    copy, in which case the weights are rounded to bfloat16 too (as in
    ``_bucket_reduce``) and the kernel writes ``p_next``'s copy into
    ``pg_next``. ``p``, ``r`` are [S, ld], ``c``, ``rdm`` [b] with
    b <= ld; columns past b come out 0 and stay out of ``resid``, the
    step's max of |p_next - p| and |c_next - c|. ``partials`` is scratch.
    Every operand is on one CUDA device; each launch counts in
    ``ELL_STEP_LAUNCHES``.
    """
    operands = [pg, p, r, c, rdm, p_next, c_next, partials, resid, plan.ent, plan.items, plan.multi]
    if pg_next is not None:
        operands.append(pg_next)
    if p.device.type != "cuda" or any(t.device != p.device for t in operands):
        raise ValueError("ell_step: every operand must be on one CUDA device")
    check_step_args(plan, pg, p, r, c, rdm, p_next, pg_next, c_next, partials, resid)
    d = np.float32(damping)
    with torch.cuda.device(p.device):  # the kernel launches on the current device
        err = _step_fn()(
            plan.ent.data_ptr(), plan.items.data_ptr(), plan.multi.data_ptr(),
            pg.data_ptr(), int(pg.dtype == torch.bfloat16), p.data_ptr(), r.data_ptr(),
            c.data_ptr(), rdm.data_ptr(), p_next.data_ptr(),
            pg_next.data_ptr() if pg_next is not None else None,
            c_next.data_ptr(), partials.data_ptr(), resid.data_ptr(),
            plan.items.shape[0], plan.multi.shape[0], c.numel(), p.shape[1],
            float(d), float(np.float32(1.0) - d), torch.cuda.current_stream(p.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ell_ppr_step kernel launch failed: CUDA error {err}")
    ELL_STEP_LAUNCHES.add()


def _step_fn():
    lib = load("ell_ppr_step")
    fn = lib.ell_ppr_step
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 9
            + [ctypes.c_int64] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


class _KernelStep:
    """The K2 step of one column tile, ``(p, c) -> (p_next, c_next)``, with
    the step's residual left in ``resid`` (a device scalar).

    The tile's columns are padded to a multiple of 4 (zeros, masked inside
    the kernel): ``r`` is the padded reset, and the states it steps are
    [S, ld]. With bfloat16 gathers the kernel writes each output's
    bfloat16 copy, which the next step reads; any other state is converted.
    """

    def __init__(self, plan, r_slot, rdm, damping, gather_dtype):
        b = r_slot.shape[1]
        ld = -(-b // 4) * 4
        self.plan, self.damping = plan, damping
        self.r = r_slot.contiguous() if ld == b else torch.nn.functional.pad(r_slot, (0, ld - b))
        self.rdm = rdm.reshape(-1).contiguous()
        self.partials = self.r.new_empty(plan.n_parts, ld)
        self.resid = self.r.new_empty(1)
        self.bf16 = gather_dtype == torch.bfloat16
        self._copies = [(self.r, self.r.to(torch.bfloat16))] if self.bf16 else []

    def _gathered(self, p):
        if not self.bf16:
            return p
        for state, copy in self._copies:
            if state is p:
                return copy
        return p.to(torch.bfloat16)

    def __call__(self, p, c):
        pg = self._gathered(p)
        p_next, c_next = torch.empty_like(p), torch.empty_like(c)
        pg_next = torch.empty_like(pg) if self.bf16 else None
        ell_step(self.plan, pg, p, self.r, c, self.rdm, self.damping, p_next, pg_next, c_next,
                 self.partials, self.resid)
        if self.bf16:
            self._copies = [(self.r, self._copies[0][1]), (p_next, pg_next)]
        return p_next, c_next


def _stalled(err, err_prev, tol, damping) -> bool:
    """True when the residual has hit its floating-point floor: it stopped
    improving (ratio >= max(0.995, (1+d)/2)) while already within 100x of
    tol. Evaluated in float32 on the host, as the JAX loop condition does."""
    f32 = np.float32
    factor = np.maximum(f32(0.995), f32(0.5) * (f32(1.0) + f32(damping)))
    return bool(err >= factor * err_prev and err < f32(tol) * f32(100.0))


def _stalled2(err, err_prev, err_prev2, tol, damping) -> bool:
    """Two consecutive stalls (what the solver loop uses): filters a single
    transient ratio >= (1+d)/2 inside the 100x-tol window."""
    return _stalled(err, err_prev, tol, damping) and _stalled(
        err_prev, err_prev2, tol, damping
    )


def _count_tile(iterations: int) -> None:
    """Count one solved column tile and its iterations on the open span."""
    count("tiles")
    count("iterations", iterations)


# Batch-axis tile: 128 query columns per solve, each tile with its own
# early-exit loop so one slow-converging query only delays its own tile.
# Kept equal to the JAX package's tile so per-tile iteration counts compare.
_PPR_BATCH_TILE = 128


def tile_columns(solve_fn, r_slot, rdm):
    """Run ``solve_fn(r_slot, rdm) -> tuple of [*, b] tensors`` on sequential
    ``_PPR_BATCH_TILE``-wide column tiles and concatenate along the batch.

    ``r_slot`` and ``rdm`` are tensors, or lists of tensors with one column
    count (one per shard of a sharded solve, which then tiles all shards in
    lockstep); the outputs of ``solve_fn`` follow the same form.

    Past one tile the batch is zero-padded to whole tiles, as in the JAX
    package: a padded column's coefficient c still moves 1 -> 1-d in the
    first step, which enters its tile's residual, so padding keeps the
    per-tile iteration counts equal to the reference's.
    """
    def each(fn, x):
        return [fn(t) for t in x] if isinstance(x, list) else fn(x)

    b = (r_slot[0] if isinstance(r_slot, list) else r_slot).shape[1]
    if b <= _PPR_BATCH_TILE:
        return solve_fn(r_slot, rdm)
    pad = -b % _PPR_BATCH_TILE
    r_slot = each(lambda t: torch.nn.functional.pad(t, (0, pad)), r_slot)
    rdm = each(lambda t: torch.nn.functional.pad(t, (0, pad)), rdm)
    outs = [
        solve_fn(each(lambda t: t[:, s:s + _PPR_BATCH_TILE].contiguous(), r_slot),
                 each(lambda t: t[:, s:s + _PPR_BATCH_TILE], rdm))
        for s in range(0, b + pad, _PPR_BATCH_TILE)
    ]

    def join(parts):
        if isinstance(parts[0], list):
            return [torch.cat(p, dim=1)[:, :b] for p in zip(*parts)]
        return torch.cat(parts, dim=1)[:, :b]

    return tuple(join(o) for o in zip(*outs))


def batched_ppr_ell(
    graph: ELLGraph,
    reset: torch.Tensor,
    damping: float = 0.5,
    max_iters: int = 64,
    tol: float = 1.0e-8,
    compute_dtype: str | None = None,
    accel: str = "power",
    return_iters: bool = False,
):
    """Run PPR for a batch of reset vectors [B, N_pad] over the ELL operator.

    Returns [B, N_pad] stationary probabilities, or ``(p, iters)`` with
    ``return_iters=True`` where ``iters`` is the per-query iteration count
    ([B] int32; columns of one 128-column tile share a count).

    The iteration runs in slot space: reset is permuted in once, the result
    permuted out once. Zero-in-degree nodes are carried by the scalar
    coefficient c: p_k[v] = c_k·r[v] with c_{k+1} = (1-d) + d·c_k·R_d
    (R_d = reset mass on dangling nodes).

    ``accel="chebyshev"`` runs the Chebyshev semi-iteration for the same
    fixed point (the spectral radius of d·T is at most d): ω₁ = 1/(1 − d²/2),
    then ω ← 1/(1 − d²/4 · ω). Its residual is not monotone, so it has no
    stall exit and runs to ``tol`` or ``max_iters``; the residual is taken
    over both the slot states and c.
    """
    if accel not in ("power", "chebyshev"):
        raise ValueError(f"unknown PPR accel {accel!r}")
    gather_dtype = _gather_dtype(compute_dtype)
    dev = reset.device
    r = _normalized_reset(reset, graph.num_nodes.to(dev))

    r_T = r.T.contiguous()  # [N, B] natural order
    d = torch.tensor(damping, dtype=torch.float32, device=dev)
    one_minus_d = 1.0 - d

    # into slot space: one [S]-row gather (junk slots read the appended zero
    # row), plus the dangling reset mass per batch column
    r_ext = torch.cat([r_T, r_T.new_zeros(1, r_T.shape[1])])
    r_slot = r_ext[graph.slot_to_node]  # [S, B]
    reset_dangling_mass = (r_T * graph.dangling[:, None]).sum(0, keepdim=True)
    kernel = dev.type == "cuda"  # K2 steps every tile on the card
    if kernel:
        plan = ell_plan(graph)
    else:
        hub_rows = _hub_rows(graph)

    def residual(x_next, x, c_next, c):
        err = torch.maximum((x_next - x).abs().amax(), (c_next - c).abs().amax())
        return np.float32(err.item())

    def _solve(r_slot, rdm):
        """While-loop solve for one [S, b<=tile] column block."""
        b = r_slot.shape[1]
        if kernel:
            step = _KernelStep(plan, r_slot, rdm, damping, gather_dtype)
            r_slot = step.r

            def step_err(p_slot, c):
                p_next, c_next = step(p_slot, c)
                return p_next, c_next, np.float32(step.resid.item())
        else:
            def step(p_slot, c):
                y = _spmv_ell(graph, p_slot, hub_rows, gather_dtype)
                dm = c * rdm
                p_next = one_minus_d * r_slot + d * (y + dm * r_slot)
                c_next = one_minus_d + d * dm
                return p_next, c_next

            def step_err(p_slot, c):
                p_next, c_next = step(p_slot, c)
                return p_next, c_next, residual(p_next, p_slot, c_next, c)

        one = torch.ones_like(rdm)
        if accel == "chebyshev":
            rho2 = d * d
            x_prev, c_prev = r_slot, one
            p_slot, c = step(x_prev, c_prev)
            omega = 1.0 / (1.0 - rho2 / 2.0)
            err, it = np.float32(np.inf), 1
            while err > np.float32(tol) and it < max_iters:
                sx, sc = step(p_slot, c)
                x_next = omega * (sx - x_prev) + x_prev
                c_next = omega * (sc - c_prev) + c_prev
                err = residual(x_next, p_slot, c_next, c)
                omega = 1.0 / (1.0 - rho2 / 4.0 * omega)
                x_prev, c_prev, p_slot, c = p_slot, c, x_next, c_next
                it += 1
        else:
            p_slot, c = r_slot, one
            inf = np.float32(np.inf)
            err_prev2 = err_prev = err = inf
            it = 0
            while (
                err > np.float32(tol)
                and it < max_iters
                and not _stalled2(err, err_prev, err_prev2, tol, damping)
            ):
                p_next, c_next, err_next = step_err(p_slot, c)
                p_slot, c = p_next, c_next
                err_prev2, err_prev, err = err_prev, err, err_next
                it += 1
        _count_tile(it)
        count("kernel_iterations", it if kernel else 0)
        it_row = torch.full((1, b), it, dtype=torch.int32, device=dev)
        return p_slot[:, :b], c, it_row

    p_slot, c, it_row = tile_columns(_solve, r_slot, reset_dangling_mass)

    # back to natural order: slots for live nodes, c·r for zero-in-degree
    zero_row = graph.slot_to_node.shape[0] - 1
    p_T = torch.where(
        (graph.local_inv == zero_row)[:, None], c * r_T, p_slot[graph.local_inv]
    )
    if return_iters:
        return p_T.T, it_row[0]
    return p_T.T


def _gather_dtype(compute_dtype):
    if compute_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unsupported PPR compute_dtype {compute_dtype!r}")
    return torch.bfloat16 if compute_dtype == "bfloat16" else None


def _normalized_reset(reset: torch.Tensor, num_nodes: torch.Tensor) -> torch.Tensor:
    """Negatives and NaNs to 0, rows L1-normalized; an all-zero row becomes
    uniform over the real nodes (igraph's reset when none is given)."""
    reset = torch.clamp_min(reset, 0.0)
    reset = torch.where(torch.isnan(reset), torch.zeros_like(reset), reset)
    row_sum = reset.sum(dim=1, keepdim=True)
    n_real = torch.clamp_min(num_nodes, 1).to(reset.dtype)
    node_ids = torch.arange(reset.shape[1], device=reset.device)[None, :]
    uniform = torch.where(node_ids < num_nodes, 1.0 / n_real, 0.0)
    safe_sum = torch.where(row_sum > 0, row_sum, torch.ones_like(row_sum))
    return torch.where(row_sum > 0, reset / safe_sum, uniform)


# ======================================================================
# COO solver
# ======================================================================
def _edge_chunks(graph: COOGraph, n: int, edge_chunks: int = 1):
    """Contiguous slices of the dst-sorted edge list, each as (src, w_norm,
    segment lengths [n]). Past one chunk the list is padded to whole
    chunks with weight-0 edges from node 0 to the last node, which keeps
    every chunk dst-sorted. The lengths come from dst row pointers.

    Trailing weight-0 entries (capacity padding, all on the last row) add
    nothing and are dropped first: left in, they would make the last row's
    segment as long as the padding, and one thread sums a segment alone."""
    src, dst, w = graph.src, graph.dst, graph.w_norm
    nonzero = torch.nonzero(w)
    live = int(nonzero[-1]) + 1 if len(nonzero) else min(1, w.shape[0])
    src, dst, w = src[:live], dst[:live], w[:live]
    chunks = max(1, edge_chunks)
    if chunks > 1:
        e = src.shape[0]
        pad = -(-e // chunks) * chunks - e
        src = torch.nn.functional.pad(src, (0, pad))
        dst = torch.nn.functional.pad(dst, (0, pad), value=n - 1)
        w = torch.nn.functional.pad(w, (0, pad))
    bounds = torch.arange(n + 1, dtype=dst.dtype, device=dst.device)
    out = []
    for s, d, wc in zip(src.chunk(chunks), dst.chunk(chunks), w.chunk(chunks)):
        out.append((s, wc, torch.diff(torch.searchsorted(d, bounds))))
    return out


def _spmv_T(graph: COOGraph, p_T: torch.Tensor, gather_dtype=None, edge_chunks: int = 1,
            chunks=None) -> torch.Tensor:
    """y_T[N, B] = T @ p for all batch columns: y[dst] += w_norm * p[src].

    Products are formed in the gather dtype (bfloat16 halves the [E, B]
    gather) and summed in float32. ``edge_chunks > 1`` streams contiguous
    slices of the edge list, so only one [E/chunks, B] gathered block
    exists at once; the chunks' sums add in order. ``chunks`` is
    ``_edge_chunks``'s result, computed once per solve.
    """
    n = p_T.shape[0]
    p_g = p_T.to(gather_dtype) if gather_dtype is not None else p_T
    y = None
    for src, w, lengths in chunks if chunks is not None else _edge_chunks(graph, n, edge_chunks):
        g = p_g.index_select(0, src)
        g.mul_(w[:, None].to(p_g.dtype))
        part = torch.segment_reduce(g.float(), "sum", lengths=lengths, axis=0)
        y = part if y is None else y + part
    return y


def batched_ppr(
    graph: COOGraph,
    reset: torch.Tensor,
    damping: float = 0.5,
    max_iters: int = 64,
    tol: float = 1.0e-8,
    compute_dtype: str | None = None,
    edge_chunks: int = 1,
    return_iters: bool = False,
):
    """Run PPR for a batch of reset vectors [B, N] over the COO operator.

    ``graph`` holds tensors on the reset's device (``COOGraph.to``). Returns
    [B, N] stationary probabilities (rows sum to ~1 over real nodes), or
    ``(p, iters)`` with ``return_iters=True``, as ``batched_ppr_ell`` does.
    The COO operator may be directed: the dangling mass is summed over the
    state each iteration. Columns are solved in 128-wide tiles, each with
    its own early exit and stall exit.
    """
    gather_dtype = _gather_dtype(compute_dtype)
    dev = reset.device
    r_T = _normalized_reset(reset, graph.num_nodes.to(dev)).T.contiguous()  # [N, B]
    d = torch.tensor(damping, dtype=torch.float32, device=dev)
    one_minus_d = 1.0 - d
    chunks = _edge_chunks(graph, r_T.shape[0], edge_chunks)
    dangling = graph.dangling[:, None]

    def _solve(r_T, _unused):
        """While-loop solve for one [N, b<=tile] column block (the second
        argument only fits tile_columns' signature)."""
        p_T = r_T
        inf = np.float32(np.inf)
        err_prev2 = err_prev = err = inf
        it = 0
        while (
            err > np.float32(tol)
            and it < max_iters
            and not _stalled2(err, err_prev, err_prev2, tol, damping)
        ):
            y_T = _spmv_T(graph, p_T, gather_dtype, chunks=chunks)
            dangling_mass = (p_T * dangling).sum(0, keepdim=True)
            p_next = one_minus_d * r_T + d * (y_T + dangling_mass * r_T)
            err_next = np.float32((p_next - p_T).abs().amax().item())
            p_T = p_next
            err_prev2, err_prev, err = err_prev, err, err_next
            it += 1
        _count_tile(it)
        return p_T, torch.full((1, r_T.shape[1]), it, dtype=torch.int32, device=dev)

    p_T, it_row = tile_columns(_solve, r_T, r_T.new_zeros(1, r_T.shape[1]))
    if return_iters:
        return p_T.T, it_row[0]
    return p_T.T


def ppr_numpy_reference(
    num_nodes: int,
    edges,  # iterable of (u, v, w) undirected entries, already symmetric-expanded
    reset,  # [B, N]
    damping: float = 0.5,
    iters: int = 200,
):
    """Trusted dense NumPy implementation for parity tests (host-side).

    Builds the dense symmetric adjacency, normalizes rows, and iterates the
    same fixed point; the semantics are those of igraph/prpack for weighted
    undirected graphs.
    """
    A = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    for u, v, w in edges:
        A[u, v] += w
    strength = A.sum(axis=1)
    dangling = (strength == 0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        T = np.where(strength[:, None] > 0, A / np.maximum(strength, 1e-300)[:, None], 0.0)

    reset = np.asarray(reset, dtype=np.float64)
    reset = np.where(np.isnan(reset) | (reset < 0), 0.0, reset)
    rs = reset.sum(axis=1, keepdims=True)
    r = np.where(rs > 0, reset / np.where(rs > 0, rs, 1.0), 1.0 / num_nodes)

    p = r.copy()
    for _ in range(iters):
        y = p @ T  # y[b, v] = sum_u p[b, u] T[u, v]
        dm = (p * dangling).sum(axis=1, keepdims=True)
        p = (1 - damping) * r + damping * (y + dm * r)
    return p


# ======================================================================
# Capacity planning
# ======================================================================
def _ell_parts(graph: ELLGraph):
    """(idx, wgt) of every reduce of one SpMV: the buckets, then the hub rows."""
    parts = list(zip(graph.bucket_idx, graph.bucket_wgt))
    if graph.hub_idx.shape[0]:
        parts.append((graph.hub_idx, graph.hub_wgt))
    return parts


def _plan_temp_bytes(nb: int, w: int, b: int, itemsize: int) -> int:
    """Bytes of the largest gathered block ``_bucket_reduce`` forms."""
    path, param = _bucket_plan(nb, w, b, itemsize)
    if path == "oneshot":
        return nb * w * b * itemsize
    if path == "width":
        return nb * param * b * itemsize
    return param * w * b * itemsize


def ell_hbm_estimate(graph: ELLGraph, batch: int, itemsize: int = 4) -> dict:
    """Device-memory model of a ``batched_ppr_ell`` solve on the torch-op
    route (what batch fits?). The kernel route on the card forms no
    gathered block; its plan (``ell_plan``) holds 8 bytes per nonzero entry
    and 16 per work item. Byte counts:

    - ``operator_bytes``: every tensor of the ELLGraph (``tensor.nbytes``
      summed), int32 slot ids, float32 weights.
    - ``hub_rows_bytes``: the int64 [n_hub_cap, max chunks] row map that
      ``_hub_rows`` builds once per solve.
    - ``state_bytes``: live [S, b] float32 loop buffers per column tile:
      the state, its successor, the SpMV output, the slot reset, and one
      for the temporaries around the concatenation (5x).
    - ``gather_temp_bytes``: the largest gathered block of one reduce under
      ``_bucket_plan`` (``itemsize`` 2 for bfloat16 gathers), or the
      [n_hub_cap, max chunks, b] float32 gather of the hub partial sums.
    - ``io_bytes``: the natural-order reset and result ([B, N_pad] each).

    An estimate, to set beside ``torch.cuda.max_memory_allocated``.
    """
    f32 = 4
    tensors = [*graph.bucket_idx, *graph.bucket_wgt] + [
        getattr(graph, f) for f in ELLGraph._fields if f not in ("bucket_idx", "bucket_wgt")
    ]
    op_bytes = sum(t.nbytes for t in tensors)
    hub_rows = _hub_rows(graph)
    n_slots = int(graph.slot_to_node.shape[0])
    b_tile = min(batch, _PPR_BATCH_TILE)
    states = 5 * n_slots * b_tile * f32
    temp = max(
        [_plan_temp_bytes(int(i.shape[0]), int(i.shape[1]), b_tile, itemsize) for i, _ in _ell_parts(graph)]
        + [hub_rows.numel() * b_tile * f32]
    )
    io = 2 * batch * int(graph.local_inv.shape[0]) * f32
    total = op_bytes + hub_rows.nbytes + states + temp + io
    return {
        "operator_bytes": op_bytes,
        "hub_rows_bytes": hub_rows.nbytes,
        "state_bytes": states,
        "gather_temp_bytes": temp,
        "io_bytes": io,
        "total_bytes": total,
        "total_gib": round(total / 2**30, 2),
    }


def bucket_reduce_plan(graph: ELLGraph, batch: int, itemsize: int = 4):
    """Which reduce path each bucket (and the hub rows) takes at this batch
    size: "oneshot", "width xk" or "rowchunk xk", from the same
    ``_bucket_plan`` the solver runs. Pass the per-tile batch,
    ``min(batch, 128)``, and ``itemsize=2`` for bfloat16 gathers."""
    plan = []
    for idx, _ in _ell_parts(graph):
        nb, w = int(idx.shape[0]), int(idx.shape[1])
        path, param = _bucket_plan(nb, w, batch, itemsize)
        if path == "oneshot":
            plan.append(f"[{nb}x{w}] oneshot")
        elif path == "width":
            plan.append(f"[{nb}x{w}] width x{-(-w // param)}")
        else:
            plan.append(f"[{nb}x{w}] rowchunk x{-(-nb // param)}")
    return plan
