"""Mesh-sharded retrieval (port of ``hipporag_tpu/parallel/sharded.py``).

Scales the single-device pipeline across a ("dp", "corpus") mesh
(``parallel/mesh.py``), single-controller as the JAX package's
``shard_map`` programs are: one process runs every shard, and the
collectives of ``parallel/collectives.py`` move the data between them.

- **Sharded scoring**: fact/passage embedding rows live corpus-sharded;
  each shard scores its rows, the min-max statistics are reduced with
  pmin/pmax over the corpus axis, and per-shard top-k candidates are
  merged with an all_gather + a final top-k (distributed partial top-k).
- **Sharded PPR**: graph nodes are range-partitioned over the corpus axis;
  edges are partitioned by destination shard. The COO solver all-gathers
  the rank vector every iteration; the ELL solver exchanges only the
  boundary rows each shard's edges reference (halo exchange).

Query batches are split over ``dp``; no collective crosses the dp axis,
so each dp group runs its own early-exit loop over its own columns, while
the corpus shards of one group advance in lockstep. Every product runs
under :func:`~hipporag_tpu_torch.utils.precision.full_f32`.

The host builders (``shard_graph``, ``shard_graph_ell``) and the work and
memory models are the JAX package's NumPy code: their arrays and dicts
compare equal across the two packages. ``put_sharded_graph`` and
``put_sharded_ell`` replace each array by its per-device grid
``grid[g][c]`` (shard ``c``'s slice on mesh device ``(g, c)``, one copy
per distinct device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.pagerank import (
    COOGraph, _bucket_reduce, _count_tile, _edge_chunks, _spmv_T, _stalled2, hub_row_map,
    pack_ell_rows, pack_hub_chunks, tile_columns, validate_symmetric_operator,
)
from ..ops.scoring import batched_scores, topk_lower_index
from ..utils.logging import get_logger
from ..utils.precision import full_f32
from .collectives import all_gather, all_to_all, pmax, pmin, psum
from .mesh import Mesh, batch_sharded, corpus_sharded

logger = get_logger(__name__)


class ShardedGraph(NamedTuple):
    """Graph partitioned by destination-node shard.

    All arrays carry a leading shard axis of size C (the corpus axis):
      src:       [C, Es] global source ids
      dst_local: [C, Es] destination ids local to the shard
      w_norm:    [C, Es]
      dangling:  [C, Ns] per-shard dangling mask
      num_nodes: [] total real node count
      shard_nodes: Ns (python int; nodes per shard, padded)
    """

    src: np.ndarray
    dst_local: np.ndarray
    w_norm: np.ndarray
    dangling: np.ndarray
    num_nodes: np.ndarray
    shard_nodes: int


def shard_graph(graph: COOGraph, num_shards: int) -> ShardedGraph:
    """Partition a (host, numpy) COOGraph by destination shard."""
    src = np.asarray(graph.src)
    dst = np.asarray(graph.dst)
    w = np.asarray(graph.w_norm)
    dangling = np.asarray(graph.dangling)
    n_pad = dangling.shape[0]
    ns = -(-n_pad // num_shards)
    ns = ((ns + 127) // 128) * 128  # lane-aligned shard width

    per_shard = []
    for s in range(num_shards):
        lo, hi = s * ns, (s + 1) * ns
        mask = (dst >= lo) & (dst < hi) & (w != 0)
        per_shard.append((src[mask], dst[mask] - lo, w[mask]))
    es = max(1, max(len(x[0]) for x in per_shard))
    es = ((es + 1023) // 1024) * 1024

    src_a = np.zeros((num_shards, es), dtype=np.int32)
    dst_a = np.full((num_shards, es), ns - 1, dtype=np.int32)
    w_a = np.zeros((num_shards, es), dtype=np.float32)
    dang_a = np.zeros((num_shards, ns), dtype=np.float32)
    for s, (ss, dd, ww) in enumerate(per_shard):
        order = np.argsort(dd, kind="stable")
        src_a[s, : len(ss)] = ss[order]
        dst_a[s, : len(ss)] = dd[order]
        w_a[s, : len(ss)] = ww[order]
        lo, hi = s * ns, min((s + 1) * ns, n_pad)
        if hi > lo:
            dang_a[s, : hi - lo] = dangling[lo:hi]

    return ShardedGraph(
        src=src_a,
        dst_local=dst_a,
        w_norm=w_a,
        dangling=dang_a,
        num_nodes=np.asarray(graph.num_nodes, dtype=np.int32),
        shard_nodes=ns,
    )


def _place_shards(mesh: Mesh, arr) -> list:
    """A [C, ...] host array as ``grid[g][c]`` = ``arr[c]`` on device (g, c)."""
    arr = np.asarray(arr)
    if arr.shape[0] != mesh.corpus:
        raise ValueError(f"graph has {arr.shape[0]} shards, the mesh's corpus axis {mesh.corpus}")
    return [[blk[0] for blk in row] for row in corpus_sharded(mesh).place(arr)]


def put_sharded_graph(mesh: Mesh, sg: ShardedGraph) -> ShardedGraph:
    """Place the per-shard arrays on their corpus-axis devices."""
    return sg._replace(
        src=_place_shards(mesh, sg.src),
        dst_local=_place_shards(mesh, sg.dst_local),
        w_norm=_place_shards(mesh, sg.w_norm),
        dangling=_place_shards(mesh, sg.dangling),
        num_nodes=int(sg.num_nodes),
    )


# ---------------------------------------------------------------------------
# Sharded batched PPR: the per-dp-group runner both solvers share
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """``x`` rounded to float32 (exact as a torch scalar operand)."""
    return float(np.float32(x))


def _normalized_shards(r, num_nodes: int, ns: int) -> list:
    """The sharded reset cleaning of the JAX solvers: NaN -> 0, negatives
    -> 0, each row L1-normalized by its psum over shards; an all-zero row
    becomes uniform over the real nodes."""
    r = [torch.clamp_min(torch.nan_to_num(x, nan=0.0), 0.0) for x in r]
    total = psum([x.sum(1, keepdim=True) for x in r])
    n_real = torch.tensor(max(num_nodes, 1), dtype=torch.float32)
    out = []
    for c, (x, t) in enumerate(zip(r, total)):
        node_ids = c * ns + torch.arange(ns, device=x.device)[None, :]
        uniform = torch.where(node_ids < num_nodes, 1.0 / n_real.to(x.device), 0.0)
        out.append(torch.where(t > 0, x / torch.where(t > 0, t, 1.0), uniform))
    return out


def _err_item(errs) -> np.float32:
    """The pmax of per-shard residuals, read back with one host sync."""
    dev = errs[0].device
    return np.float32(torch.stack([e.to(dev) for e in errs]).amax().item())


def _run_groups(mesh: Mesh, reset: torch.Tensor, ns: int, solve_group, return_iters: bool):
    """Split reset [B, C·Ns] into dp row blocks and corpus column blocks,
    solve each dp group apart, and reassemble on the reset's device."""
    b, n_total = reset.shape
    if n_total != mesh.corpus * ns:
        raise ValueError(f"reset has {n_total} columns, the sharded graph {mesh.corpus} x {ns}")
    if b % mesh.dp:
        raise ValueError(f"batch {b} is not divisible by the dp axis ({mesh.dp})")
    lane = b // mesh.dp
    rows, iters = [], []
    with full_f32():
        for g in range(mesh.dp):
            blocks = [
                reset[g * lane:(g + 1) * lane, c * ns:(c + 1) * ns].to(mesh.devices[g, c])
                for c in range(mesh.corpus)
            ]
            p, it = solve_group(g, blocks)
            rows.append(torch.cat([x.to(reset.device) for x in p], dim=1))
            iters.append(it.to(reset.device))
    out = torch.cat(rows)
    return (out, torch.cat(iters)) if return_iters else out


def _power_loop(step, p, c, tol: float, max_iters: int, damping: float):
    """The stall-aware early-exit loop of the JAX ``while_loop``s over
    per-shard states; ``step(p, c) -> (p_next, c_next, errs)``."""
    inf = np.float32(np.inf)
    err_prev2 = err_prev = err = inf
    it = 0
    while (
        err > np.float32(tol)
        and it < max_iters
        and not _stalled2(err, err_prev, err_prev2, tol, damping)
    ):
        p, c, errs = step(p, c)
        err_prev2, err_prev, err = err_prev, err, _err_item(errs)
        it += 1
    _count_tile(it)
    return p, c, it


def make_sharded_ppr(mesh: Mesh, max_iters: int = 64, damping: float = 0.5, tol: float = 1e-8):
    """Build a sharded COO PPR: ``run(sg, reset) -> ranks`` [B, N_total].

    ``sg`` comes from ``put_sharded_graph``; N_total must equal C ·
    shard_nodes (the caller pads) and B must divide by dp. The result lies
    on the reset's device; ``run(..., return_iters=True)`` also returns the
    per-query iteration counts. Each iteration all-gathers the rank vector
    over the group's corpus shards and sums every shard's in-edges by
    destination row pointers (``torch.segment_reduce``), so a rerun is
    bit-identical.
    """
    d, one_minus_d = _f32(damping), _f32(np.float32(1.0) - np.float32(damping))

    def run(sg: ShardedGraph, reset: torch.Tensor, return_iters: bool = False):
        ns = sg.shard_nodes

        def solve_group(g, blocks):
            src, dst, w, dang = (getattr(sg, f)[g] for f in ("src", "dst_local", "w_norm", "dangling"))
            chunks = [_edge_chunks(COOGraph(s, t, x, None, None), ns) for s, t, x in zip(src, dst, w)]
            r_T = [x.T.contiguous() for x in _normalized_shards(blocks, sg.num_nodes, ns)]

            def _solve(r_t, _unused):
                def step(p, _c):
                    p_full = all_gather(p, axis=0)  # [N, b] per shard
                    dm = psum([(x * dg[:, None]).sum(0, keepdim=True) for x, dg in zip(p, dang)])
                    nxt, errs = [], []
                    for x, full, ch, r, m in zip(p, p_full, chunks, r_t, dm):
                        y = _spmv_T(None, full, chunks=ch)
                        x_next = one_minus_d * r + d * (y + m * r)
                        nxt.append(x_next)
                        errs.append((x_next - x).abs().amax())
                    return nxt, _c, errs

                p, _, it = _power_loop(step, r_t, None, tol, max_iters, damping)
                it_row = torch.full((1, r_t[0].shape[1]), it, dtype=torch.int32, device=r_t[0].device)
                return p, [it_row]

            p_T, it_row = tile_columns(_solve, r_T, [x.new_zeros(1, x.shape[1]) for x in r_T])
            return [x.T for x in p_T], it_row[0][0]

        return _run_groups(mesh, reset, ns, solve_group, return_iters)

    return run


# ---------------------------------------------------------------------------
# Sharded scoring + distributed top-k
# ---------------------------------------------------------------------------

def _norm_scores_group(qs, keys, valid_n: int, compute_dtype: str):
    """One dp group's per-shard products and DISTRIBUTED min-max
    normalization: the single copy of the normalization semantics (that of
    ``ops/scoring.min_max_normalize``, incl. the rng == 0 constant-row
    convention), shared by the top-k scorer and the DPR norm-scores path so
    fact scoring and passage seeding cannot disagree on one mesh. Returns
    per shard (norm [b, Nk/C] with invalid columns 0, valid mask)."""
    nk = keys[0].shape[0]
    raws = [batched_scores(q, k, compute_dtype) for q, k in zip(qs, keys)]
    valids = [
        (c * nk + torch.arange(nk, device=raw.device) < valid_n)[None, :]
        for c, raw in enumerate(raws)
    ]
    lo = pmin([torch.where(v, r, torch.inf).amin(1, keepdim=True) for r, v in zip(raws, valids)])
    hi = pmax([torch.where(v, r, -torch.inf).amax(1, keepdim=True) for r, v in zip(raws, valids)])
    norms = []
    for raw, v, l, h in zip(raws, valids, lo, hi):
        rng = h - l
        norm = torch.where(rng == 0, 1.0, (raw - l) / torch.where(rng == 0, 1.0, rng))
        norms.append(torch.where(v, norm, 0.0))
    return norms, valids


def _place_keys(mesh: Mesh, keys):
    """Corpus-sharded keys: a grid from ``corpus_sharded(mesh).place`` as
    is, or a [N, D] tensor / array placed now (N divisible by C)."""
    return keys if isinstance(keys, list) else corpus_sharded(mesh).place(keys)


def make_sharded_score_topk(mesh: Mesh, k: int, compute_dtype: str = "float32"):
    """Build a sharded scorer.

    ``run(queries [B, D], keys, valid_n)`` -> (normalized scores [B, N],
    top-k values [B, k], top-k global indices [B, k]), on the queries'
    device. Queries are split over dp (B divisible by dp), keys over the
    corpus axis (a placed grid or a [N, D] tensor). Each shard takes its
    local top-k, the candidates are gathered in shard order and merged with
    a second top-k; both stages send ties to the lower (global) index.
    """

    def run(queries: torch.Tensor, keys, valid_n):
        out_dev = queries.device
        with full_f32():
            qs, ks = batch_sharded(mesh).place(queries), _place_keys(mesh, keys)
            norms, vals, idxs = [], [], []
            for g in range(mesh.dp):
                norm, valid = _norm_scores_group(qs[g], ks[g], int(valid_n), compute_dtype)
                nk = ks[g][0].shape[0]
                k_local = min(k, nk)
                local = [topk_lower_index(torch.where(v, n, -torch.inf), k_local) for n, v in zip(norm, valid)]
                vals_all = all_gather([v for v, _ in local], axis=1)[0]
                gidx_all = all_gather([i + c * nk for c, (_, i) in enumerate(local)], axis=1)[0]
                # the merged candidate pool can be smaller than k on tiny shards
                v, merge_idx = topk_lower_index(vals_all, min(k, vals_all.shape[1]))
                norms.append(torch.cat([n.to(out_dev) for n in norm], dim=1))
                vals.append(v.to(out_dev))
                idxs.append(gidx_all.gather(1, merge_idx).to(out_dev))
        return torch.cat(norms), torch.cat(vals), torch.cat(idxs)

    return run


def make_sharded_norm_scores(mesh: Mesh, compute_dtype: str = "float32"):
    """Sharded normalized scoring WITHOUT the distributed top-k stage.

    The sharded analog of ops/scoring.batched_normalized_scores, for DPR
    passage seeding where the full [B, P] normalized matrix is needed:
    ``run(queries, keys, valid_n) -> norm [B, P]`` on the queries' device.
    """

    def run(queries: torch.Tensor, keys, valid_n):
        with full_f32():
            qs, ks = batch_sharded(mesh).place(queries), _place_keys(mesh, keys)
            rows = [
                torch.cat([n.to(queries.device) for n in _norm_scores_group(qs[g], ks[g], int(valid_n),
                                                                             compute_dtype)[0]], dim=1)
                for g in range(mesh.dp)
            ]
        return torch.cat(rows)

    return run


# ---------------------------------------------------------------------------
# Sharded scatter-free (bucketed-ELL) PPR
# ---------------------------------------------------------------------------

class ShardedELLGraph(NamedTuple):
    """Destination-sharded bucketed-ELL operator with HALO EXCHANGE.

    Every array carries a leading shard axis C. The graph must be the
    symmetric (undirected) transition operator: dst-partitioning then
    means each shard computes the full in-mass of its own nodes, so
    shard-local zero-in-degree equals global isolation.

    Each shard exchanges only the *boundary* rank rows its edges reference:

    - ``send_ids[t, s]`` holds the slot ids (in owner t's slot space) of the
      rows t must ship to shard s each iteration, padded to the static halo
      capacity H = max cut over all (t, s) pairs.
    - Per iteration: one [C, H, B] gather + ``all_to_all`` over the corpus
      axis, then the local SpMV reads from q = [own slots ; halo blocks].
      Bytes per iteration per device = C·H·B·4, scaling with the edge cut,
      not with N_total.

    The per-shard layout mirrors ops/pagerank.ELLGraph slot space: bucket
    and hub gather indices are q-space ids, the iteration state is the
    concatenated bucket/hub output, zero-in-degree nodes ride the shared
    scalar coefficient recurrence, and natural local order is restored once
    at the end through ``local_inv``.
    """

    bucket_idx: tuple  # per bucket: [C, nb_i, W_i] int32 q-space ids
    bucket_wgt: tuple  # per bucket: [C, nb_i, W_i] float32
    hub_idx: np.ndarray  # [C, R, W_hub] int32 q-space ids
    hub_wgt: np.ndarray  # [C, R, W_hub] float32
    hub_seg: np.ndarray  # [C, R] int32 (local hub row; padded rows -> n_hub slot)
    local_inv: np.ndarray  # [C, Ns] int32: local node -> slot
    slot_to_node: np.ndarray  # [C, S] int32: slot -> local node (junk -> Ns)
    send_ids: np.ndarray  # [C, C, H] int32: slot ids owner c ships to each peer
    dangling: np.ndarray  # [C, Ns]
    num_nodes: np.ndarray  # [] int32
    shard_nodes: int
    n_hub: int  # static hub slot count (max across shards)
    n_slots: int  # static per-shard slot count S (incl. zero row)
    halo_width: int  # static H: halo rows exchanged per (owner, peer) pair


def shard_graph_ell(
    graph: COOGraph,
    num_shards: int,
    bucket_widths=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 128, 256),
    hub_width: int = 512,
) -> ShardedELLGraph:
    """Partition a host COOGraph into per-shard halo-ELL structures (numpy).

    Logs the halo-exchange volume: bytes/iter/device = C·H·B·4 (vs
    Ns·C·B·4 for an all_gather of the rank vector).
    """
    src = np.asarray(graph.src)
    dst = np.asarray(graph.dst)
    w = np.asarray(graph.w_norm)
    dangling = np.asarray(graph.dangling)
    n_pad = dangling.shape[0]
    real_e = w != 0
    validate_symmetric_operator(
        src[real_e], dst[real_e], dangling, n_pad, "shard_graph_ell"
    )
    ns = -(-n_pad // num_shards)
    ns = ((ns + 127) // 128) * 128
    widths = sorted(bucket_widths)

    # ---- pass 1: halo lists. halo[s][t] = sorted unique global src ids
    # owned by t that appear in shard s's edges (t != s).
    owner_all = np.minimum(src // ns, num_shards - 1)
    halo: list[list[np.ndarray]] = []
    per_shard_edges = []
    for s in range(num_shards):
        lo, hi = s * ns, (s + 1) * ns
        mask = (dst >= lo) & (dst < hi) & (w != 0)
        ss, dd, ww = src[mask], (dst[mask] - lo).astype(np.int64), w[mask]
        order = np.argsort(dd, kind="stable")
        ss, dd, ww = ss[order], dd[order], ww[order]
        per_shard_edges.append((ss, dd, ww))
        owners = owner_all[mask][order]
        lists = []
        for t in range(num_shards):
            if t == s:
                lists.append(np.zeros(0, dtype=np.int64))
            else:
                lists.append(np.unique(ss[owners == t]))
        halo.append(lists)

    cut = sum(len(l) for ls in halo for l in ls)
    h_cap = max((len(l) for ls in halo for l in ls), default=0)
    h_cap = max(8, ((h_cap + 7) // 8) * 8)
    logger.info(
        "halo exchange: C=%d, H=%d, cut=%d boundary rows; "
        "bytes/iter/device = C*H*B*4 = %d*B vs all_gather %d*B",
        num_shards, h_cap, cut,
        num_shards * h_cap * 4, ns * num_shards * 4,
    )

    shards = []
    for s in range(num_shards):
        ss, dd, ww = per_shard_edges[s]
        indeg = np.zeros(ns, dtype=np.int64)
        np.add.at(indeg, dd, 1)
        starts = np.zeros(ns + 1, dtype=np.int64)
        np.cumsum(indeg, out=starts[1:])

        prev = 0
        b_nodes, b_idx, b_wgt = [], [], []
        for wd in widths:
            nodes = np.nonzero((indeg > prev) & (indeg <= wd))[0].astype(np.int32)
            prev = wd
            i_, w_ = pack_ell_rows(ss, ww, indeg, starts, nodes, wd)
            b_nodes.append(nodes)
            b_idx.append(i_)
            b_wgt.append(w_)
        hub_nodes = np.nonzero(indeg > widths[-1])[0].astype(np.int32)
        hidx, hwgt, hseg = pack_hub_chunks(ss, ww, indeg, starts, hub_nodes, hub_width)
        shards.append((b_nodes, b_idx, b_wgt, hub_nodes, hidx, hwgt, hseg))

    # pad per-bucket row counts / hub rows / hub count to the max over shards
    nb_max = [max(len(sh[0][i]) for sh in shards) for i in range(len(widths))]
    r_max = max(1, max(sh[4].shape[0] for sh in shards))
    nhub_max = max(1, max(len(sh[3]) for sh in shards))

    bucket_idx = tuple(
        np.zeros((num_shards, nb_max[i], widths[i]), dtype=np.int32)
        for i in range(len(widths))
    )
    bucket_wgt = tuple(
        np.zeros((num_shards, nb_max[i], widths[i]), dtype=np.float32)
        for i in range(len(widths))
    )
    hub_idx = np.zeros((num_shards, r_max, hub_width), dtype=np.int32)
    hub_wgt = np.zeros((num_shards, r_max, hub_width), dtype=np.float32)
    hub_seg = np.full((num_shards, r_max), nhub_max, dtype=np.int32)
    local_inv = np.zeros((num_shards, ns), dtype=np.int32)
    dang = np.zeros((num_shards, ns), dtype=np.float32)

    # concat(parts) layout per shard: bucket rows..., hub slots, one zero row
    zero_row = sum(nb_max) + nhub_max
    n_slots = zero_row + 1
    slot_to_node = np.full((num_shards, n_slots), ns, dtype=np.int32)
    send_ids = np.full((num_shards, num_shards, h_cap), zero_row, dtype=np.int32)

    for s, (b_nodes, b_idx, b_wgt, hub_nodes, hidx, hwgt, hseg) in enumerate(shards):
        local_inv[s, :] = zero_row
        base = 0
        for i in range(len(widths)):
            nb = len(b_nodes[i])
            bucket_idx[i][s, :nb] = b_idx[i]
            bucket_wgt[i][s, :nb] = b_wgt[i]
            local_inv[s, b_nodes[i]] = base + np.arange(nb)
            base += nb_max[i]
        hub_idx[s, : hidx.shape[0]] = hidx
        hub_wgt[s, : hwgt.shape[0]] = hwgt
        hub_seg[s, : len(hseg)] = hseg
        local_inv[s, hub_nodes] = base + np.arange(len(hub_nodes))
        live = local_inv[s] != zero_row
        slot_to_node[s, local_inv[s, live]] = np.nonzero(live)[0].astype(np.int32)
        lo, hi = s * ns, min((s + 1) * ns, n_pad)
        if hi > lo:
            dang[s, : hi - lo] = dangling[lo:hi]

    # owner t -> peer s send lists, as slot ids in t's slot space
    for t in range(num_shards):
        for s in range(num_shards):
            ids = halo[s][t]  # global ids owned by t needed by s
            if len(ids):
                send_ids[t, s, : len(ids)] = local_inv[t, ids - t * ns]

    # remap each shard's gather indices from GLOBAL node ids to q space:
    # q = [own slots (S rows) ; halo block per owner (C x H rows)]
    def to_q(s: int, g_idx: np.ndarray) -> np.ndarray:
        out = np.full(g_idx.shape, zero_row, dtype=np.int32)  # pad -> zero slot
        owner = np.minimum(g_idx // ns, num_shards - 1)
        own = owner == s
        out[own] = local_inv[s, g_idx[own] - s * ns]
        for t in range(num_shards):
            if t == s:
                continue
            m = owner == t
            if not m.any():
                continue
            pos = np.searchsorted(halo[s][t], g_idx[m])
            out[m] = n_slots + t * h_cap + pos
        return out

    for s, (b_nodes, b_idx, b_wgt, hub_nodes, hidx, hwgt, hseg) in enumerate(shards):
        for i in range(len(widths)):
            nb = len(b_nodes[i])
            if nb:
                # padding entries inside rows have weight 0; their index is
                # remapped like a real one (bounded by to_q's zero fallback)
                real = b_wgt[i] != 0
                q_idx = np.full(b_idx[i].shape, zero_row, dtype=np.int32)
                q_idx[real] = to_q(s, b_idx[i][real])
                bucket_idx[i][s, :nb] = q_idx
        if hidx.shape[0]:
            real = hwgt != 0
            q_idx = np.full(hidx.shape, zero_row, dtype=np.int32)
            q_idx[real] = to_q(s, hidx[real])
            hub_idx[s, : hidx.shape[0]] = q_idx

    return ShardedELLGraph(
        bucket_idx=bucket_idx,
        bucket_wgt=bucket_wgt,
        hub_idx=hub_idx,
        hub_wgt=hub_wgt,
        hub_seg=hub_seg,
        local_inv=local_inv,
        slot_to_node=slot_to_node,
        send_ids=send_ids,
        dangling=dang,
        num_nodes=np.asarray(graph.num_nodes, dtype=np.int32),
        shard_nodes=ns,
        n_hub=nhub_max,
        n_slots=n_slots,
        halo_width=h_cap,
    )


def put_sharded_ell(mesh: Mesh, sg: ShardedELLGraph) -> ShardedELLGraph:
    """Place the per-shard arrays on their corpus-axis devices (grids)."""
    def place(x):
        return _place_shards(mesh, x)

    return sg._replace(
        bucket_idx=tuple(place(x) for x in sg.bucket_idx),
        bucket_wgt=tuple(place(x) for x in sg.bucket_wgt),
        hub_idx=place(sg.hub_idx),
        hub_wgt=place(sg.hub_wgt),
        hub_seg=place(sg.hub_seg),
        local_inv=place(sg.local_inv),
        slot_to_node=place(sg.slot_to_node),
        send_ids=place(sg.send_ids),
        dangling=place(sg.dangling),
        num_nodes=int(sg.num_nodes),
    )


def sharded_ell_counters(sg: ShardedELLGraph, batch: int, dp: int = 1) -> dict:
    """Per-device WORK counters for one sharded PPR iteration over a host
    ``shard_graph_ell`` result (the JAX package's model, key for key).

    - ``rows_gathered_per_iter_device``: every ELL entry (including
      width/row padding) costs one gathered [B/dp]-lane row per iteration
      on its shard.
    - ``halo_ici_bytes_per_iter_device``: the [C, H, B/dp] all_to_all
      block each device ships per iteration (C·H·(B/dp)·4).
    - ``allgather_ici_bytes_per_iter_device``: what an all_gather of the
      rank vector would ship ((C-1)·Ns·(B/dp)·4), the comparison point.
    """
    b_lane = max(1, batch // max(dp, 1))
    c = int(sg.send_ids.shape[0])
    rows = sum(int(i.shape[1]) * int(i.shape[2]) for i in sg.bucket_idx)
    rows += int(sg.hub_idx.shape[1]) * int(sg.hub_idx.shape[2])
    real_entries = sum(
        int(np.count_nonzero(np.asarray(w))) for w in sg.bucket_wgt
    ) + int(np.count_nonzero(np.asarray(sg.hub_wgt)))
    return {
        "num_shards": c,
        "shard_nodes": int(sg.shard_nodes),
        "n_slots": int(sg.n_slots),
        "halo_rows_per_peer": int(sg.halo_width),
        "halo_frac_of_shard": round(sg.halo_width / sg.shard_nodes, 4),
        "rows_gathered_per_iter_device": rows,
        "real_entries_per_device": real_entries // max(c, 1),
        "ell_padding_overhead": round(rows * c / max(real_entries, 1), 3),
        "halo_ici_bytes_per_iter_device": c * sg.halo_width * b_lane * 4,
        "allgather_ici_bytes_per_iter_device": (c - 1)
        * int(sg.shard_nodes)
        * b_lane
        * 4,
    }


def sharded_ell_hbm_estimate(
    batch: int,
    num_shards: int,
    shard_nodes: int,
    n_slots: int,
    halo_width: int,
    entries_per_device: int,
    dp: int = 1,
    gather_budget_bytes: int | None = None,
) -> dict:
    """Per-DEVICE memory model for a sharded halo-ELL PPR solve (the JAX
    package's model, key for key), from plain structural integers so a
    10M-node configuration can be checked without building it.

    - ``operator``: the shard's ELL entries (idx int32 + wgt f32 = 8 B
      per padded entry) plus the maps (local_inv, slot_to_node, send_ids,
      dangling).
    - ``states``: live [Sq, B/dp]-f32 loop buffers, where Sq = n_slots +
      C·H (own slots plus the received halo blocks), 5x as in the
      single-device model.
    - ``halo_buffers``: the [C, H, B/dp] send + receive all_to_all blocks.
    - ``gather_temp``: bounded by the active gather budget (the bucket
      reduce width-blocks anything larger, ops/pagerank._bucket_plan).
    - ``io``: natural-order reset upload + result, [B/dp, Ns] each.
    """
    from ..ops.pagerank import _ELL_GATHER_BYTES, _PPR_BATCH_TILE

    if gather_budget_bytes is None:
        gather_budget_bytes = _ELL_GATHER_BYTES
    b_lane = max(1, batch // max(dp, 1))
    b_tile = min(b_lane, _PPR_BATCH_TILE)
    sq = n_slots + num_shards * halo_width
    operator = entries_per_device * 8 + (shard_nodes * 2 + n_slots) * 4
    operator += num_shards * halo_width * 4  # send_ids row
    states = 5 * sq * b_tile * 4
    halo_buffers = 2 * num_shards * halo_width * b_tile * 4
    gather_temp = min(gather_budget_bytes, entries_per_device * b_tile * 4)
    io = 2 * b_lane * shard_nodes * 4
    total = operator + states + halo_buffers + gather_temp + io
    return {
        "operator_bytes": operator,
        "states_bytes": states,
        "halo_buffer_bytes": halo_buffers,
        "gather_temp_bytes": gather_temp,
        "io_bytes": io,
        "total_bytes": total,
        "total_gib": round(total / 2**30, 3),
        "batch": batch,
        "b_tile": b_tile,
    }


def make_sharded_ppr_ell(
    mesh: Mesh, max_iters: int = 64, damping: float = 0.5, tol: float = 1e-8,
    n_hub: int | None = None,
):
    """Sharded scatter-free halo-exchange PPR: ``run(sg, reset) -> ranks``.

    ``sg`` comes from ``put_sharded_ell``; reset is [B, C·Ns] (B divisible
    by dp) and the ranks come back on its device, with the per-query
    iteration counts when ``run(..., return_iters=True)``. Per iteration
    each shard gathers its boundary rows into a [C, H, b] send buffer,
    swaps them with ``all_to_all`` over the group's corpus shards, reduces
    its ELL row blocks from q = [own slots ; halo] (``_bucket_reduce``, the
    single-device reduce with its gather budget) and its hub chunk rows in
    a fixed order, and advances the shared zero-row coefficient by the
    scalar dangling recurrence. Early exit is stall-aware; the residual is
    the max over the group's shards. ``n_hub`` is taken from the graph
    (parameter kept for the JAX package's signature).
    """
    del n_hub
    d, one_minus_d = _f32(damping), _f32(np.float32(1.0) - np.float32(damping))

    def run(sg: ShardedELLGraph, reset: torch.Tensor, return_iters: bool = False):
        ns, n_c, h_cap = sg.shard_nodes, mesh.corpus, sg.halo_width
        zero_row = sg.n_slots - 1

        def solve_group(g, blocks):
            b_idx = [[x[g][c] for x in sg.bucket_idx] for c in range(n_c)]
            b_wgt = [[x[g][c] for x in sg.bucket_wgt] for c in range(n_c)]
            hub_idx, hub_wgt, local_inv, slot_to_node, send_ids, dang = (
                getattr(sg, f)[g] for f in ("hub_idx", "hub_wgt", "local_inv", "slot_to_node",
                                            "send_ids", "dangling"))
            hub_rows = [hub_row_map(s, sg.n_hub) for s in sg.hub_seg[g]]
            r_T = [x.T for x in _normalized_shards(blocks, sg.num_nodes, ns)]  # [Ns, b]
            # slot space: one [S]-row gather in, scalar dangling mass
            r_slot = [torch.cat([x, x.new_zeros(1, x.shape[1])])[s2n] for x, s2n in zip(r_T, slot_to_node)]
            rdm = psum([(x * dg[:, None]).sum(0, keepdim=True) for x, dg in zip(r_T, dang)])

            def _solve(r_s, rdm_t):
                def step(p, c):
                    # halo exchange: ship boundary rows to every peer
                    send = [x[ids] for x, ids in zip(p, send_ids)]  # [C, H, b]
                    recv = all_to_all(send) if n_c > 1 else send
                    nxt_p, nxt_c, errs = [], [], []
                    for s in range(n_c):
                        b = p[s].shape[1]
                        q = torch.cat([p[s], recv[s].reshape(n_c * h_cap, b)])
                        parts = [_bucket_reduce(q, i, w) for i, w in zip(b_idx[s], b_wgt[s])]
                        partial = _bucket_reduce(q, hub_idx[s], hub_wgt[s])
                        partial = torch.cat([partial, partial.new_zeros(1, b)])
                        parts.append(partial[hub_rows[s]].sum(1))
                        parts.append(q.new_zeros(1, b))
                        y = torch.cat(parts)  # [S, b] slot order
                        dm = c[s] * rdm_t[s]
                        x_next = one_minus_d * r_s[s] + d * (y + dm * r_s[s])
                        c_next = one_minus_d + d * dm
                        nxt_p.append(x_next)
                        nxt_c.append(c_next)
                        errs.append(torch.maximum((x_next - p[s]).abs().amax(), (c_next - c[s]).abs().amax()))
                    return nxt_p, nxt_c, errs

                ones = [torch.ones_like(x) for x in rdm_t]
                p, c, it = _power_loop(step, r_s, ones, tol, max_iters, damping)
                it_row = torch.full((1, r_s[0].shape[1]), it, dtype=torch.int32, device=r_s[0].device)
                return p, c, [it_row]

            p_slot, c, it_row = tile_columns(_solve, r_slot, rdm)
            out = [
                torch.where((li == zero_row)[:, None], cc * x, ps[li]).T
                for li, cc, x, ps in zip(local_inv, c, r_T, p_slot)
            ]
            return out, it_row[0][0]

        return _run_groups(mesh, reset, ns, solve_group, return_iters)

    return run
