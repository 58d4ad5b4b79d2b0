"""Multi-device dry run of the port (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m hipporag_tpu_torch.parallel.dryrun [n_devices]

One sharded step on an n-device mesh: sharded scoring against the
single-device scorer, COO and ELL PPR over a toy graph, one dp+tp adapter
step; then an EXECUTED halo-exchange solve at 1,048,576 nodes / ~10M
entries with its per-device work counters and a check of the per-device
memory model against the placed operator; the width-blocked reduce under a
16 MiB gather budget, held to the unblocked solve; with 4 or more devices,
the weak-scaling point (half the shards, half the graph, the per-device
work counters checked flat); and the capacity table
of the 10M-node / 100M-entry stretch shape on 8 devices of this card's
memory (not measured without a card).

With fewer visible CUDA devices than ``n_devices`` the mesh takes virtual
shards of the first one (of the CPU when there is no card): the exchange
paths all run, but wall time then says nothing about scaling.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import pagerank as _pr
from ..ops.pagerank import COOGraph, normalize_symmetric_coo
from ..ops.scoring import score_and_topk
from .mesh import make_mesh, visible_devices
from .sharded import (
    make_sharded_ppr,
    make_sharded_ppr_ell,
    make_sharded_score_topk,
    put_sharded_ell,
    put_sharded_graph,
    shard_graph,
    shard_graph_ell,
    sharded_ell_counters,
    sharded_ell_hbm_estimate,
)

SCALE_NODES, SCALE_EDGES = 1_048_576, 5_000_000  # directed entries; ~10M after symmetric expansion
CAPPED_GATHER_BYTES = 16 * 1024 * 1024
# Structure of the 10M-node / 100M-entry stretch shape on 8 shards, from a
# shard_graph_ell build of the clustered operator (the JAX package's
# scripts/capacity_sharded_10m.py; the port's builder is the same NumPy
# code): shard_nodes, n_slots, halo rows per peer, padded entries/device
POD_10M = dict(num_shards=8, shard_nodes=1_310_720, n_slots=1_314_207,
               halo_width=15_856, entries_per_device=14_300_000)
POD_BATCHES = (64, 128, 256)
POD_HEADROOM = 0.85


def _toy_index(num_nodes=256, num_edges=2048, num_facts=128, dim=128, seed=0):
    """A small random graph (host COOGraph), fact embeddings and the real fact count."""
    from ..graph import GraphBuilder, compile_device_graph

    rng = np.random.default_rng(seed)
    builder = GraphBuilder()
    names = [f"n{i}" for i in range(num_nodes)]
    builder.register_nodes(names)
    for _ in range(num_edges):
        a, b = rng.integers(0, num_nodes, 2)
        if a == b:
            continue
        key = (names[a], names[b])
        builder.edge_weights[key] = builder.edge_weights.get(key, 0.0) + float(rng.uniform(0.1, 2.0))
    graph, _, _ = compile_device_graph(builder)
    fact_cap = -(-num_facts // 128) * 128
    fact_emb = rng.standard_normal((fact_cap, dim)).astype(np.float32)
    return graph, fact_emb, num_facts


def clustered_coo(num_nodes, num_edges, num_shards, inter_frac=0.01, seed=7) -> COOGraph:
    """Community-structured symmetric transition operator (numpy COOGraph):
    nodes are pre-partitioned into ``num_shards`` contiguous blocks and only
    ``inter_frac`` of the edges cross blocks, the regime the halo exchange
    exists for (cut << N)."""
    rng = np.random.default_rng(seed)
    block = num_nodes // num_shards
    blk = rng.integers(0, num_shards, size=num_edges)
    lo = blk * block
    src = lo + rng.integers(0, block, size=num_edges)
    cross = rng.random(num_edges) < inter_frac
    dst = np.where(cross, rng.integers(0, num_nodes, size=num_edges), lo + rng.integers(0, block, size=num_edges))
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.5, 2.0, size=len(src)).astype(np.float32)
    node_cap = ((num_nodes + 127) // 128) * 128
    s2, d2, wn, dang = normalize_symmetric_coo(src, dst, w, num_nodes, node_cap)
    return COOGraph(src=s2, dst=d2, w_norm=wn, dangling=dang, num_nodes=np.asarray(num_nodes, np.int32))


def _devices(n_devices: int, devices):
    if devices is not None:
        return [torch.device(d) for d in devices]
    visible = visible_devices()
    return visible[:n_devices] if len(visible) >= n_devices else [visible[0]] * n_devices


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def placed_operator_bytes(sg_dev, shard: int = 0) -> int:
    """Bytes of one shard's placed operator: its ELL entries, hub rows and maps."""
    fields = [*sg_dev.bucket_idx, *sg_dev.bucket_wgt, sg_dev.hub_idx, sg_dev.hub_wgt, sg_dev.hub_seg,
              sg_dev.local_inv, sg_dev.slot_to_node, sg_dev.send_ids, sg_dev.dangling]
    return sum(f[0][shard].nbytes for f in fields)


def weak_scaling(devices, corpus_s, scale_nodes, scale_edges, batch, rng, cnt, solve_s, log) -> dict:
    """Half the corpus axis at the same shard size: a (1, corpus_s // 2)
    mesh over the first half of the devices solves a clustered graph of
    half the nodes and entries. The claim is per-device work, read from the
    counters: rows gathered per device stay flat (0.7-1.4x) from half the
    shards to ``corpus_s``, and the halo exchange ships under a fifth of an
    all-gather's bytes. ``cnt`` and ``solve_s`` are the scale phase's."""
    corpus_w = corpus_s // 2
    mesh_w = make_mesh((1, corpus_w), devices=devices[:corpus_w])
    t0 = time.perf_counter()
    coo_w = clustered_coo(scale_nodes // 2, scale_edges // 2, corpus_w, seed=9)
    sgw = shard_graph_ell(coo_w, num_shards=corpus_w)
    sgw_dev = put_sharded_ell(mesh_w, sgw)
    build_s = time.perf_counter() - t0
    reset_w = np.zeros((batch, corpus_w * sgw.shard_nodes), np.float32)
    for i in range(batch):
        reset_w[i, rng.integers(0, scale_nodes // 2, 5)] = rng.uniform(0.1, 1, 5)
    home = mesh_w.devices[0, 0]
    reset_w = torch.from_numpy(reset_w).to(home)
    ppr_w = make_sharded_ppr_ell(mesh_w, max_iters=24)
    ppr_w(sgw_dev, reset_w)  # warm-up, as the scale phase's timed solve had
    _sync(home)
    t0 = time.perf_counter()
    ranks_w, iters = ppr_w(sgw_dev, reset_w, return_iters=True)
    _sync(home)
    solve_w = time.perf_counter() - t0
    sums = ranks_w.sum(1).cpu().numpy()
    assert np.allclose(sums, 1.0, atol=1e-4), sums
    cnt_w = sharded_ell_counters(sgw, batch, dp=1)
    rows_ratio = cnt["rows_gathered_per_iter_device"] / max(cnt_w["rows_gathered_per_iter_device"], 1)
    assert 0.7 <= rows_ratio <= 1.4, (
        f"per-device gathered rows not flat across weak scaling: {cnt_w['rows_gathered_per_iter_device']} -> "
        f"{cnt['rows_gathered_per_iter_device']} ({rows_ratio:.2f}x)")
    assert cnt["halo_ici_bytes_per_iter_device"] * 5 < cnt["allgather_ici_bytes_per_iter_device"], (
        "halo exchange lost its advantage over an all-gather at scale")
    log(f"weak scaling ok: {corpus_w} shards x {cnt_w['shard_nodes']} rows -> {corpus_s} shards x "
        f"{cnt['shard_nodes']} rows; per-device rows gathered/iter {cnt_w['rows_gathered_per_iter_device']} -> "
        f"{cnt['rows_gathered_per_iter_device']} ({rows_ratio:.2f}x, counter-checked flat); exchange bytes/iter/"
        f"device {cnt_w['halo_ici_bytes_per_iter_device'] / 1024:.0f} -> "
        f"{cnt['halo_ici_bytes_per_iter_device'] / 1024:.0f} KiB (an all-gather would ship "
        f"{cnt['allgather_ici_bytes_per_iter_device'] / 1024:.0f} KiB); solve {solve_w:.3f} -> {solve_s:.3f} s "
        f"(virtual shards, informational: wall time there is not a scaling claim)")
    return {"shards": [corpus_w, corpus_s], "nodes": scale_nodes // 2, "directed_entries": int(len(coo_w.src)),
            "iters": int(iters.max()), "host_build_s": build_s, "solve_s": solve_w, "scale_solve_s": solve_s,
            "rows_ratio": rows_ratio, "counters": cnt_w}


def dryrun_multichip(n_devices: int, devices=None, scale_nodes: int = SCALE_NODES,
                     scale_edges: int = SCALE_EDGES, scale_batch: int = 8, log=print) -> dict:
    """Run every sharded path on an ``n_devices`` mesh and check it; returns
    the numbers it printed. ``devices`` (repeats allowed) overrides the
    default of :func:`_devices`; ``scale_nodes``/``scale_edges`` size the
    executed halo solve."""
    devices = _devices(n_devices, devices)
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    corpus = n_devices // dp
    mesh = make_mesh((dp, corpus), devices=devices)
    home = mesh.devices[0, 0]
    out = {"devices": [str(d) for d in devices], "mesh": [dp, corpus]}

    graph, fact_emb, num_facts = _toy_index()
    rng = np.random.default_rng(2)
    b, dim = 8, fact_emb.shape[1]
    qf = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32)).to(home)

    # --- sharded retrieval step: scoring + top-k against one device ---
    fpad = -(-fact_emb.shape[0] // corpus) * corpus
    keys = torch.from_numpy(np.pad(fact_emb, ((0, fpad - fact_emb.shape[0]), (0, 0)))).to(home)
    norm, top_vals, top_idx = make_sharded_score_topk(mesh, k=5)(qf, keys, num_facts)
    want_norm, want_vals, want_idx = score_and_topk(qf, keys, num_facts, 5)
    assert torch.equal(top_idx, want_idx), "sharded top-k indices differ from one device's"
    score_err = float((norm - want_norm).abs().max())
    assert score_err <= 1e-5 and float((top_vals - want_vals).abs().max()) <= 1e-5, score_err

    sg = shard_graph(graph, num_shards=corpus)
    n_total = corpus * sg.shard_nodes
    reset = np.zeros((b, n_total), np.float32)
    cols = rng.integers(0, 256, (b, 4))
    for i in range(b):
        reset[i, cols[i]] = 1.0
    reset = torch.from_numpy(reset).to(home)
    ranks = make_sharded_ppr(mesh, max_iters=32)(put_sharded_graph(mesh, sg), reset)
    row_sums = ranks.sum(1).cpu().numpy()
    assert np.allclose(row_sums, 1.0, atol=1e-4), row_sums

    # --- sharded scatter-free (ELL) PPR: the production multi-device path ---
    sge = shard_graph_ell(graph, num_shards=corpus)
    ranks_ell = make_sharded_ppr_ell(mesh, max_iters=32)(put_sharded_ell(mesh, sge), reset)
    ell_err = float((ranks_ell - ranks).abs().max())
    assert ell_err <= 1e-5, f"sharded ELL PPR diverged from COO: {ell_err}"

    # --- one sharded training step (dp batch, tp hidden) ---
    from ..models.adapter import adamw, init_adapter, make_sharded_train_step

    hidden = 16 * corpus
    params = init_adapter(dim, hidden, generator=torch.Generator().manual_seed(0), device=home)
    train_step, place = make_sharded_train_step(mesh, lambda ps: adamw(ps, 1e-3))
    queries = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    positives = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    loss = float(train_step(*place(params, queries.to(home), positives.to(home))))
    assert np.isfinite(loss)
    halo_bytes = corpus * sge.halo_width * (b // dp) * 4
    out["toy"] = {"score_max_abs_err": score_err, "ell_vs_coo_max_abs": ell_err,
                  "halo_rows_per_peer": sge.halo_width, "halo_bytes_per_iter_device": halo_bytes,
                  "train_loss": loss}
    log(f"dryrun_multichip ok: mesh=({dp},{corpus}) on {out['devices']}, sharded top-k == one device, "
        f"ppr rows sum to 1, ELL == COO within {ell_err:.1e}, halo={sge.halo_width} rows/peer "
        f"({halo_bytes / 1024:.1f} KiB/iter/device), train loss={loss:.4f}")

    # --- scale phase: 1M nodes / 10M entries, executed, with work counters ---
    corpus_s = n_devices
    mesh_s = make_mesh((1, corpus_s), devices=devices)
    t0 = time.perf_counter()
    coo_big = clustered_coo(scale_nodes, scale_edges, corpus_s)
    sgb = shard_graph_ell(coo_big, num_shards=corpus_s)
    sgb_dev = put_sharded_ell(mesh_s, sgb)
    build_s = time.perf_counter() - t0
    reset_b = np.zeros((scale_batch, corpus_s * sgb.shard_nodes), np.float32)
    rng2 = np.random.default_rng(5)
    for i in range(scale_batch):
        reset_b[i, rng2.integers(0, scale_nodes, 5)] = rng2.uniform(0.1, 1, 5)
    reset_b = torch.from_numpy(reset_b).to(home)
    ppr_big = make_sharded_ppr_ell(mesh_s, max_iters=24)
    ranks_b, iters = ppr_big(sgb_dev, reset_b, return_iters=True)  # first call: warm-up
    _sync(home)
    t0 = time.perf_counter()
    ranks_b, iters = ppr_big(sgb_dev, reset_b, return_iters=True)
    _sync(home)
    solve_s = time.perf_counter() - t0
    sums = ranks_b.sum(1).cpu().numpy()
    assert np.allclose(sums, 1.0, atol=1e-4), sums
    cnt = sharded_ell_counters(sgb, scale_batch, dp=1)
    assert sgb.halo_width * 8 <= sgb.shard_nodes, f"halo {sgb.halo_width} not << shard {sgb.shard_nodes}"
    out["scale"] = {"nodes": scale_nodes, "directed_entries": int(len(coo_big.src)), "batch": scale_batch,
                    "host_build_s": build_s, "solve_s": solve_s, "iters": int(iters.max()),
                    "ms_per_iter": solve_s * 1e3 / max(int(iters.max()), 1), "counters": cnt}
    log(f"scale phase ok (EXECUTED): {scale_nodes} nodes / {len(coo_big.src)} directed entries on "
        f"{corpus_s} shards; counters {cnt}; host build {build_s:.1f} s, solve {solve_s:.3f} s for "
        f"{int(iters.max())} iterations (wall time on virtual shards is not a scaling claim)")

    # the per-device memory model against the placed operator
    est = sharded_ell_hbm_estimate(
        batch=scale_batch, num_shards=corpus_s, shard_nodes=sgb.shard_nodes, n_slots=sgb.n_slots,
        halo_width=sgb.halo_width, entries_per_device=cnt["rows_gathered_per_iter_device"], dp=1,
    )
    actual = placed_operator_bytes(sgb_dev)
    ratio = est["operator_bytes"] / actual
    assert 0.95 <= ratio <= 1.05, f"memory model operator bytes off: est {est['operator_bytes']} vs {actual}"
    out["hbm_model"] = {"operator_est_bytes": est["operator_bytes"], "operator_placed_bytes": actual,
                        "ratio": ratio, "total_gib": est["total_gib"]}
    log(f"memory model checked at {scale_nodes} nodes: operator est/placed = {ratio:.3f}, "
        f"per-device total {est['total_gib']} GiB at B={scale_batch}")

    # --- the width-blocked reduce under a small gather budget ---
    budget = _pr._ELL_GATHER_BYTES
    _pr._ELL_GATHER_BYTES = CAPPED_GATHER_BYTES
    try:
        ranks_cap = make_sharded_ppr_ell(mesh_s, max_iters=24)(sgb_dev, reset_b)
    finally:
        _pr._ELL_GATHER_BYTES = budget
    cap_err = float((ranks_cap - ranks_b).abs().max())
    assert cap_err < 1e-6, f"budget-capped reduce diverged: {cap_err}"
    out["capped_reduce_max_abs"] = cap_err
    log(f"budget-capped reduce ok: {CAPPED_GATHER_BYTES >> 20} MiB gather budget, max |diff| {cap_err:.1e}")

    if corpus_s >= 4:
        out["weak_scaling"] = weak_scaling(devices, corpus_s, scale_nodes, scale_edges, scale_batch, rng2, cnt,
                                           solve_s, log)

    # --- capacity table: the 10M / 100M stretch shape on 8 of this card ---
    cap = torch.cuda.get_device_properties(home).total_memory if home.type == "cuda" else None
    table = []
    for batch in POD_BATCHES:
        e = sharded_ell_hbm_estimate(batch=batch, dp=1, **POD_10M)
        fits = None if cap is None else bool(e["total_bytes"] < POD_HEADROOM * cap)
        table.append({"batch": batch, "total_gib": e["total_gib"], "fits": fits})
        verdict = "not measured (no card)" if fits is None else ("FITS" if fits else "OVER")
        log(f"  10M/100M on 8 shards, B={batch}: {e['total_gib']} GiB/device -> {verdict}")
    if cap is not None:
        assert any(row["fits"] for row in table), "10M/100M fits 8 of this card at no tested batch"
    out["capacity"] = {"device_memory_bytes": cap, "headroom": POD_HEADROOM, "table": table}
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
