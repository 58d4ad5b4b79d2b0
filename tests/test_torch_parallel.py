"""The port's multi-device layer against the JAX package's (``tests/test_parallel.py``).

The JAX side runs on its virtual 8-device CPU mesh (``tests/conftest.py``);
the port runs the same numpy inputs on CPU virtual shards (a mesh whose
devices are all the CPU), in this process. Each test of
``tests/test_parallel.py`` has a twin here at that test's own tolerance:

- sharded COO PPR vs one device: atol 2e-6;
- sharded scoring vs one device: atol 1e-5, and the top-k indices equal;
- sharded ELL PPR (plain, width-blocked, past one 128-column tile, the
  block-diagonal cut) vs one device: rtol 1e-5 / atol 1e-7;
- the full pipeline (sharded scoring, host seeds, sharded ELL PPR) vs the
  single-device pipeline: rtol 1e-4 / atol 1e-6;
- the device seed builder vs its host twin: rtol 1e-6 / atol 1e-7;
- the dp+tp adapter step vs the single-device step: losses and ``w_in``
  rtol 1e-4 / atol 1e-5, and the loss falls.

Beyond the twins: the host builders' arrays and the work and memory models'
dicts equal the JAX package's exactly; the scorer and both solvers give the
same result for every shard count C in {1, 2, 4, 8} and dp in {1, 2}; the
placements copy nothing onto a device that already holds the data; the
collectives have the ``jax.lax`` semantics; and the dry run passes at a
small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hipporag_tpu.graph.csr import round_up
from hipporag_tpu.models import adapter as ref_adapter
from hipporag_tpu.ops import pagerank as ref_pr
from hipporag_tpu.ops import scoring as ref_scoring
from hipporag_tpu.parallel import mesh as ref_mesh
from hipporag_tpu.parallel import sharded as ref_sharded
from hipporag_tpu_torch.convert import adapter_params_from_jax
from hipporag_tpu_torch.models import adapter as port_adapter
from hipporag_tpu_torch.ops import pagerank as port_pr
from hipporag_tpu_torch.ops import scoring as port_scoring
from hipporag_tpu_torch.parallel import collectives, mesh as port_mesh, sharded as port_sharded

torch.set_num_threads(1)

COO_ATOL = 2e-6
SCORE_ATOL = 1e-5
ELL_RTOL, ELL_ATOL = 1e-5, 1e-7
PIPELINE_RTOL, PIPELINE_ATOL = 1e-4, 1e-6


def cpu_mesh(dp, corpus):
    return port_mesh.make_mesh((dp, corpus), devices=["cpu"] * (dp * corpus))


def jax_mesh(dp, corpus):
    return ref_mesh.make_mesh((dp, corpus), devices=jax.devices()[: dp * corpus])


def _symmetric_coo(src, dst, w, n):
    """The JAX tests' host operator: symmetric expansion, dst-sorted, w/strength."""
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    w2 = np.concatenate([w, w]).astype(np.float64)
    o = np.argsort(d2, kind="stable")
    s2, d2, w2 = s2[o], d2[o], w2[o]
    strength = np.zeros(n)
    np.add.at(strength, s2, w2)
    node_cap = round_up(n, 128)
    wp = (w2 / strength[s2]).astype(np.float32)
    dang = np.zeros(node_cap, np.float32)
    dang[:n] = strength == 0
    return dict(src=s2.astype(np.int32), dst=d2.astype(np.int32), w_norm=wp, dangling=dang,
                num_nodes=np.asarray(n, np.int32))


def hub_graph(seed=21, n=700):
    """``test_sharded_ell_ppr_matches_single_device``'s graph: random edges and a hub at node 3."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, 5000), rng.integers(0, n, 800)])
    dst = np.concatenate([rng.integers(0, n, 5000), np.full(800, 3)])
    keep = src != dst
    src, dst, w = src[keep], dst[keep], rng.uniform(0.5, 2.0, keep.sum())
    return _symmetric_coo(src, dst, w, n), rng


def builder_graph(num_nodes=300, num_edges=2000, seed=0):
    """``_random_graph`` of ``tests/test_parallel.py``, compiled by each package."""
    from hipporag_tpu.graph import GraphBuilder as RefBuilder, compile_device_graph as ref_compile
    from hipporag_tpu_torch.graph import GraphBuilder, compile_device_graph

    out = []
    for builder_cls, compile_fn in ((RefBuilder, ref_compile), (GraphBuilder, compile_device_graph)):
        rng = np.random.default_rng(seed)
        builder = builder_cls()
        names = [f"n{i}" for i in range(num_nodes)]
        builder.register_nodes(names)
        for _ in range(num_edges):
            a, b = rng.integers(0, num_nodes, 2)
            if a == b:
                continue
            key = (names[a], names[b])
            builder.edge_weights[key] = builder.edge_weights.get(key, 0.0) + float(rng.uniform(0.1, 2.0))
        out.append(compile_fn(builder)[0])
    return out


def random_resets(rng, b, n_total, n, per_row=3):
    reset = np.zeros((b, n_total), np.float32)
    for i in range(b):
        reset[i, rng.integers(0, n, per_row)] = rng.uniform(0.3, 1.0, per_row)
    return reset


def jax_single_coo(coo_np, reset, max_iters=64, tol=1e-8):
    graph = ref_pr.COOGraph(**{k: jnp.asarray(v) for k, v in coo_np.items()})
    return np.asarray(ref_pr.batched_ppr(graph, jnp.asarray(reset), max_iters=max_iters, tol=tol))


# ---------------------------------------------------------------------------
# Twins of tests/test_parallel.py
# ---------------------------------------------------------------------------

def test_sharded_ppr_matches_single_chip():
    ref_graph, port_graph = builder_graph()
    n_pad = int(port_graph.dangling.shape[0])
    n = int(port_graph.num_nodes)
    rng = np.random.default_rng(5)
    b = 8
    reset = np.zeros((b, n_pad), np.float32)
    for i in range(b):
        reset[i, rng.integers(0, n, 5)] = rng.uniform(0.1, 1.0, 5)
    single = np.asarray(ref_pr.batched_ppr(ref_graph, jnp.asarray(reset), max_iters=96, tol=1e-10))

    mesh = cpu_mesh(2, 4)
    sg = port_sharded.shard_graph(port_graph, num_shards=4)
    reset_pad = np.zeros((b, 4 * sg.shard_nodes), np.float32)
    reset_pad[:, :n_pad] = reset
    run = port_sharded.make_sharded_ppr(mesh, max_iters=96, damping=0.5, tol=1e-10)
    out = run(port_sharded.put_sharded_graph(mesh, sg), torch.from_numpy(reset_pad)).numpy()

    np.testing.assert_allclose(out[:, :n], single[:, :n], atol=COO_ATOL)
    assert np.abs(out[:, n_pad:]).max() == 0.0
    # and the JAX package's own sharded solve on its (2, 4) mesh
    jmesh = jax_mesh(2, 4)
    jsg = ref_sharded.put_sharded_graph(jmesh, ref_sharded.shard_graph(ref_graph, num_shards=4))
    jout = np.asarray(ref_sharded.make_sharded_ppr(jmesh, max_iters=96, tol=1e-10)(jsg, jnp.asarray(reset_pad)))
    np.testing.assert_allclose(out, jout, atol=COO_ATOL)


def test_sharded_score_topk_matches_single_chip():
    rng = np.random.default_rng(9)
    b, d, nk = 8, 32, 512
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = rng.standard_normal((nk, d)).astype(np.float32)
    valid_n = 500  # last rows are padding
    single = np.asarray(ref_scoring.batched_normalized_scores(jnp.asarray(q), jnp.asarray(keys), jnp.asarray(valid_n)))

    run = port_sharded.make_sharded_score_topk(cpu_mesh(2, 4), k=7)
    norm, vals, gidx = (t.numpy() for t in run(torch.from_numpy(q), torch.from_numpy(keys), valid_n))

    np.testing.assert_allclose(norm, single, atol=SCORE_ATOL)
    expect_idx = np.argsort(-single, axis=1)[:, :7]
    np.testing.assert_allclose(vals, np.take_along_axis(single, expect_idx, axis=1), atol=SCORE_ATOL)
    np.testing.assert_allclose(np.take_along_axis(single, gidx, axis=1),
                               np.take_along_axis(single, expect_idx, axis=1), atol=SCORE_ATOL)
    _, jvals, jidx = ref_sharded.make_sharded_score_topk(jax_mesh(2, 4), k=7)(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(valid_n))
    np.testing.assert_array_equal(gidx, np.asarray(jidx))
    np.testing.assert_allclose(vals, np.asarray(jvals), atol=SCORE_ATOL)


def test_make_hybrid_mesh_single_slice_fallback():
    mesh = port_mesh.make_hybrid_mesh(dp_slices=2, devices=["cpu"] * 8)
    jmesh = ref_mesh.make_hybrid_mesh(dp_slices=2)
    assert mesh.axis_names == (port_mesh.DP_AXIS, port_mesh.CORPUS_AXIS) == jmesh.axis_names
    assert mesh.shape[port_mesh.DP_AXIS] == 2 == jmesh.shape[ref_mesh.DP_AXIS]
    assert mesh.shape[port_mesh.CORPUS_AXIS] == 4 == jmesh.shape[ref_mesh.CORPUS_AXIS]
    with pytest.raises(ValueError):
        port_mesh.make_hybrid_mesh(dp_slices=3, devices=["cpu"] * 8)


def _ell_vs_single(monkeypatch_budget=None):
    coo_np, rng = hub_graph()
    mesh = cpu_mesh(2, 4)
    sg = port_sharded.shard_graph_ell(port_pr.COOGraph(**coo_np), num_shards=4, bucket_widths=(4, 16, 64),
                                      hub_width=128)
    n_total = 4 * sg.shard_nodes
    node_cap = coo_np["dangling"].shape[0]
    reset = random_resets(rng, 8, n_total, int(coo_np["num_nodes"]))
    got = port_sharded.make_sharded_ppr_ell(mesh, max_iters=64, n_hub=sg.n_hub)(
        port_sharded.put_sharded_ell(mesh, sg), torch.from_numpy(reset)).numpy()
    want = jax_single_coo(_symmetric_coo_padded(coo_np), reset[:, :node_cap])
    np.testing.assert_allclose(got[:, :node_cap], want, rtol=ELL_RTOL, atol=ELL_ATOL)
    np.testing.assert_allclose(got[:, node_cap:], 0.0, atol=1e-9)
    return got


def _symmetric_coo_padded(coo_np):
    """The single-device COO operator of the JAX tests: edges padded to 1024."""
    node_cap = coo_np["dangling"].shape[0]
    pad = 1024 - len(coo_np["src"]) % 1024
    return dict(coo_np, src=np.pad(coo_np["src"], (0, pad)), w_norm=np.pad(coo_np["w_norm"], (0, pad)),
                dst=np.pad(coo_np["dst"], (0, pad), constant_values=node_cap - 1))


def test_sharded_ell_ppr_matches_single_device():
    _ell_vs_single()


def test_sharded_ell_ppr_width_blocked_matches_single_device(monkeypatch):
    """A tiny gather budget forces the per-bucket reduce through the
    width-blocked (and, for wide hub chunks, the row-chunked) paths."""
    unblocked = _ell_vs_single()
    monkeypatch.setattr(port_pr, "_ELL_GATHER_BYTES", 4096)
    assert port_pr._bucket_plan(128, 64, 8, 4)[0] != "oneshot"
    blocked = _ell_vs_single()
    np.testing.assert_allclose(blocked, unblocked, rtol=ELL_RTOL, atol=ELL_ATOL)


def test_sharded_ell_ppr_tiled_batch_matches_single_device():
    """160 columns per shard at dp=1 cross the 128-column tile."""
    rng = np.random.default_rng(31)
    n, b = 600, 160
    src, dst = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    node_cap = round_up(n, 128)
    s2, d2, wn, dang = port_pr.normalize_symmetric_coo(src, dst, w, n, node_cap)
    coo_np = dict(src=s2, dst=d2, w_norm=wn, dangling=dang, num_nodes=np.asarray(n, np.int32))
    mesh = cpu_mesh(1, 4)
    sg = port_sharded.shard_graph_ell(port_pr.COOGraph(**coo_np), num_shards=4, bucket_widths=(4, 16, 64),
                                      hub_width=128)
    reset = random_resets(rng, b, 4 * sg.shard_nodes, n)
    got, iters = port_sharded.make_sharded_ppr_ell(mesh, max_iters=64)(
        port_sharded.put_sharded_ell(mesh, sg), torch.from_numpy(reset), return_iters=True)
    want = jax_single_coo(coo_np, reset[:, :node_cap])
    np.testing.assert_allclose(got.numpy()[:, :node_cap], want, rtol=ELL_RTOL, atol=ELL_ATOL)
    assert iters.shape == (b,) and len(set(iters[:128].tolist())) == 1 and len(set(iters[128:].tolist())) == 1


def test_shard_graph_ell_rejects_directed_operator():
    coo = port_pr.COOGraph(
        src=np.array([0, 1], np.int32), dst=np.array([1, 2], np.int32),
        w_norm=np.array([1.0, 1.0], np.float32), dangling=np.zeros(128, np.float32),
        num_nodes=np.asarray(3, np.int32),
    )
    with pytest.raises(ValueError, match="symmetrized"):
        port_sharded.shard_graph_ell(coo, num_shards=4)


def test_full_sharded_retrieval_pipeline_matches_single_device():
    """Sharded scoring + host seeds + sharded ELL PPR, document ranking parity
    with the JAX package's single-device pipeline on the same inputs."""
    from hipporag_tpu.models.retrieval import RetrievalIndex, graph_search_batch
    from hipporag_tpu_torch.parallel.seeds import build_reset_vectors

    rng = np.random.default_rng(33)
    n_entities, n_passages, n_facts, dim, b, k = 60, 12, 40, 128, 8, 5
    n_nodes = n_entities + n_passages
    node_cap = round_up(n_nodes + 1, 128)
    pad_slot = node_cap - 1
    edges = {}
    for _ in range(200):
        a, c = rng.integers(0, n_nodes, 2)
        if a != c:
            edges[(min(a, c), max(a, c))] = float(rng.uniform(0.2, 2.0))
    s, d, w = [], [], []
    for (a, c), wt in edges.items():
        s += [a, c]
        d += [c, a]
        w += [wt, wt]
    s, d, w = np.asarray(s), np.asarray(d), np.asarray(w)
    o = np.argsort(d, kind="stable")
    s, d, w = s[o], d[o], w[o]
    strength = np.zeros(n_nodes)
    np.add.at(strength, s, w)
    wp = (w / strength[s]).astype(np.float32)
    dang = np.zeros(node_cap, np.float32)
    dang[:n_nodes] = strength == 0
    ecap = round_up(len(s), 1024)
    sp, dp_ = np.zeros(ecap, np.int32), np.full(ecap, pad_slot, np.int32)
    wpp = np.zeros(ecap, np.float32)
    sp[: len(s)], dp_[: len(s)], wpp[: len(s)] = s, d, wp
    coo_np = dict(src=sp, dst=dp_, w_norm=wpp, dangling=dang, num_nodes=np.asarray(n_nodes, np.int32))

    fact_cap = round_up(n_facts, 128)
    fact_subj = np.full(fact_cap, pad_slot, np.int32)
    fact_obj = np.full(fact_cap, pad_slot, np.int32)
    fact_subj[:n_facts] = rng.integers(0, n_entities, n_facts)
    fact_obj[:n_facts] = rng.integers(0, n_entities, n_facts)
    pcap = round_up(n_passages, 128)
    passage_node_ids = np.full(pcap, pad_slot, np.int32)
    passage_node_ids[:n_passages] = np.arange(n_entities, n_nodes)
    chunk_counts = np.zeros(node_cap, np.float32)
    chunk_counts[:n_entities] = rng.integers(1, 4, n_entities)
    fact_emb = rng.standard_normal((fact_cap, dim)).astype(np.float32)
    fact_emb[n_facts:] = 0
    qf = rng.standard_normal((b, dim)).astype(np.float32)
    dpr = rng.standard_normal((b, pcap)).astype(np.float32)

    # the JAX package's single-device pipeline
    index = RetrievalIndex(
        graph=ref_pr.COOGraph(**{key: jnp.asarray(v) for key, v in coo_np.items()}),
        fact_subj_node=jnp.asarray(fact_subj), fact_obj_node=jnp.asarray(fact_obj),
        node_chunk_counts=jnp.asarray(chunk_counts), passage_node_ids=jnp.asarray(passage_node_ids),
        num_facts=jnp.asarray(n_facts, jnp.int32), num_passages=jnp.asarray(n_passages, jnp.int32),
    )
    _, vals, idx = ref_scoring.score_and_topk(jnp.asarray(qf), jnp.asarray(fact_emb),
                                              jnp.asarray(n_facts, jnp.int32), k)
    mask = (jnp.asarray(vals) > 0).astype(jnp.float32)
    want = np.asarray(graph_search_batch(index, vals, idx, mask, jnp.asarray(dpr), link_top_k=k,
                                         ppr_max_iters=96, ppr_tol=1e-10))[:, :n_passages]

    # the port's sharded pipeline
    mesh = cpu_mesh(2, 4)
    fpad = round_up(fact_cap, 4)
    fact_emb_p = np.zeros((fpad, dim), np.float32)
    fact_emb_p[:fact_cap] = fact_emb
    _, vals_s, idx_s = port_sharded.make_sharded_score_topk(mesh, k=k)(
        torch.from_numpy(qf), torch.from_numpy(fact_emb_p), n_facts)
    vals_s, idx_s = vals_s.numpy(), idx_s.numpy()
    np.testing.assert_array_equal(idx_s, np.asarray(idx))
    sge = port_sharded.shard_graph_ell(port_pr.COOGraph(**coo_np), num_shards=4, bucket_widths=(4, 16, 64))
    reset, _dprn, _has = build_reset_vectors(
        vals_s, idx_s, (vals_s > 0).astype(np.float32), dpr[:, :n_passages], fact_subj, fact_obj,
        passage_node_ids[:n_passages], chunk_counts, num_nodes=n_nodes, n_total=4 * sge.shard_nodes,
        link_top_k=k, passage_node_weight=0.05,
    )
    ranks = port_sharded.make_sharded_ppr_ell(mesh, max_iters=96, tol=1e-10, n_hub=sge.n_hub)(
        port_sharded.put_sharded_ell(mesh, sge), torch.from_numpy(reset)).numpy()
    np.testing.assert_allclose(ranks[:, passage_node_ids[:n_passages]], want, rtol=PIPELINE_RTOL,
                               atol=PIPELINE_ATOL)


def test_device_seed_builder_matches_host_twin():
    from hipporag_tpu_torch.models.retrieval import build_reset_batch
    from hipporag_tpu_torch.parallel.seeds import build_reset_vectors

    rng = np.random.default_rng(44)
    b, k, n_cap, n_facts, p = 6, 5, 256, 40, 10
    fact_subj = rng.integers(0, 100, n_facts).astype(np.int32)
    fact_obj = rng.integers(0, 100, n_facts).astype(np.int32)
    chunk_counts = rng.integers(0, 5, n_cap).astype(np.float32)
    passage_ids = np.arange(100, 100 + p, dtype=np.int32)
    top_idx = rng.integers(0, n_facts, (b, k)).astype(np.int32)
    top_mask = (rng.uniform(size=(b, k)) > 0.4).astype(np.float32)
    top_mask[2] = 0.0
    sel = (rng.uniform(0.1, 1.0, (b, k)) * top_mask).astype(np.float32)
    dpr_raw = rng.standard_normal((b, p)).astype(np.float32)
    host_reset, dpr_norm, _ = build_reset_vectors(
        sel, top_idx, top_mask, dpr_raw, fact_subj, fact_obj, passage_ids, chunk_counts,
        num_nodes=120, n_total=384, link_top_k=k,
    )
    t = torch.from_numpy
    dev_reset = build_reset_batch(t(sel), t(top_idx), t(top_mask), t(dpr_norm), t(fact_subj), t(fact_obj),
                                  t(chunk_counts), t(passage_ids), 120, n_total=384, link_top_k=k).numpy()
    np.testing.assert_allclose(dev_reset, host_reset, rtol=1e-6, atol=1e-7)


def test_halo_exchange_comm_scales_with_cut():
    """Bytes per iteration scale with the edge cut, not N_total: a
    near-block-diagonal graph gets a tiny halo, and the solve still matches
    the single-device solver."""
    rng = np.random.default_rng(5)
    n, b, shards = 2048, 8, 4
    per = n // shards
    src_l, dst_l = [], []
    for s in range(shards):
        lo = s * per
        src_l.append(rng.integers(lo, lo + per, 4000))
        dst_l.append(rng.integers(lo, lo + per, 4000))
    src_l.append(np.array([10, 600, 1100, 1700, 20, 1500]))
    dst_l.append(np.array([600, 1100, 1700, 10, 1040, 30]))
    src, dst = np.concatenate(src_l), np.concatenate(dst_l)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    coo_np = _symmetric_coo(src, dst, rng.uniform(0.5, 2.0, len(src)), n)

    sg = port_sharded.shard_graph_ell(port_pr.COOGraph(**coo_np), num_shards=shards)
    assert sg.halo_width <= 8, sg.halo_width
    assert sg.shard_nodes == 512
    assert shards * sg.halo_width * b * 4 < sg.shard_nodes * shards * b * 4 / 20
    mesh = cpu_mesh(2, 4)
    reset = random_resets(rng, b, shards * sg.shard_nodes, n)
    got = port_sharded.make_sharded_ppr_ell(mesh, max_iters=64)(
        port_sharded.put_sharded_ell(mesh, sg), torch.from_numpy(reset)).numpy()
    node_cap = coo_np["dangling"].shape[0]
    want = jax_single_coo(_symmetric_coo_padded(coo_np), reset[:, :node_cap])
    np.testing.assert_allclose(got[:, :node_cap], want, rtol=ELL_RTOL, atol=ELL_ATOL)


def test_adapter_sharded_training_matches_single_device_and_learns():
    dim, hidden, b = 16, 32, 8
    rng = np.random.default_rng(0)
    queries = rng.standard_normal((b, dim)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    positives = (queries @ rot.astype(np.float32)).astype(np.float32)
    opt = optax.adamw(1e-2)
    params0 = ref_adapter.init_adapter(jax.random.PRNGKey(0), dim, hidden)
    ref_step = ref_adapter.make_train_step(opt)
    p_ref, s_ref = params0, opt.init(params0)
    ref_losses = []
    for _ in range(5):
        p_ref, s_ref, loss = ref_step(p_ref, s_ref, queries, positives)
        ref_losses.append(float(loss))

    sh_step, place = port_adapter.make_sharded_train_step(cpu_mesh(2, 4), lambda ps: port_adapter.adamw(ps, 1e-2))
    p_sh, q_d, pos_d = place(adapter_params_from_jax(params0, "cpu"), torch.from_numpy(queries),
                             torch.from_numpy(positives))
    assert [tuple(t.shape) for t in p_sh.w_in] == [(dim, hidden // 4)] * 4
    assert [tuple(t.shape) for t in p_sh.w_out] == [(hidden // 4, dim)] * 4
    sh_losses = [float(sh_step(p_sh, q_d, pos_d)) for _ in range(5)]

    np.testing.assert_allclose(sh_losses, ref_losses, rtol=1e-4, atol=1e-5)
    w_in = torch.cat([t.detach() for t in p_sh.w_in], dim=1).numpy()
    np.testing.assert_allclose(w_in, np.asarray(p_ref.w_in), rtol=1e-4, atol=1e-5)
    assert sh_losses[-1] < sh_losses[0]


# ---------------------------------------------------------------------------
# Host builders and models: equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_host_builders_and_models_equal_jax(shards):
    coo_np, _ = hub_graph()
    padded = _symmetric_coo_padded(coo_np)
    got = port_sharded.shard_graph(port_pr.COOGraph(**padded), shards)
    want = ref_sharded.shard_graph(ref_pr.COOGraph(**padded), shards)
    for name in port_sharded.ShardedGraph._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name)

    kw = dict(bucket_widths=(4, 16, 64), hub_width=128)
    got = port_sharded.shard_graph_ell(port_pr.COOGraph(**coo_np), shards, **kw)
    want = ref_sharded.shard_graph_ell(ref_pr.COOGraph(**coo_np), shards, **kw)
    for name in port_sharded.ShardedELLGraph._fields:
        g, w = getattr(got, name), getattr(want, name)
        for a, b in zip(g, w) if isinstance(g, tuple) else [(g, w)]:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    for batch, dp in ((8, 1), (160, 2)):
        assert port_sharded.sharded_ell_counters(got, batch, dp) == ref_sharded.sharded_ell_counters(want, batch, dp)
    for kwargs in (dict(batch=8), dict(batch=256, dp=2, gather_budget_bytes=1 << 20)):
        shape = dict(num_shards=shards, shard_nodes=got.shard_nodes, n_slots=got.n_slots,
                     halo_width=got.halo_width, entries_per_device=12345, **kwargs)
        assert port_sharded.sharded_ell_hbm_estimate(**shape) == ref_sharded.sharded_ell_hbm_estimate(**shape)


# ---------------------------------------------------------------------------
# Shard-count invariance
# ---------------------------------------------------------------------------

MESHES = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (2, 4)]


@pytest.mark.parametrize("dp,corpus", MESHES)
def test_ell_ppr_invariant_to_shard_count(dp, corpus):
    coo_np, rng = hub_graph(seed=3)
    node_cap = coo_np["dangling"].shape[0]
    reset = random_resets(rng, 8, node_cap, int(coo_np["num_nodes"]))
    want = port_pr.batched_ppr_ell(
        port_pr.ell_from_coo(coo_np["src"], coo_np["dst"], coo_np["w_norm"], coo_np["dangling"],
                             int(coo_np["num_nodes"]), node_cap),
        torch.from_numpy(reset), max_iters=64).numpy()
    sg = port_sharded.shard_graph_ell(port_pr.COOGraph(**coo_np), num_shards=corpus)
    n_total = corpus * sg.shard_nodes
    r = np.zeros((8, n_total), np.float32)
    r[:, :node_cap] = reset
    got = port_sharded.make_sharded_ppr_ell(cpu_mesh(dp, corpus), max_iters=64)(
        port_sharded.put_sharded_ell(cpu_mesh(dp, corpus), sg), torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got[:, :node_cap], want, rtol=ELL_RTOL, atol=ELL_ATOL)
    assert not got[:, node_cap:].any()


@pytest.mark.parametrize("dp,corpus", MESHES)
def test_coo_ppr_invariant_to_shard_count(dp, corpus):
    coo_np, rng = hub_graph(seed=4)
    padded = _symmetric_coo_padded(coo_np)
    node_cap = coo_np["dangling"].shape[0]
    reset = random_resets(rng, 8, node_cap, int(coo_np["num_nodes"]))
    want = port_pr.batched_ppr(port_pr.COOGraph(**padded).to("cpu"), torch.from_numpy(reset), max_iters=64).numpy()
    mesh = cpu_mesh(dp, corpus)
    sg = port_sharded.put_sharded_graph(mesh, port_sharded.shard_graph(port_pr.COOGraph(**padded), corpus))
    r = np.zeros((8, corpus * sg.shard_nodes), np.float32)
    r[:, :node_cap] = reset
    run = port_sharded.make_sharded_ppr(mesh, max_iters=64)
    got = run(sg, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got[:, :node_cap], want, atol=COO_ATOL)
    np.testing.assert_array_equal(run(sg, torch.from_numpy(r)).numpy(), got)  # reruns are bit-identical


@pytest.mark.parametrize("dp,corpus", MESHES)
def test_scorer_invariant_to_shard_count(dp, corpus):
    rng = np.random.default_rng(12)
    q = rng.standard_normal((8, 48)).astype(np.float32)
    keys = rng.standard_normal((512, 48)).astype(np.float32)
    keys[100] = keys[7]  # an exact tie across shards: the lower index first
    q[0] = keys[7]
    mesh = cpu_mesh(dp, corpus)
    single, vals, idx = port_scoring.score_and_topk(torch.from_numpy(q), torch.from_numpy(keys), 500, 9)
    norm, s_vals, s_idx = port_sharded.make_sharded_score_topk(mesh, k=9)(
        torch.from_numpy(q), torch.from_numpy(keys), 500)
    np.testing.assert_allclose(norm.numpy(), single.numpy(), atol=SCORE_ATOL)
    np.testing.assert_array_equal(s_idx.numpy(), idx.numpy())
    np.testing.assert_allclose(s_vals.numpy(), vals.numpy(), atol=SCORE_ATOL)
    assert list(s_idx[0, :2].numpy()) == [7, 100]
    dpr = port_sharded.make_sharded_norm_scores(mesh)(torch.from_numpy(q), torch.from_numpy(keys), 500)
    np.testing.assert_array_equal(dpr.numpy(), norm.numpy())


def test_scorer_k_past_the_shard_rows_matches_jax():
    """k above one shard's rows: each shard offers all it has, the merge k
    is capped by the pool (sharded.py:265-273)."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    keys = rng.standard_normal((16, 16)).astype(np.float32)
    _, vals, idx = port_sharded.make_sharded_score_topk(cpu_mesh(2, 4), k=6)(
        torch.from_numpy(q), torch.from_numpy(keys), 14)
    _, jvals, jidx = ref_sharded.make_sharded_score_topk(jax_mesh(2, 4), k=6)(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(14))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=SCORE_ATOL)


# ---------------------------------------------------------------------------
# Mesh, placements and collectives
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_errors():
    mesh = port_mesh.make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 1, "corpus": 4} and mesh.devices.shape == (1, 4)
    mesh = port_mesh.make_mesh((2, 2), devices=["cpu"] * 4)
    assert (mesh.dp, mesh.corpus, mesh.size) == (2, 2, 4)
    with pytest.raises(ValueError, match="does not match"):
        port_mesh.make_mesh((1, 1), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="does not match"):
        ref_mesh.make_mesh((1, 1), devices=jax.devices()[:2])
    assert port_mesh.mesh_devices_for(3, "cpu") == [torch.device("cpu")] * 3
    assert port_mesh.mesh_devices_for(2, "cuda", ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        port_mesh.mesh_devices_for(2, "cpu", ["cpu"])


def test_placements_share_one_copy_per_device():
    mesh = port_mesh.make_mesh((2, 2), devices=["cpu"] * 4)
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    grid = port_mesh.corpus_sharded(mesh).place(x)
    # virtual shards of the device holding x: views of x, no copy
    assert all(grid[g][c].data_ptr() == x[4 * c].data_ptr() for g in range(2) for c in range(2))
    assert torch.equal(torch.cat(grid[1]), x)
    rows = port_mesh.batch_sharded(mesh).place(x)
    assert torch.equal(rows[1][0], x[4:]) and rows[1][0].data_ptr() == rows[1][1].data_ptr()
    rep = port_mesh.replicated(mesh).place(x)
    assert all(t.data_ptr() == x.data_ptr() for row in rep for t in row)
    cols = port_mesh.corpus_sharded(mesh, axis=1).place(x)
    assert torch.equal(torch.cat(cols[0], dim=1), x) and cols[0][0].is_contiguous()
    with pytest.raises(ValueError, match="divisible"):
        port_mesh.corpus_sharded(mesh).place(torch.zeros(5, 2))


def test_collectives_have_lax_semantics():
    c = 4
    xs = [torch.arange(c * 3, dtype=torch.float32).reshape(c, 3) + 100 * t for t in range(c)]
    recv = collectives.all_to_all(xs)
    for s in range(c):
        for t in range(c):
            assert torch.equal(recv[s][t], xs[t][s])  # receiver s block t == sender t block s
    gathered = collectives.all_gather([x[:1] for x in xs], axis=1)
    assert all(torch.equal(g, torch.cat([x[:1] for x in xs], dim=1)) for g in gathered)
    assert torch.equal(collectives.psum(xs)[2], sum(xs))
    assert torch.equal(collectives.pmax(xs)[0], xs[-1]) and torch.equal(collectives.pmin(xs)[3], xs[0])


# ---------------------------------------------------------------------------
# The dry run at a small size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dryrun_small():
    from hipporag_tpu_torch.parallel.dryrun import dryrun_multichip

    lines = []
    out = dryrun_multichip(4, devices=["cpu"] * 4, scale_nodes=16_384, scale_edges=60_000, log=lines.append)
    return out, lines


def test_dryrun_small(dryrun_small):
    out, lines = dryrun_small
    assert out["mesh"] == [2, 2] and len(lines) == 8
    assert 0.95 <= out["hbm_model"]["ratio"] <= 1.05
    assert out["capped_reduce_max_abs"] < 1e-6
    assert out["capacity"]["device_memory_bytes"] is None
    assert all(row["fits"] is None for row in out["capacity"]["table"])


def test_dryrun_weak_scaling_counters_equal_jax(dryrun_small):
    """The weak-scaling point (``__graft_entry__.dryrun_multichip``'s last
    section): 2 -> 4 shards at a fixed shard size, its counters equal to the
    JAX package's on the same clustered graph, and both of its checks hold."""
    import __graft_entry__

    out, lines = dryrun_small
    weak, scale = out["weak_scaling"], out["scale"]["counters"]
    assert weak["shards"] == [2, 4] and weak["nodes"] == 8_192
    coo = __graft_entry__._clustered_coo(8_192, 30_000, 2, seed=9)
    want = ref_sharded.sharded_ell_counters(ref_sharded.shard_graph_ell(coo, num_shards=2), 8, dp=1)
    assert weak["counters"] == want
    assert weak["directed_entries"] == len(coo.src)
    assert 0.7 <= weak["rows_ratio"] <= 1.4
    assert weak["rows_ratio"] == scale["rows_gathered_per_iter_device"] / want["rows_gathered_per_iter_device"]
    assert scale["halo_ici_bytes_per_iter_device"] * 5 < scale["allgather_ici_bytes_per_iter_device"]
    assert any(line.startswith("weak scaling ok") and "informational" in line for line in lines)


def test_dryrun_skips_weak_scaling_below_four_shards():
    from hipporag_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, devices=["cpu"] * 2, scale_nodes=4_096, scale_edges=12_000, log=lambda m: None)
    assert "weak_scaling" not in out and out["mesh"] == [2, 1]


def test_sample_data_equals_jax_module():
    from hipporag_tpu.utils import sample_data as ref_data
    from hipporag_tpu_torch.utils import sample_data as port_data

    for name in ("corpus", "all_queries", "gold_answers"):
        assert getattr(port_data, name) == getattr(ref_data, name)
