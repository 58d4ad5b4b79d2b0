"""The port's COO and Chebyshev PPR and the other ``ops/pagerank.py``
additions against the JAX package.

Same numpy-seeded operators and resets through both packages: the toy
index of ``__graft_entry__`` and a 2k-node ``bench.build_synthetic_graph``
graph. Bounds: COO ``batched_ppr`` max-abs 1e-6 in f32 with equal
iteration counts (counted on the JAX side as the least ``max_iters`` that
reproduces its result, since its COO solver returns none); bfloat16
gathers 1e-4 at tol 1e-4 (both round p and the product to bfloat16, then
sum in f32; the order of the f32 sums differs, so now and then a gathered
value rounds to the neighbouring bfloat16, 2^-8 of it, and the iteration
carries that on, damped). At tol 1e-6 a
bfloat16 residual stalls above tol, and the stall exit then reads
rounding noise, so the bfloat16 case runs at tol 1e-4, where its
iteration counts are equal too.
Chebyshev: equal to the JAX package's Chebyshev to 1e-6 with equal
iteration counts, and to the power iteration's fixed point to 1e-9 at tol
1e-12 (the twin of ``tests/test_ops.py``'s Chebyshev test).
``ppr_numpy_reference`` is bit-equal; ``ell_hbm_estimate`` is checked
against the port's tensors' ``nbytes``; ``bucket_reduce_plan`` against the
port's ``_bucket_plan`` and the JAX package's plan.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipporag_tpu.ops import pagerank as ref
from hipporag_tpu_torch.convert import coo_from_numpy
from hipporag_tpu_torch.ops import pagerank as port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL, BF16_ATOL = 1e-6, 1e-4


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench_for_port_tests", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _toy_graph():
    import __graft_entry__

    index, _, _ = __graft_entry__._toy_index()
    return index.graph


def _synthetic_graph(num_nodes=2000, num_edges=20000, seed=0):
    """A padded COO operator as ``compile_device_graph`` lays it out:
    edges padded to a multiple of 1024 with weight-0 entries at the last node."""
    src, dst, w = _bench_module().build_synthetic_graph(num_nodes, num_edges, seed)
    node_cap = -(-(num_nodes + 1) // 128) * 128
    s2, d2, w2, dang = port.normalize_symmetric_coo(src, dst, w, num_nodes, node_cap)
    pad = -len(s2) % 1024
    return ref.COOGraph(
        src=np.pad(s2, (0, pad)), dst=np.pad(d2, (0, pad), constant_values=node_cap - 1),
        w_norm=np.pad(w2, (0, pad)), dangling=dang, num_nodes=np.asarray(num_nodes, np.int32),
    )


@pytest.fixture(scope="module", params=["toy", "synthetic2k"])
def graph(request):
    return _toy_graph() if request.param == "toy" else _synthetic_graph()


def _reset(node_cap, num_nodes, batch, seed):
    """Seeded resets with an all-zero row (uniform fallback), a row with
    NaNs and a row with negative entries."""
    rng = np.random.default_rng(seed)
    reset = np.zeros((batch, node_cap), np.float32)
    for i in range(batch):
        seeds = rng.choice(num_nodes, 5, replace=False)
        reset[i, seeds] = rng.uniform(0.1, 1.0, 5)
    reset[0] = 0.0
    reset[1, rng.choice(num_nodes, 3, replace=False)] = np.nan
    reset[2, rng.choice(num_nodes, 3, replace=False)] = -0.7
    return reset


def _jax_coo(graph):
    return ref.COOGraph(*(jnp.asarray(np.asarray(f)) for f in graph))


def _jax_coo_iters(g_jax, reset, tol, **kw):
    """The iteration count of the JAX COO solver: the least max_iters whose
    result equals the uncapped one bit for bit."""
    full = np.asarray(ref.batched_ppr(g_jax, reset, tol=tol, max_iters=64, **kw))
    for k in range(1, 65):
        if np.array_equal(np.asarray(ref.batched_ppr(g_jax, reset, tol=tol, max_iters=k, **kw)), full):
            return full, k
    raise AssertionError("no iteration count reproduces the JAX result")


@pytest.mark.parametrize("edge_chunks,compute_dtype", [(1, None), (3, None), (1, "bfloat16")])
def test_batched_ppr_coo_matches_jax(graph, edge_chunks, compute_dtype):
    n, cap = int(graph.num_nodes), graph.dangling.shape[0]
    reset = _reset(cap, n, 8, seed=edge_chunks)
    tol = 1e-4 if compute_dtype else 1e-6
    want, iters = _jax_coo_iters(_jax_coo(graph), jnp.asarray(reset), tol,
                                 compute_dtype=compute_dtype, edge_chunks=edge_chunks)
    got, got_iters = port.batched_ppr(
        coo_from_numpy(graph, "cpu"), torch.from_numpy(reset), tol=tol, max_iters=64,
        compute_dtype=compute_dtype, edge_chunks=edge_chunks, return_iters=True,
    )
    got = got.numpy()
    assert set(got_iters.tolist()) == {iters}
    assert np.abs(got - want).max() <= (BF16_ATOL if compute_dtype else F32_ATOL)
    assert np.isfinite(got).all()
    # each row's mass is 1, the zero row's too (uniform reset); bfloat16
    # gathers round away a few parts in 1e4 of it
    np.testing.assert_allclose(got[:, :n].sum(1), 1.0, atol=1e-2 if compute_dtype else 1e-4)
    for i in range(1, 8):
        np.testing.assert_array_equal(np.argsort(-want[i], kind="stable")[:10],
                                      np.argsort(-got[i], kind="stable")[:10])


def test_batched_ppr_coo_chunks_agree_and_tile():
    """200 queries run as two 128-column tiles, each with its own count;
    every chunking gives the same result to float32 rounding, and a second
    run is bit-identical."""
    graph = _synthetic_graph()
    reset = torch.from_numpy(_reset(graph.dangling.shape[0], int(graph.num_nodes), 200, seed=3))
    g = coo_from_numpy(graph, "cpu")
    p1, it1 = port.batched_ppr(g, reset, tol=1e-6, return_iters=True)
    p4, it4 = port.batched_ppr(g, reset, tol=1e-6, edge_chunks=4, return_iters=True)
    again = port.batched_ppr(g, reset, tol=1e-6)
    assert torch.equal(p1, again)
    assert torch.equal(it1, it4) and len(set(it1[:128].tolist())) == 1
    assert (p1 - p4).abs().max() <= 1e-7
    want = np.asarray(ref.batched_ppr(_jax_coo(graph), jnp.asarray(reset.numpy()), tol=1e-6))
    assert np.abs(p1.numpy() - want).max() <= F32_ATOL


def test_coo_matches_ell_solver(graph):
    n, cap = int(graph.num_nodes), graph.dangling.shape[0]
    reset = torch.from_numpy(_reset(cap, n, 6, seed=11))
    ell = port.ell_from_coo(graph.src, graph.dst, graph.w_norm, graph.dangling, n, cap)
    p_ell = port.batched_ppr_ell(ell, reset, tol=1e-8, max_iters=128)
    p_coo = port.batched_ppr(coo_from_numpy(graph, "cpu"), reset, tol=1e-8, max_iters=128)
    assert (p_ell - p_coo).abs().max() <= F32_ATOL


def _ell_pair(graph, **kw):
    args = (graph.src, graph.dst, graph.w_norm, graph.dangling, int(graph.num_nodes),
            graph.dangling.shape[0])
    return ref.ell_from_coo(*args, **kw), port.ell_from_coo(*args, **kw)


@pytest.mark.parametrize("batch", [8, 200])
def test_chebyshev_matches_jax(graph, batch):
    g_ref, g_port = _ell_pair(graph)
    reset = _reset(graph.dangling.shape[0], int(graph.num_nodes), batch, seed=batch + 1)
    want, it_want = ref.batched_ppr_ell(g_ref, jnp.asarray(reset), tol=1e-6, accel="chebyshev",
                                        return_iters=True)
    got, it_got = port.batched_ppr_ell(g_port, torch.from_numpy(reset), tol=1e-6, accel="chebyshev",
                                       return_iters=True)
    np.testing.assert_array_equal(np.asarray(it_want), it_got.numpy())
    assert np.abs(np.asarray(want) - got.numpy()).max() <= F32_ATOL


def test_chebyshev_reaches_the_power_fixed_point():
    """The port's twin of tests/test_ops.py::test_batched_ppr_ell_chebyshev_matches_power."""
    rng = np.random.default_rng(13)
    n, b = 400, 4
    src = rng.integers(0, n, 3000)
    dst = rng.integers(0, n, 3000)
    keep = src != dst
    node_cap = -(-n // 128) * 128
    s2, d2, w2, dang = port.normalize_symmetric_coo(src[keep], dst[keep], rng.uniform(0.5, 2.0, keep.sum()),
                                                    n, node_cap)
    ell = port.ell_from_coo(s2, d2, w2, dang, n, node_cap, bucket_widths=(4, 16, 64))
    reset = np.zeros((b, node_cap), np.float32)
    for i in range(b):
        reset[i, rng.integers(0, n, 3)] = rng.uniform(0.3, 1.0, 3)
    reset = torch.from_numpy(reset)
    power = port.batched_ppr_ell(ell, reset, accel="power", max_iters=128, tol=1e-12)
    cheb = port.batched_ppr_ell(ell, reset, accel="chebyshev", max_iters=128, tol=1e-12)
    np.testing.assert_allclose(cheb.numpy(), power.numpy(), rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        port.batched_ppr_ell(ell, reset, accel="anderson")


def test_ppr_numpy_reference_bit_equal():
    rng = np.random.default_rng(2)
    n = 40
    edges = [(int(u), int(v), float(w)) for u, v, w in
             zip(rng.integers(0, n, 120), rng.integers(0, n, 120), rng.uniform(0.1, 2.0, 120))]
    reset = rng.uniform(-0.2, 1.0, (3, n))
    reset[1, 5] = np.nan
    reset[2] = 0.0
    np.testing.assert_array_equal(ref.ppr_numpy_reference(n, edges, reset, 0.5, 50),
                                  port.ppr_numpy_reference(n, edges, reset, 0.5, 50))


@pytest.mark.parametrize("batch", [8, 300])
def test_ell_hbm_estimate_counts_the_port_tensors(graph, batch):
    g_ref, g_port = _ell_pair(graph, bucket_widths=(4, 16, 64), hub_width=128)
    est = port.ell_hbm_estimate(g_port, batch)
    tensors = [*g_port.bucket_idx, *g_port.bucket_wgt] + [
        getattr(g_port, f) for f in port.ELLGraph._fields if f not in ("bucket_idx", "bucket_wgt")]
    assert est["operator_bytes"] == sum(t.nbytes for t in tensors)
    # the JAX model counts the same arrays but hub_zero and num_nodes
    ref_est = ref.ell_hbm_estimate(g_ref, batch)
    assert est["operator_bytes"] == ref_est["operator_bytes"] + g_port.hub_zero.nbytes + g_port.num_nodes.nbytes
    hub_rows = port._hub_rows(g_port)
    assert hub_rows.dtype == torch.int64 and est["hub_rows_bytes"] == hub_rows.nbytes
    b_tile = min(batch, port._PPR_BATCH_TILE)
    assert est["state_bytes"] == 5 * g_port.slot_to_node.shape[0] * b_tile * 4
    assert est["io_bytes"] == 2 * batch * g_port.local_inv.shape[0] * 4
    # the largest gathered block is what _bucket_reduce forms for the widest part
    p = torch.zeros(g_port.slot_to_node.shape[0], b_tile)
    blocks = [p[idx].nbytes for idx in g_port.bucket_idx] + [p[g_port.hub_idx].nbytes if g_port.hub_idx.shape[0] else 0]
    assert est["gather_temp_bytes"] == max(blocks + [hub_rows.numel() * b_tile * 4])
    assert est["total_bytes"] == sum(est[k] for k in ("operator_bytes", "hub_rows_bytes", "state_bytes",
                                                      "gather_temp_bytes", "io_bytes"))


def test_bucket_reduce_plan_follows_bucket_plan(graph, monkeypatch):
    g_ref, g_port = _ell_pair(graph, bucket_widths=(4, 16, 64), hub_width=128)
    kinds = set()
    # the default budget, one that width-blocks the larger buckets, one that row-chunks
    for budget in (2 << 30, 1 << 18, 4096):
        monkeypatch.setattr(port, "_ELL_GATHER_BYTES", budget)
        monkeypatch.setattr(ref, "_ELL_GATHER_BYTES", budget)
        for itemsize in (4, 2):
            plan = port.bucket_reduce_plan(g_port, 128, itemsize)
            assert plan == ref.bucket_reduce_plan(g_ref, 128, itemsize)
            parts = list(zip(g_port.bucket_idx, g_port.bucket_wgt)) + [(g_port.hub_idx, g_port.hub_wgt)]
            for line, (idx, _) in zip(plan, parts):
                path, _param = port._bucket_plan(idx.shape[0], idx.shape[1], 128, itemsize)
                assert path in line
                kinds.add(path)
    assert {"oneshot", "rowchunk"} <= kinds


def test_coo_graph_to_device_tensors(graph):
    g = port.COOGraph(*(np.asarray(f) for f in graph)).to("cpu")
    for name in port.COOGraph._fields:
        value = getattr(g, name)
        assert isinstance(value, torch.Tensor)
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(graph, name)))
