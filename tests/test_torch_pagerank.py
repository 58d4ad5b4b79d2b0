"""The port's bucketed-ELL packing and batched PPR against the JAX package.

Layouts must be equal array for array; PPR must agree to 1e-6 at tol 1e-6
with equal per-tile iteration counts and identical top-20 ranks, on the
toy index of ``__graft_entry__`` and a 2k-node ``bench.build_synthetic_graph``
graph. Inputs are numpy arrays made from a seed.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipporag_tpu.ops import pagerank as ref
from hipporag_tpu_torch.ops import pagerank as port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench_for_port_tests", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _toy_coo():
    import __graft_entry__

    index, _, _ = __graft_entry__._toy_index()
    g = index.graph
    return (np.asarray(g.src), np.asarray(g.dst), np.asarray(g.w_norm),
            np.asarray(g.dangling), int(g.num_nodes), g.dangling.shape[0])


def _synthetic_coo(num_nodes=2000, num_edges=20000, seed=0):
    src, dst, w = _bench_module().build_synthetic_graph(num_nodes, num_edges, seed)
    node_cap = -(-(num_nodes + 1) // 128) * 128
    s2, d2, w2, dang = port.normalize_symmetric_coo(src, dst, w, num_nodes, node_cap)
    return s2, d2, w2, dang, num_nodes, node_cap


@pytest.fixture(scope="module", params=["toy", "synthetic2k"])
def coo(request):
    return _toy_coo() if request.param == "toy" else _synthetic_coo()


def test_normalize_symmetric_coo_identical():
    src, dst, w = _bench_module().build_synthetic_graph(500, 4000, 1)
    for a, b in zip(ref.normalize_symmetric_coo(src, dst, w, 500, 640),
                    port.normalize_symmetric_coo(src, dst, w, 500, 640)):
        np.testing.assert_array_equal(a, b)


def _assert_same_layout(g_ref, g_port):
    assert len(g_ref.bucket_idx) == len(g_port.bucket_idx)
    for name in ("bucket_idx", "bucket_wgt"):
        for a, b in zip(getattr(g_ref, name), getattr(g_port, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for name in ("hub_idx", "hub_wgt", "hub_seg", "hub_zero", "local_inv", "slot_to_node",
                 "dangling", "num_nodes"):
        a, b = np.asarray(getattr(g_ref, name)), getattr(g_port, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ref.ell_caps(g_ref) == port.ell_caps(g_port)
    assert ref.ell_gathered_rows_per_iter(g_ref) == port.ell_gathered_rows_per_iter(g_port)


@pytest.mark.parametrize("kwargs", [{}, {"bucket_widths": (4, 16, 64), "hub_width": 128}])
def test_ell_layout_identical(coo, kwargs):
    _assert_same_layout(ref.ell_from_coo(*coo, **kwargs), port.ell_from_coo(*coo, **kwargs))


def test_ell_layout_identical_with_min_caps(coo):
    caps = port.ell_caps(port.ell_from_coo(*coo))
    grown = {
        "bucket_rows": tuple(c + 128 for c in caps["bucket_rows"]),
        "hub_rows": caps["hub_rows"] + 128,
        "n_hub_cap": caps["n_hub_cap"] + 128,
    }
    _assert_same_layout(ref.ell_from_coo(*coo, min_caps=grown), port.ell_from_coo(*coo, min_caps=grown))


def test_directed_operator_rejected():
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 2], np.int32)
    w = np.ones(2, np.float32)
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.ell_from_coo(src, dst, w, np.zeros(128, np.float32), 3, 128)


def _reset(node_cap, num_nodes, batch, seed):
    rng = np.random.default_rng(seed)
    reset = np.zeros((batch, node_cap), np.float32)
    for i in range(batch):
        seeds = rng.choice(num_nodes, 5, replace=False)
        reset[i, seeds] = rng.uniform(0.1, 1.0, 5)
    reset[0] = 0.0  # an all-zero row falls back to the uniform reset
    return reset


@pytest.mark.parametrize("batch", [8, 200])
def test_batched_ppr_ell_matches_jax(coo, batch):
    reset = _reset(coo[5], coo[4], batch, seed=batch)
    g_ref = ref.ell_from_coo(*coo)
    p_ref, it_ref = ref.batched_ppr_ell(
        g_ref, jnp.asarray(reset), damping=0.5, tol=1e-6, max_iters=64, return_iters=True
    )
    p_port, it_port = port.batched_ppr_ell(
        port.ell_from_coo(*coo), torch.from_numpy(reset), damping=0.5, tol=1e-6,
        max_iters=64, return_iters=True,
    )
    p_ref, p_port = np.asarray(p_ref), p_port.numpy()
    np.testing.assert_array_equal(np.asarray(it_ref), it_port.numpy())
    assert np.abs(p_ref - p_port).max() <= 1e-6
    for i in range(batch):
        np.testing.assert_array_equal(
            np.argsort(-p_ref[i], kind="stable")[:20], np.argsort(-p_port[i], kind="stable")[:20]
        )


def test_batched_ppr_ell_against_dense_reference():
    s, d, w, dang, n, cap = _toy_coo()
    real = w != 0
    # each source's w_norm sums to 1, so the dense reference's row
    # normalization leaves the operator as it is
    edges = list(zip(s[real], d[real], w[real]))
    reset = _reset(cap, n, 4, seed=5)[1:]
    p = port.batched_ppr_ell(port.ell_from_coo(s, d, w, dang, n, cap), torch.from_numpy(reset),
                             damping=0.5, tol=1e-8, max_iters=200).numpy()
    dense = ref.ppr_numpy_reference(n, edges, reset[:, :n], damping=0.5, iters=200)
    assert np.abs(p[:, :n] - dense).max() <= 1e-6


@pytest.mark.parametrize(
    "err,prev,prev2",
    [(5e-5, 5e-5, 5e-5), (5e-5, 1e-4, 2e-4), (1e-3, 1e-3, 1e-3), (np.inf, np.inf, np.inf)],
)
def test_stall_exit_matches_jax(err, prev, prev2):
    f32 = np.float32
    got = port._stalled2(f32(err), f32(prev), f32(prev2), 1e-6, 0.5)
    want = bool(ref._stalled2(jnp.float32(err), jnp.float32(prev), jnp.float32(prev2), 1e-6, 0.5))
    assert got == want
