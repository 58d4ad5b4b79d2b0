"""The port's native graph core against the JAX package's and the NumPy paths.

``hipporag_tpu_torch/graph/native`` builds its own copy of
``graph_core.cpp`` (same flags) into ``build/graph_core/``. Its three
functions must equal the JAX package's native library array for array on
the same numpy-seeded inputs (``ppr_serial`` bit for bit), and the port's
NumPy paths that do the same work: ``GraphBuilder.symmetric_coo`` for
``coo_compile``, ``ops.pagerank.ell_from_coo`` for ``ell_pack``, and
``ppr_numpy_reference`` (dense float64, max-abs 1e-7) for ``ppr_serial``.
A library that does not build says so: ``native_available()`` is False
and every function returns None.
"""

import os

import numpy as np
import pytest

from hipporag_tpu.graph import native as ref_native
from hipporag_tpu_torch.graph import GraphBuilder
from hipporag_tpu_torch.graph import native
from hipporag_tpu_torch.ops import pagerank as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entries(num_nodes=80, num_entries=400, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_entries).astype(np.int32)
    dst = rng.integers(0, num_nodes, num_entries).astype(np.int32)
    w = rng.uniform(0.1, 2.0, num_entries).astype(np.float32)
    return src, dst, w


def test_library_builds_into_the_checkout():
    assert native.native_available(), native.build_error
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "graph_core")
    assert os.path.exists(path) and os.path.basename(path).startswith("libgraph_core-")


@pytest.mark.parametrize("normalize", [False, True])
def test_coo_compile_equals_jax_native(normalize):
    src, dst, w = _entries()
    got = native.coo_compile(src, dst, w, 80, normalize=normalize)
    want = ref_native.coo_compile(src, dst, w, 80, normalize=normalize)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_coo_compile_equals_the_builder_numpy_path():
    rng = np.random.default_rng(11)
    builder = GraphBuilder()
    names = [f"n{i}" for i in range(60)]
    builder.register_nodes(names)
    for _ in range(300):
        a, b = rng.integers(0, 60, 2)
        key = (names[a], names[b])
        builder.edge_weights[key] = builder.edge_weights.get(key, 0.0) + float(rng.uniform(0.1, 1.0))
    raw = [(builder.node_to_idx[a], builder.node_to_idx[b], w) for (a, b), w in builder.edge_weights.items()]
    s, d, w = (np.asarray(c) for c in zip(*raw))
    got = native.coo_compile(s, d, w, builder.num_nodes)[:3]
    for a, b in zip(got, builder.symmetric_coo()):
        np.testing.assert_array_equal(a, b)


def test_ppr_serial_equals_jax_native_and_the_dense_reference():
    n = 60
    src, dst, w = _entries(n, 300, seed=7)
    s, d, wn, strength = native.coo_compile(src, dst, w, n, normalize=True)
    dangling = (strength == 0).astype(np.float64)
    rng = np.random.default_rng(1)
    reset = rng.uniform(0, 1, n) * (rng.uniform(0, 1, n) > 0.6)
    ranks, iters = native.ppr_serial(s, d, wn, dangling, n, reset, 0.5, 200, 1e-12)
    want, want_iters = ref_native.ppr_serial(s, d, wn, dangling, n, reset, 0.5, 200, 1e-12)
    assert 0 < iters <= 200 and iters == want_iters
    np.testing.assert_array_equal(ranks, want)
    s_raw, d_raw, w_raw, _ = native.coo_compile(src, dst, w, n)
    dense = port.ppr_numpy_reference(n, list(zip(s_raw, d_raw, w_raw)), reset[None, :], damping=0.5)[0]
    assert np.abs(ranks - dense).max() <= 1e-7


def _hub_graph(n=500, seed=7):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, 4000), rng.integers(0, n, 900)])
    dst = np.concatenate([rng.integers(0, n, 4000), np.full(900, 7)])  # node 7 is a hub
    keep = src != dst
    node_cap = -(-n // 128) * 128
    return port.normalize_symmetric_coo(src[keep], dst[keep], rng.uniform(0.5, 2.0, keep.sum()), n, node_cap), n


def test_ell_pack_equals_jax_native_and_ell_from_coo():
    (s2, d2, wp, dang), n = _hub_graph()
    node_cap = dang.shape[0]
    widths, hub_width, row_multiple = (2, 8, 32), 64, 64
    got = native.ell_pack(s2, d2, wp, node_cap, widths, hub_width, row_multiple)
    want = ref_native.ell_pack(s2, d2, wp, node_cap, widths, hub_width, row_multiple)
    b_idx, b_wgt, hub_idx, hub_wgt, hub_seg, n_hub_cap, local_inv = got
    assert n_hub_cap == want[5] and n_hub_cap > 0
    for a, b in zip(b_idx + b_wgt, want[0] + want[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((hub_idx, hub_wgt, hub_seg, local_inv), want[2:5] + (want[6],)):
        np.testing.assert_array_equal(a, b)
    # the port's NumPy packing: the same layout, its gathers remapped to slot ids
    ell = port.ell_from_coo(s2, d2, wp, dang, n, node_cap, bucket_widths=widths, hub_width=hub_width,
                            row_multiple=row_multiple)
    np.testing.assert_array_equal(ell.local_inv.numpy(), local_inv)
    for slots, idx, wgt_np, wgt in zip(ell.bucket_idx, b_idx, ell.bucket_wgt, b_wgt):
        np.testing.assert_array_equal(slots.numpy(), local_inv[idx])
        np.testing.assert_array_equal(wgt_np.numpy(), wgt)
    np.testing.assert_array_equal(ell.hub_idx.numpy(), local_inv[hub_idx])
    np.testing.assert_array_equal(ell.hub_wgt.numpy(), hub_wgt)
    np.testing.assert_array_equal(ell.hub_seg.numpy(), hub_seg)


def test_unbuildable_library_says_so(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "libgraph_core-missing.so"))

    def no_toolchain(out):
        raise OSError("make: not found")

    monkeypatch.setattr(native, "_build", no_toolchain)
    assert not native.native_available()
    assert "make: not found" in native.build_error
    src, dst, w = _entries()
    assert native.coo_compile(src, dst, w, 80) is None
    assert native.ppr_serial(src, dst, w, np.zeros(80), 80, np.ones(80)) is None
    assert native.ell_pack(src, dst, w, 128, (4,), 8, 8) is None
