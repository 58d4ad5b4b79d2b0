"""The port's seeds, graph search and document ranking against the JAX package.

Both run on the toy index of ``__graft_entry__`` (its ELL operator, or its
COO operator as it comes, carried over with ``convert.index_from_numpy``);
doc scores must agree to 1e-6 (1e-4 with bfloat16 PPR gathers), including
a query with no kept facts (the DPR fallback) and phrase-weight ties at
the ``link_top_k`` cut (ties go to the lower node index). The full
``rank_documents`` order and ``build_reset_batch`` (with ``n_total``
padding and cutting) must equal the JAX package's exactly, and the seed
matrix must equal its host twin, ``parallel.seeds.build_reset_vectors``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipporag_tpu.models import retrieval as ref
from hipporag_tpu.ops.pagerank import ell_from_coo as ref_ell_from_coo
from hipporag_tpu.ops.scoring import score_and_topk as ref_score_and_topk
from hipporag_tpu_torch.convert import index_from_numpy
from hipporag_tpu_torch.models import retrieval
from hipporag_tpu_torch.ops.pagerank import COOGraph

torch.set_num_threads(1)

B, K = 6, 5


def _toy_inputs(coo: bool):
    import __graft_entry__

    index, fact_emb, passage_emb = __graft_entry__._toy_index()
    g = index.graph
    ell = ref_ell_from_coo(
        np.asarray(g.src), np.asarray(g.dst), np.asarray(g.w_norm), np.asarray(g.dangling),
        int(g.num_nodes), g.dangling.shape[0],
    )
    index = index._replace(graph=g if coo else ell)
    rng = np.random.default_rng(1)
    qf = rng.standard_normal((B, fact_emb.shape[1])).astype(np.float32)
    qp = rng.standard_normal((B, fact_emb.shape[1])).astype(np.float32)
    _s, vals, idx = ref_score_and_topk(
        jnp.asarray(qf), jnp.asarray(fact_emb), jnp.asarray(index.num_facts), K
    )
    sel = np.asarray(vals).copy()
    top_idx = np.asarray(idx).astype(np.int32)
    mask = (sel > 0).astype(np.float32)
    mask[1] = 0.0  # no kept facts: DPR fallback
    # tied phrase weights across more endpoints than link_top_k keeps
    sel[2] = 0.5
    top_idx[3, 1:] = top_idx[3, 0]  # one fact repeated: colliding contributions
    dpr = (qp @ passage_emb.T).astype(np.float32)
    return index, sel, top_idx, mask, dpr


@pytest.fixture(scope="module")
def toy():
    return _toy_inputs(coo=False)


@pytest.fixture(scope="module")
def toy_coo():
    return _toy_inputs(coo=True)


def _port_args(toy):
    index, sel, top_idx, mask, dpr = toy
    return (index_from_numpy(index, "cpu"), torch.from_numpy(sel), torch.from_numpy(top_idx),
            torch.from_numpy(mask), torch.from_numpy(dpr))


@pytest.mark.parametrize("link_top_k", [3, 5])
def test_phrase_seed_weights_equal_jax(toy, link_top_k):
    index, sel, top_idx, mask, _dpr = toy
    want, _rows = ref._phrase_seed_weights(
        jnp.asarray(sel), jnp.asarray(top_idx), jnp.asarray(mask),
        jnp.asarray(index.fact_subj_node), jnp.asarray(index.fact_obj_node),
        jnp.asarray(index.node_chunk_counts), jnp.asarray(index.graph.num_nodes), link_top_k,
    )
    p_index, p_sel, p_idx, p_mask, _ = _port_args(toy)
    got = retrieval._phrase_seed_weights(
        p_sel, p_idx, p_mask, p_index.fact_subj_node, p_index.fact_obj_node,
        p_index.node_chunk_counts, int(p_index.graph.num_nodes), link_top_k,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got[2] > 0).sum()) == link_top_k  # the tie was cut at link_top_k


@pytest.mark.parametrize("link_top_k", [3, 5])
def test_graph_search_batch_matches_jax(toy, link_top_k):
    index, sel, top_idx, mask, dpr = toy
    want = np.asarray(ref.graph_search_batch(
        jax.tree.map(jnp.asarray, index), jnp.asarray(sel), jnp.asarray(top_idx),
        jnp.asarray(mask), jnp.asarray(dpr), link_top_k=link_top_k, ppr_tol=1e-6,
    ))
    got = retrieval.graph_search_batch(*_port_args(toy), link_top_k=link_top_k, ppr_tol=1e-6)
    got = got.numpy()
    valid = np.isfinite(want)
    np.testing.assert_array_equal(valid, np.isfinite(got))
    assert np.abs(got[valid] - want[valid]).max() <= 1e-6
    # the DPR fallback row is the normalized DPR score itself
    n_p = int(index.num_passages)
    row = dpr[1, :n_p]
    np.testing.assert_allclose(got[1, :n_p], (row - row.min()) / (row.max() - row.min()), rtol=1e-6)


def test_rank_documents_topk_matches_jax_with_ties():
    rng = np.random.default_rng(2)
    scores = rng.integers(0, 5, (4, 64)).astype(np.float32)
    scores[:, 60:] = -np.inf
    idx, vals = retrieval.rank_documents_topk(torch.from_numpy(scores), 20)
    j_idx, j_vals = ref.rank_documents_topk(jnp.asarray(scores), 20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    idx, _ = retrieval.rank_documents_topk(torch.from_numpy(scores), 200)
    assert idx.shape == (4, 64)


def test_index_from_numpy_carries_every_leaf(toy, toy_coo):
    index = toy[0]
    port = index_from_numpy(index, "cpu")
    for a, b in zip(index.graph.bucket_idx, port.graph.bucket_idx):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    coo = index_from_numpy(toy_coo[0], "cpu").graph
    for name in COOGraph._fields:
        np.testing.assert_array_equal(np.asarray(getattr(toy_coo[0].graph, name)), getattr(coo, name).numpy())
    for name in ("fact_subj_node", "fact_obj_node", "node_chunk_counts", "passage_node_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(index, name)), getattr(port, name).numpy())
    assert port.num_facts == int(index.num_facts) and port.num_passages == int(index.num_passages)


def test_graph_search_batch_refuses_coo(toy_coo):
    """The COO operator is no longer refused: graph search over it equals
    the JAX package's COO path, and the ELL path on the same index."""
    index, sel, top_idx, mask, dpr = toy_coo
    want = np.asarray(ref.graph_search_batch(
        jax.tree.map(jnp.asarray, index), jnp.asarray(sel), jnp.asarray(top_idx),
        jnp.asarray(mask), jnp.asarray(dpr), ppr_tol=1e-6,
    ))
    p_index = index_from_numpy(index, "cpu")
    assert isinstance(p_index.graph, COOGraph)
    got = retrieval.graph_search_batch(p_index, *_port_args(toy_coo)[1:], ppr_tol=1e-6).numpy()
    valid = np.isfinite(want)
    np.testing.assert_array_equal(valid, np.isfinite(got))
    assert np.abs(got[valid] - want[valid]).max() <= 1e-6
    ell = retrieval.graph_search_batch(*_port_args(_toy_inputs(coo=False)), ppr_tol=1e-6).numpy()
    assert np.abs(got[valid] - ell[valid]).max() <= 1e-6


@pytest.mark.parametrize("link_top_k,chunks,ppr_dtype", [(3, 1, "float32"), (5, 3, "float32"),
                                                         (5, 1, "bfloat16")])
def test_graph_search_batch_coo_matches_jax(toy_coo, link_top_k, chunks, ppr_dtype):
    index, sel, top_idx, mask, dpr = toy_coo
    want = np.asarray(ref.graph_search_batch(
        jax.tree.map(jnp.asarray, index), jnp.asarray(sel), jnp.asarray(top_idx),
        jnp.asarray(mask), jnp.asarray(dpr), link_top_k=link_top_k, ppr_tol=1e-6,
        ppr_dtype=ppr_dtype, ppr_edge_chunks=chunks,
    ))
    got, iters = retrieval.graph_search_batch(
        *_port_args(toy_coo), link_top_k=link_top_k, ppr_tol=1e-6, ppr_dtype=ppr_dtype,
        ppr_edge_chunks=chunks, return_iters=True,
    )
    got = got.numpy()
    valid = np.isfinite(want)
    np.testing.assert_array_equal(valid, np.isfinite(got))
    assert np.abs(got[valid] - want[valid]).max() <= (1e-4 if ppr_dtype == "bfloat16" else 1e-6)
    assert iters.shape == (B,) and int(iters[0]) > 0


def test_rank_documents_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 5, (4, 64)).astype(np.float32)
    scores[:, 50:] = -np.inf
    order, vals = retrieval.rank_documents(torch.from_numpy(scores))
    j_order, j_vals = ref.rank_documents(jnp.asarray(scores))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


@pytest.mark.parametrize("extra_cols", [-64, 0, 256])
def test_build_reset_batch_matches_jax_and_host_twin(toy, extra_cols):
    from hipporag_tpu_torch.parallel.seeds import build_reset_vectors

    index, sel, top_idx, mask, dpr = toy
    n_p, n_cap = int(index.num_passages), index.node_chunk_counts.shape[0]
    n_total = n_cap + extra_cols
    raw = dpr[:, :n_p]
    dpr_norm = ((raw - raw.min(1, keepdims=True)) / np.ptp(raw, axis=1, keepdims=True)).astype(np.float32)
    pids = np.asarray(index.passage_node_ids)[:n_p]
    args = (sel, top_idx, mask, dpr_norm, np.asarray(index.fact_subj_node), np.asarray(index.fact_obj_node),
            np.asarray(index.node_chunk_counts), pids)
    want = np.asarray(ref.build_reset_batch(*map(jnp.asarray, args), jnp.asarray(index.graph.num_nodes),
                                            n_total=n_total, link_top_k=5))
    got = retrieval.build_reset_batch(*map(torch.from_numpy, args), int(index.graph.num_nodes),
                                      n_total=n_total, link_top_k=5).numpy()
    assert got.shape == (B, n_total)
    np.testing.assert_array_equal(got, want)
    twin, _norm, has_facts = build_reset_vectors(
        sel, top_idx, mask, raw, args[4], args[5], pids, args[6], int(index.graph.num_nodes),
        max(n_total, n_cap), 5)
    np.testing.assert_allclose(got, twin[:, :n_total], rtol=1e-6, atol=1e-7)
    assert not has_facts[1] and has_facts[0]
