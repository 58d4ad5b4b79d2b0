"""The port's seeds, graph search and document ranking against the JAX package.

Both run on the toy index of ``__graft_entry__`` (an ELL operator carried
over with ``convert.index_from_numpy``); doc scores must agree to 1e-6,
including a query with no kept facts (the DPR fallback) and phrase-weight
ties at the ``link_top_k`` cut (ties go to the lower node index).
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

torch.set_num_threads(1)

B, K = 6, 5


@pytest.fixture(scope="module")
def toy():
    import __graft_entry__

    index, fact_emb, passage_emb = __graft_entry__._toy_index()
    g = index.graph
    ell = ref_ell_from_coo(
        np.asarray(g.src), np.asarray(g.dst), np.asarray(g.w_norm), np.asarray(g.dangling),
        int(g.num_nodes), g.dangling.shape[0],
    )
    index = index._replace(graph=ell)
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


def test_index_from_numpy_carries_every_leaf(toy):
    index = toy[0]
    port = index_from_numpy(index, "cpu")
    for a, b in zip(index.graph.bucket_idx, port.graph.bucket_idx):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for name in ("fact_subj_node", "fact_obj_node", "node_chunk_counts", "passage_node_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(index, name)), getattr(port, name).numpy())
    assert port.num_facts == int(index.num_facts) and port.num_passages == int(index.num_passages)


def test_graph_search_batch_refuses_coo(toy):
    p_index, sel, idx, mask, dpr = _port_args(toy)
    with pytest.raises(NotImplementedError):
        retrieval.graph_search_batch(p_index._replace(graph=object()), sel, idx, mask, dpr)
