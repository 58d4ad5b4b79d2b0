"""The port's copy of the graph builder against the JAX package's builder.

Both builders get the same operations; their symmetrized COO arrays, their
padded device graphs and their pickles must be identical.
"""

import numpy as np
import pytest
import torch

from hipporag_tpu.graph import GraphBuilder as RefBuilder
from hipporag_tpu.graph import compile_device_graph as ref_compile
from hipporag_tpu.graph import pick_capacity as ref_pick_capacity
from hipporag_tpu_torch.graph import GraphBuilder, compile_device_graph, pick_capacity

torch.set_num_threads(1)


def _populate(builder, seed: int, n_chunks: int = 12, n_entities: int = 30):
    """Chunks with random triples, passage edges and random synonymy edges."""
    rng = np.random.default_rng(seed)
    names = [f"ent {i}" for i in range(n_entities)]
    chunk_ids = [f"chunk-{i}" for i in range(n_chunks)]
    chunk_triples = []
    for _ in chunk_ids:
        triples = []
        for _ in range(int(rng.integers(1, 5))):
            a, b = rng.choice(n_entities, 2, replace=False)
            triples.append((names[a], "rel", names[b]))
        chunk_triples.append(triples)
    builder.add_fact_edges(chunk_ids, chunk_triples)
    chunk_entities = [sorted({t[0] for t in ts} | {t[2] for t in ts}) for ts in chunk_triples]
    builder.add_passage_edges(chunk_ids, chunk_entities)
    from hipporag_tpu.utils.misc import compute_mdhash_id

    keys = [compute_mdhash_id(n, prefix="entity-") for n in names]
    contents = dict(zip(keys, names))
    order = np.argsort(-rng.random((n_entities, n_entities)), axis=1)
    scores = -np.sort(-rng.uniform(0.5, 1.0, (n_entities, n_entities)), axis=1)
    builder.add_synonymy_edges(keys, contents, order, scores, sim_threshold=0.8, max_neighbors=3)
    builder.register_nodes(keys)
    builder.register_nodes(chunk_ids)
    builder.mark_chunks_indexed(chunk_ids)
    return builder


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_symmetric_coo_identical(seed):
    ref = _populate(RefBuilder(), seed)
    port = _populate(GraphBuilder(), seed)
    for a, b in zip(ref.symmetric_coo(), port.symmetric_coo()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_compile_device_graph_identical():
    ref_graph, ref_nc, ref_ec = ref_compile(_populate(RefBuilder(), 3))
    graph, nc, ec = compile_device_graph(_populate(GraphBuilder(), 3))
    assert (nc, ec) == (ref_nc, ref_ec)
    for name in ("src", "dst", "w_norm", "dangling", "num_nodes"):
        np.testing.assert_array_equal(getattr(graph, name), np.asarray(getattr(ref_graph, name)))


def test_pickles_load_across_packages(tmp_path):
    ref = _populate(RefBuilder(), 4)
    ref.save(str(tmp_path / "ref.pickle"))
    port = GraphBuilder.load(str(tmp_path / "ref.pickle"))
    port.save(str(tmp_path / "port.pickle"))
    back = RefBuilder.load(str(tmp_path / "port.pickle"))
    for a, b in zip(ref.symmetric_coo(), back.symmetric_coo()):
        np.testing.assert_array_equal(a, b)
    assert port.node_names == ref.node_names
    assert port.edge_category == ref.edge_category


def test_empty_builder():
    for a, b in zip(RefBuilder().symmetric_coo(), GraphBuilder().symmetric_coo()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,current", [(0, None), (100, None), (127, 256), (300, 256)])
def test_pick_capacity_identical(n, current):
    assert pick_capacity(n, current, 1.25, 128) == ref_pick_capacity(n, current, 1.25, 128)
