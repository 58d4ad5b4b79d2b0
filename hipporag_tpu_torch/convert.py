"""Carry state from the JAX package over to the port.

The retrieval index (graph operator, fact/passage node maps, chunk counts)
is this system's state; the encoder's parameter pytree is its one model.
``index_from_numpy`` and ``encoder_params_from_jax`` read every leaf with
``np.asarray``, so they take the JAX package's arrays as well as plain
NumPy, and never import JAX themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from .embedding.encoder import BertEncoder
from .models.retrieval import RetrievalIndex
from .ops.pagerank import ELLGraph


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def ell_from_numpy(graph, device) -> ELLGraph:
    """A reference ``ELLGraph`` (any array type) as the port's ELLGraph on ``device``."""
    return ELLGraph(
        bucket_idx=tuple(_tensor(i, device) for i in graph.bucket_idx),
        bucket_wgt=tuple(_tensor(w, device) for w in graph.bucket_wgt),
        hub_idx=_tensor(graph.hub_idx, device),
        hub_wgt=_tensor(graph.hub_wgt, device),
        hub_seg=_tensor(graph.hub_seg, device),
        hub_zero=_tensor(graph.hub_zero, device),
        local_inv=_tensor(graph.local_inv, device),
        slot_to_node=_tensor(graph.slot_to_node, device),
        dangling=_tensor(graph.dangling, device),
        num_nodes=_tensor(graph.num_nodes, device),
    )


def index_from_numpy(index, device) -> RetrievalIndex:
    """A reference ``RetrievalIndex`` over an ``ELLGraph`` as the port's index on ``device``."""
    if not hasattr(index.graph, "bucket_idx"):
        raise NotImplementedError("index_from_numpy: only the ELL operator is ported")
    return RetrievalIndex(
        graph=ell_from_numpy(index.graph, device),
        fact_subj_node=_tensor(index.fact_subj_node, device),
        fact_obj_node=_tensor(index.fact_obj_node, device),
        node_chunk_counts=_tensor(index.node_chunk_counts, device),
        passage_node_ids=_tensor(index.passage_node_ids, device),
        num_facts=int(np.asarray(index.num_facts)),
        num_passages=int(np.asarray(index.num_passages)),
    )


def encoder_params_from_jax(params, num_heads: int, compute_dtype: str = "bfloat16",
                            device="cuda") -> BertEncoder:
    """The JAX package's encoder pytree (``jax_encoder.params_random`` or
    ``params_from_hf_bert``) as the port's encoder on ``device``."""
    def leaf(x):
        return np.array(x, dtype=np.float32, copy=True)

    host = {k: leaf(v) for k, v in params.items() if k != "layers"}
    host["layers"] = [{k: leaf(v) for k, v in layer.items()} for layer in params["layers"]]
    return BertEncoder(host, num_heads, compute_dtype, device)
