"""Synthetic multi-hop chain eval: graph vs dense on 2-hop and 3-hop
bridge chains.

The central HippoRAG capability claim in miniature (reference protocol:
the reference HippoRAG.py:413-499): 2-hop questions where
dense retrieval lacks a lexical bridge to the second document, and a
3-hop (MuSiQue-style) composition where the deep document carries only
~damping^2 of the seed mass. The port's copy of
``hipporag_tpu/evaluation/multihop.py``, run on an explicit ``device``.
"""

import os
import tempfile

N_CHAINS = 12


def run_multihop_eval(save_dir: str | None = None, device="cuda") -> dict:
    """Run the 2-hop and 3-hop chain evals with mock providers.

    Returns a flat dict of the four bench fields. The 3-hop add-on is
    best-effort: its failure is recorded in ``multihop3_error`` instead
    of discarding the already-landed 2-hop numbers.
    """
    import shutil

    from .. import BaseConfig, HippoRAG, StandardRAG

    root = save_dir or tempfile.mkdtemp()
    own_root = save_dir is None
    # the in-memory store: the harness reads nothing back from disk, and
    # the port runs where no parquet library is installed
    cfg = dict(llm_name="mock", embedding_model_name="mock", ppr_batch_size=16,
               vector_store_type="memory")

    def _dir(name):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        return d

    res: dict = {}
    try:
        # ---- 2-hop chains: Alpha_i -> Bridge_i -> Omega_i ----
        qdocs, qqs, qgold = [], [], []
        for i in range(N_CHAINS):
            a, bb, c = f"Alpha{i}", f"Bridge{i}", f"Omega{i}"
            d1, d2 = f"{a} is linked to {bb}.", f"{bb} is linked to {c}."
            qdocs += [d1, d2]
            qqs.append(f"What does {a} eventually reach?")
            qgold.append([d1, d2])
        dense = StandardRAG(
            global_config=BaseConfig(save_dir=_dir("mh2_dense"), **cfg), device=device
        )
        dense.index(qdocs)
        _, dense_overall = dense.retrieve(qqs, gold_docs=qgold)
        g = HippoRAG(global_config=BaseConfig(save_dir=_dir("mh2_graph"), **cfg), device=device)
        g.index(qdocs)
        _, graph_overall = g.retrieve(qqs, gold_docs=qgold)
        res["multihop_recall2_graph"] = graph_overall["Recall@2"]
        res["multihop_recall2_dense"] = dense_overall["Recall@2"]

        # ---- 3-hop composition: fraction of chains whose third-hop doc
        # surfaces in the top 5 of the 36-doc corpus ----
        try:
            qdocs3, qqs3, qdeep = [], [], []
            for i in range(N_CHAINS):
                a, bb, c, dd = (
                    f"Alpha{i}", f"Bridge{i}", f"Middle{i}", f"Omega{i}"
                )
                chain = [
                    f"{a} is linked to {bb}.",
                    f"{bb} is linked to {c}.",
                    f"{c} is linked to {dd}.",
                ]
                qdocs3 += chain
                qqs3.append(f"What does {a} eventually reach?")
                qdeep.append(chain[2])
            dense3 = StandardRAG(
                global_config=BaseConfig(save_dir=_dir("mh3_dense"), **cfg), device=device
            )
            dense3.index(qdocs3)
            dres3 = dense3.retrieve(qqs3)
            g3 = HippoRAG(
                global_config=BaseConfig(save_dir=_dir("mh3_graph"), **cfg), device=device
            )
            g3.index(qdocs3)
            gres3 = g3.retrieve(qqs3)
            deep_g = sum(w in r.docs[:5] for w, r in zip(qdeep, gres3))
            deep_d = sum(w in r.docs[:5] for w, r in zip(qdeep, dres3))
            res["multihop3_deep_top5_graph"] = round(deep_g / N_CHAINS, 4)
            res["multihop3_deep_top5_dense"] = round(deep_d / N_CHAINS, 4)
        except Exception as e:  # noqa: BLE001
            res["multihop3_error"] = f"{type(e).__name__}: {e}"
    finally:
        if own_root:
            shutil.rmtree(root, ignore_errors=True)
    return res
