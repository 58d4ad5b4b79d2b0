"""End to end: the PyTorch port's index -> retrieve -> rag_qa against the JAX package.

Both packages index ``data/sample_corpus.json`` with the mock LLM and mock
embedder on the CPU and answer the queries of ``data/sample.json``. The
ranked passages must be identical and EM/F1 equal. The same run of the JAX
package is recorded in ``tests/fixtures/torch_port_sample_expected.json``,
which ``chip_smoke.py`` holds the port to on the GPU; a test here
regenerates it so it cannot go stale. A subprocess with jax,
``hipporag_tpu``, pandas, pyarrow, httpx and filelock blocked shows the
port runs without them, with the mock embedder and with the port's encoder:
index, retrieve (ELL and COO), one adapter step, the multihop harness,
delete, and one served ``/retrieve``. Each package gets its own
``BaseConfig``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hipporag_tpu
import hipporag_tpu_torch
from hipporag_tpu.datasets import load_dataset
from hipporag_tpu.utils.misc import compute_mdhash_id

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_sample_expected.json")
BLOCKED = ("jax", "jaxlib", "hipporag_tpu", "pandas", "pyarrow", "httpx", "filelock")


def _config(save_dir, pkg=hipporag_tpu_torch):
    return pkg.BaseConfig(
        llm_name="mock", embedding_model_name="mock", vector_store_type="memory",
        save_dir=str(save_dir),
    )


def _run(rag):
    docs, queries, gold_docs, gold_answers = load_dataset("sample", os.path.join(ROOT, "data"))
    rag.index(docs)
    retrieved = rag.retrieve(queries)
    return retrieved, rag.rag_qa(queries, gold_docs=gold_docs, gold_answers=gold_answers)


def _expected(solutions):
    """The fixture's form of a run: ranked passage ids and the answer per query."""
    return [
        {
            "question": s.question,
            "ranked_passage_ids": [compute_mdhash_id(d, "chunk-") for d in s.docs],
            "answer": s.answer,
        }
        for s in solutions
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref = _run(hipporag_tpu.HippoRAG(_config(tmp_path_factory.mktemp("ref"), hipporag_tpu)))
    port = _run(hipporag_tpu_torch.HippoRAG(_config(tmp_path_factory.mktemp("port")), device="cpu"))
    return ref, port


def test_ranked_passages_identical(runs):
    (ref_retrieved, ref_qa), (port_retrieved, port_qa) = runs
    for ref_sols, port_sols in ((ref_retrieved, port_retrieved), (ref_qa[0], port_qa[0])):
        assert len(ref_sols) == len(port_sols)
        for r, p in zip(ref_sols, port_sols):
            assert p.docs == r.docs
            np.testing.assert_allclose(p.doc_scores, r.doc_scores, rtol=1e-5, atol=1e-7)


def test_rag_qa_answers_and_em_f1_equal(runs):
    (_, ref_qa), (_, port_qa) = runs
    assert [s.answer for s in port_qa[0]] == [s.answer for s in ref_qa[0]]
    assert port_qa[3] == ref_qa[3]  # retrieval recall
    assert port_qa[4] == ref_qa[4]  # ExactMatch / F1


def test_sample_fixture_matches_jax_package(runs):
    (_, ref_qa), _ = runs
    with open(FIXTURE) as fh:
        recorded = json.load(fh)
    assert recorded["queries"] == _expected(ref_qa[0])


def test_bfloat16_fused_route_matches_fixture(tmp_path, monkeypatch):
    """compute_dtype="bfloat16" keeps bf16 fact embeddings resident; routed
    through the fused top-k (as every CUDA call is), with f32 queries, the
    sample run still ranks and answers as the JAX package's f32 run.
    ``chip_smoke.py`` phase 3 checks the same through the kernel."""
    from hipporag_tpu_torch.ops import fused_topk, scoring

    scans = []

    def counted(queries, keys, valid_n, tile_n=fused_topk.TILE_N):
        scans.append(keys.dtype)
        return plain(queries, keys, valid_n, tile_n)

    plain = fused_topk.scan_tiles_reference
    monkeypatch.setattr(fused_topk, "scan_tiles_reference", counted)
    monkeypatch.setattr(scoring, "fused_topk_route", lambda b, n, device: True)
    cfg = _config(tmp_path)
    cfg.compute_dtype = "bfloat16"
    _retrieved, qa = _run(hipporag_tpu_torch.HippoRAG(cfg, device="cpu"))
    assert scans and all(dt == torch.bfloat16 for dt in scans)
    with open(FIXTURE) as fh:
        assert _expected(qa[0]) == json.load(fh)["queries"]


def test_port_runs_without_jax_pandas_pyarrow_httpx_filelock(tmp_path):
    """The mock embedder, and the port's encoder (``jax/random-64x2``)
    through ``HippoRAG.retrieve``, ``retrieve_dpr`` and ``StandardRAG``; a
    COO retrieve, one adapter step and ``run_multihop_eval``; then
    ``delete`` and one ``/retrieve`` served by the stdlib front end."""
    code = f"""
import sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads(1)
import hipporag_tpu_torch
docs, queries, _, _ = hipporag_tpu_torch.load_dataset("sample", {os.path.join(ROOT, "data")!r})
for name in ("mock", "jax/random-64x2"):
    cfg = hipporag_tpu_torch.BaseConfig(llm_name="mock", embedding_model_name=name,
                                        vector_store_type="memory", save_dir={str(tmp_path)!r} + "/" + name)
    rag = hipporag_tpu_torch.HippoRAG(cfg, device="cpu")
    rag.index(docs)
    sols = rag.retrieve(queries)
    assert len(sols) == len(queries) and all(s.docs for s in sols)
    if name != "mock":
        assert type(rag.embedding_model).__name__ == "TorchEncoderEmbeddingModel"
        assert all(s.docs for s in rag.retrieve_dpr(queries))
        std = hipporag_tpu_torch.StandardRAG(cfg, device="cpu")
        std.index(docs)
        assert all(s.docs for s in std.retrieve(queries))
coo = hipporag_tpu_torch.HippoRAG(hipporag_tpu_torch.BaseConfig(
    llm_name="mock", embedding_model_name="mock", vector_store_type="memory", ppr_format="coo",
    save_dir={str(tmp_path)!r} + "/coo"), device="cpu")
coo.index(docs)
assert all(s.docs for s in coo.retrieve(queries))
assert type(coo._index_state.graph).__name__ == "COOGraph"
from hipporag_tpu_torch.models.adapter import adamw, init_adapter, make_train_step
params = init_adapter(16, 32, generator=torch.Generator().manual_seed(0), device="cpu")
loss = make_train_step(adamw(params, 1e-2))(params, torch.randn(8, 16), torch.randn(8, 16))
assert bool(torch.isfinite(loss))
from hipporag_tpu_torch.evaluation.multihop import run_multihop_eval
multihop = run_multihop_eval(device="cpu")
assert "multihop3_error" not in multihop and len(multihop) == 4, multihop
rag.delete(docs[:2])
import json, threading, urllib.request
from hipporag_tpu_torch.serving import RetrievalService
from hipporag_tpu_torch.serving.http_server import make_server
with RetrievalService(rag, max_wait_ms=0) as svc:
    server = make_server(svc, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    req = urllib.request.Request(
        "http://127.0.0.1:%d/retrieve" % server.server_address[1],
        data=json.dumps({{"query": queries[0], "top_k": 3}}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    server.shutdown()
    server.server_close()
assert len(body["docs"]) == 3 and not set(body["docs"]) & set(docs[:2]), body
assert not any(m in sys.modules and sys.modules[m] is not None for m in {BLOCKED!r})
print("OK", len(sols))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK 3")


def _jax_package_imports(path):
    """Every import of ``hipporag_tpu``, ``jax`` or ``jaxlib`` (or a
    submodule) in a file, at any depth (lazy imports in functions too), and
    every ``import_module`` or ``__import__`` call naming one."""
    import ast

    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    found = []

    def names_jax_package(name):
        return any(name == top or name.startswith(top + ".") for top in ("hipporag_tpu", "jax", "jaxlib"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if names_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and names_jax_package(node.module or ""):
            found.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            fn_name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0].value
            if fn_name in ("import_module", "__import__") and isinstance(arg, str) and names_jax_package(arg):
                found.append(arg)
    return found


def test_port_imports_nothing_of_the_jax_package(tmp_path):
    """No file of the port (the native graph core's loader included), nor
    ``chip_smoke.py`` or ``scripts/profile_torch_bucket.py``, imports
    ``hipporag_tpu``, ``jax`` or ``jaxlib``."""
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "profile_torch_bucket.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT, "hipporag_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 70
    assert os.path.join(ROOT, "hipporag_tpu_torch", "graph", "native", "__init__.py") in files
    offenders = {os.path.relpath(f, ROOT): found for f in files if (found := _jax_package_imports(f))}
    assert not offenders, offenders
    # the check itself sees direct, lazy and dynamic imports
    probe = tmp_path / "import_probe.py"
    probe.write_text("import hipporag_tpu.config\ndef f():\n    from hipporag_tpu import x\n"
                     "    importlib.import_module('hipporag_tpu.llm')\nfrom hipporag_tpu_torch import y\n"
                     "import jax.numpy as jnp\nfrom jaxlib import xla_client\nimport jaxtyping\n")
    assert sorted(_jax_package_imports(str(probe))) == [
        "hipporag_tpu", "hipporag_tpu.config", "hipporag_tpu.llm", "jax.numpy", "jaxlib"]


@pytest.mark.parametrize("override", [{"mesh_shape": (1, 2)}])
def test_unported_config_raises(tmp_path, override):
    """Only the multi-device configuration is refused."""
    cfg = _config(tmp_path)
    for key, value in override.items():
        setattr(cfg, key, value)
    with pytest.raises(NotImplementedError):
        hipporag_tpu_torch.HippoRAG(cfg, device="cpu")
