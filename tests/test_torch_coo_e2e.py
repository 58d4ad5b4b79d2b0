"""The port's ``HippoRAG(ppr_format="coo")`` and ``profile_log_dir`` against the JAX package.

Both packages index ``data/sample_corpus.json`` with the mock LLM and
embedder on the CPU, keep the COO operator on the device (no ELL packing)
and answer the sample queries, with ``compute_dtype`` float32 and
bfloat16. Rankings, answers and metrics must be equal; doc scores within
1e-5 (float32) and 1e-4 (bfloat16), the bounds of the ELL lifecycle
fixture. The JAX package's run is recorded in
``tests/fixtures/torch_port_coo_expected.json``, which ``chip_smoke.py``
phase 7 holds the port to on the GPU; a test here regenerates it so it
cannot go stale, and ``python tests/test_torch_coo_e2e.py`` rewrites it.
The delete lifecycle (index -> delete -> retrieve -> re-index -> retrieve)
equals the JAX package's under COO too, and a ``profile_log_dir`` run
writes a Chrome trace of the retrieve's work.
"""

import glob
import json
import os
import sys
import tempfile

import pytest
import torch

import hipporag_tpu
import hipporag_tpu_torch
from hipporag_tpu.datasets import load_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(ROOT, "data")


def _config(pkg, save_dir, compute_dtype="float32", **kw):
    return pkg.BaseConfig(save_dir=str(save_dir), compute_dtype=compute_dtype,
                          **{**chip_smoke.COO_CONFIG, **kw})


def record_coo_fixture():
    """The JAX package's COO run on the sample corpus in both dtypes."""
    records = {}
    for dtype in chip_smoke.COO_SCORE_ATOL:
        with tempfile.TemporaryDirectory() as tmp:
            rag = hipporag_tpu.HippoRAG(_config(hipporag_tpu, tmp, dtype))
            records[dtype] = chip_smoke.coo_record(rag, load_dataset("sample", DATA))
    return {"config": chip_smoke.COO_CONFIG, "records": records}


def test_coo_fixture_unchanged():
    with open(chip_smoke.COO_FIXTURE) as fh:
        recorded = json.load(fh)
    fresh = record_coo_fixture()
    assert recorded["config"] == fresh["config"]
    assert sorted(recorded["records"]) == sorted(fresh["records"])
    for dtype, record in fresh["records"].items():
        chip_smoke.compare_records(record, recorded["records"][dtype], score_atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_coo_matches_the_jax_fixture(tmp_path, dtype):
    with open(chip_smoke.COO_FIXTURE) as fh:
        want = json.load(fh)["records"][dtype]
    rag = hipporag_tpu_torch.HippoRAG(_config(hipporag_tpu_torch, tmp_path, dtype), device="cpu")
    got = chip_smoke.coo_record(rag, load_dataset("sample", DATA))
    assert type(rag._index_state.graph).__name__ == "COOGraph"
    chip_smoke.compare_records(got, want, score_atol=chip_smoke.COO_SCORE_ATOL[dtype])


def test_coo_edge_chunks_rank_as_one_chunk(tmp_path):
    data = load_dataset("sample", DATA)
    one = chip_smoke.coo_record(
        hipporag_tpu_torch.HippoRAG(_config(hipporag_tpu_torch, tmp_path / "one"), device="cpu"), data)
    three = chip_smoke.coo_record(
        hipporag_tpu_torch.HippoRAG(_config(hipporag_tpu_torch, tmp_path / "three", ppr_edge_chunks=3),
                                    device="cpu"), data)
    chip_smoke.compare_records(three, one, score_atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coo_delete_lifecycle_matches_jax(tmp_path, dtype):
    data = load_dataset("sample", DATA)
    want = chip_smoke.lifecycle_record(hipporag_tpu.HippoRAG(_config(hipporag_tpu, tmp_path / "ref", dtype)), data)
    port = hipporag_tpu_torch.HippoRAG(_config(hipporag_tpu_torch, tmp_path / "port", dtype), device="cpu")
    got = chip_smoke.lifecycle_record(port, data)
    assert type(port._index_state.graph).__name__ == "COOGraph" and "ell" not in port._capacities
    chip_smoke.compare_lifecycle(got, want, chip_smoke.LIFECYCLE_SCORE_ATOL[dtype])


def test_profile_log_dir_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    rag = hipporag_tpu_torch.HippoRAG(
        _config(hipporag_tpu_torch, tmp_path / "rag", profile_log_dir=str(trace_dir)), device="cpu")
    docs, queries, _, _ = load_dataset("sample", DATA)
    rag.index(docs)
    sols = rag.retrieve(queries)
    assert all(s.docs for s in sols)
    traces = glob.glob(str(trace_dir / "trace-*.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        names = {ev.get("name", "") for ev in json.load(fh)["traceEvents"]}
    # the PPR's gathers and segment sums ran inside the traced block
    assert {"aten::index_select", "aten::segment_reduce"} <= names, sorted(names)[:40]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    with open(chip_smoke.COO_FIXTURE, "w") as fh:
        json.dump(record_coo_fixture(), fh, indent=1)
        fh.write("\n")
    print("wrote", chip_smoke.COO_FIXTURE)
