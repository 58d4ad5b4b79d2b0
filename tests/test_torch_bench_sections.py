"""The port's ``evaluation/bench_sections`` against the JAX package's.

- Every section resolves the ``BENCH_*`` knobs as the JAX module does: with
  the five harnesses of both packages replaced by recorders, ``run_section``
  passes the same arguments for every section under unset, ``"all"``,
  ``"0"`` and numeric settings, ``device`` aside (the port's extra
  parameter, passed through).
- ``run_section("multihop")`` runs for real on the CPU and equals the JAX
  package's run and ``tests/fixtures/torch_port_multihop_expected.json``;
  ``2wiki``, ``hotpot`` and ``musique`` run for real on the small in-test
  corpus of ``tests/test_torch_synth.py`` (``BENCH_2WIKI_CORPUS``) and equal
  the JAX package's runs but for wall-clock fields. ``replay`` needs the
  2WikiMultihopQA corpus its LLM responses were recorded on.
- ``chip_smoke.py`` phase 9 on the CPU: multihop through the fused route,
  and a skip line for each corpus section whose corpus is absent.
- An unknown section raises ``ValueError`` in both packages.
- No module of the JAX package lacks a counterpart in the port, and no
  public top-level name does, apart from the deliberate differences listed.
"""

import ast
import importlib
import inspect
import json
import os
import sys

import pytest
import torch

from hipporag_tpu.evaluation import bench_sections as ref_sections
from hipporag_tpu_torch.evaluation import bench_sections as port_sections

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

# section -> (harness module, harness function)
HARNESSES = {
    "2wiki": ("twiki", "run_2wiki_eval"),
    "hotpot": ("hotpot_synth", "run_hotpot_eval"),
    "musique": ("musique_synth", "run_musique_eval"),
    "multihop": ("multihop", "run_multihop_eval"),
    "replay": ("replay_quality", "run_replay_quality_eval"),
}
KNOBS = ("BENCH_2WIKI_CORPUS", "BENCH_2WIKI_EXACT", "BENCH_2WIKI_QUERIES", "BENCH_2WIKI_DOCS",
         "BENCH_2WIKI_TWIN", "BENCH_HOTPOT_DOCS", "BENCH_HOTPOT_QUERIES", "BENCH_MUSIQUE_DOCS",
         "BENCH_MUSIQUE_QUERIES", "BENCH_REPLAY_DOCS")
ENVIRONMENTS = {
    "unset": {},
    "all": {"BENCH_2WIKI_EXACT": "all"},
    "zero": {"BENCH_2WIKI_EXACT": "0", "BENCH_2WIKI_DOCS": "0", "BENCH_2WIKI_QUERIES": "0",
             "BENCH_2WIKI_TWIN": "0", "BENCH_HOTPOT_DOCS": "0", "BENCH_MUSIQUE_DOCS": "0"},
    "numbers": {"BENCH_2WIKI_CORPUS": "corpus.json", "BENCH_2WIKI_EXACT": "17", "BENCH_2WIKI_QUERIES": "40",
                "BENCH_2WIKI_DOCS": "300", "BENCH_2WIKI_TWIN": "12", "BENCH_HOTPOT_DOCS": "500",
                "BENCH_HOTPOT_QUERIES": "9", "BENCH_MUSIQUE_DOCS": "700", "BENCH_MUSIQUE_QUERIES": "11",
                "BENCH_REPLAY_DOCS": "1000"},
}


def _record(monkeypatch, package):
    """Replace the five harnesses of ``package`` by recorders of their bound arguments."""
    calls = {}
    for section, (module, name) in HARNESSES.items():
        mod = importlib.import_module(f"{package}.evaluation.{module}")
        sig = inspect.signature(getattr(mod, name))

        def recorder(*args, _section=section, _sig=sig, **kwargs):
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            calls[_section] = dict(bound.arguments)
            return {"section": _section}

        monkeypatch.setattr(mod, name, recorder)
    return calls


@pytest.mark.parametrize("env", sorted(ENVIRONMENTS))
@pytest.mark.parametrize("section", sorted(HARNESSES))
def test_run_section_resolves_knobs_as_jax(monkeypatch, tmp_path, env, section):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for knob, value in ENVIRONMENTS[env].items():
        monkeypatch.setenv(knob, value)
    ref_calls = _record(monkeypatch, "hipporag_tpu")
    port_calls = _record(monkeypatch, "hipporag_tpu_torch")
    assert ref_sections.run_section(section, str(tmp_path)) == {"section": section}
    assert port_sections.run_section(section, str(tmp_path), device="cpu") == {"section": section}
    want, got = ref_calls[section], port_calls[section]
    assert got.pop("device") == "cpu"
    if section == "2wiki":
        exact = ENVIRONMENTS[env].get("BENCH_2WIKI_EXACT", "all")
        assert want["exact_queries"] == {"all": 0, "0": None}.get(exact, int(exact) if exact.isdigit() else -1)
    if "corpus_path" in want and "BENCH_2WIKI_CORPUS" not in ENVIRONMENTS[env]:
        # the one deliberate difference: each package's default corpus path
        assert want.pop("corpus_path") == ref_sections.DEFAULT_CORPUS
        assert got.pop("corpus_path") == port_sections.DEFAULT_CORPUS
    assert got == want


def test_run_section_defaults_and_paths():
    assert port_sections.SECTIONS == ref_sections.SECTIONS
    assert port_sections._REPO_ROOT == ref_sections._REPO_ROOT == ROOT
    assert port_sections.DEFAULT_CORPUS == os.path.join(ROOT, "reproduce", "dataset", "2wikimultihopqa_corpus.json")
    # the parameters are compared in tests/test_torch_knn.py::test_ops_exports_match_jax
    assert inspect.signature(port_sections.run_section).parameters["device"].default == "cuda"
    # not exported from evaluation/__init__, as in the JAX package
    import hipporag_tpu.evaluation as ref_eval
    import hipporag_tpu_torch.evaluation as port_eval

    assert "run_section" not in port_eval.__all__ and "run_section" not in ref_eval.__all__


def test_unknown_section_raises_in_both(tmp_path):
    for module, kw in ((ref_sections, {}), (port_sections, {"device": "cpu"})):
        with pytest.raises(ValueError, match=r"unknown quality section: 'nope'"):
            module.run_section("nope", str(tmp_path), **kw)


def test_multihop_section_matches_jax_and_fixture(tmp_path):
    with open(chip_smoke.MULTIHOP_FIXTURE) as fh:
        want = json.load(fh)["result"]
    got = port_sections.run_section("multihop", str(tmp_path / "port"), device="cpu")
    ref = ref_sections.run_section("multihop", str(tmp_path / "ref"))
    assert got == ref == want
    assert "multihop3_error" not in got


@pytest.mark.parametrize("section", ["2wiki", "hotpot", "musique"])
def test_corpus_sections_match_jax_on_an_in_test_corpus(monkeypatch, tmp_path, section):
    from test_torch_synth import _corpus, _without_timings

    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    corpus = tmp_path / "2wikimultihopqa_corpus.json"
    corpus.write_text(json.dumps(_corpus()))
    monkeypatch.setenv("BENCH_2WIKI_CORPUS", str(corpus))
    monkeypatch.setenv("BENCH_2WIKI_TWIN", "16")
    want = ref_sections.run_section(section, str(tmp_path / "ref"))
    got = port_sections.run_section(section, str(tmp_path / "port"), device="cpu")
    assert _without_timings(got) == _without_timings(want)
    assert got["num_queries"] > 0 and got["corpus_docs"] == 48


def test_chip_smoke_phase9_on_cpu(monkeypatch, tmp_path, capsys):
    """Phase 9 as the card runs it, with the fused route's plain pass A
    counted as the kernel: multihop equal to the fixture, every corpus
    section reported as skipped while its corpus is absent."""
    from hipporag_tpu_torch.ops import fused_topk, scoring

    def counted(queries, keys, valid_n):
        fused_topk.SCAN_LAUNCHES.add()
        return fused_topk.scan_tiles_reference(queries, keys, valid_n)

    monkeypatch.setattr(scoring, "fused_topk_route", lambda device: True)
    monkeypatch.setattr(fused_topk, "scan_tiles", counted)
    monkeypatch.setenv("BENCH_2WIKI_CORPUS", str(tmp_path / "absent.json"))
    out = chip_smoke.phase9_sections("cpu")
    with open(chip_smoke.MULTIHOP_FIXTURE) as fh:
        assert out["multihop"]["result"] == json.load(fh)["result"]
    assert out["multihop"]["kernel_launches"] > 0
    printed = capsys.readouterr().out
    for section in chip_smoke.CORPUS_SECTIONS:
        assert out[section] == {"skipped": f"corpus absent: {tmp_path / 'absent.json'}"}
        assert f"phase 9: section {section} skipped" in printed


# Public top-level names of a JAX module that its port lacks on purpose:
# the pack/unpack transfer and the TPU speed route are not ported (ROADMAP
# "Not to port"); ``jax_profile`` gave way to ``device_profile``; the
# encoder's forward passes are methods of the port's ``BertEncoder`` and its
# model class is ``TorchEncoderEmbeddingModel``. ``Array``, the jax.Array
# alias, may stand in any module.
JAX_ALIAS = {"Array"}
JAX_ONLY_NAMES = {
    "ops/scoring.py": {"PACK_IDX_LIMIT", "pack_vals_idx", "unpack_vals_idx", "pallas_topk_route"},
    "embedding/jax_encoder.py": {"JaxEncoderEmbeddingModel", "encode_forward", "encode_forward_wire"},
    "utils/timing.py": {"jax_profile"},
}
JAX_ONLY_MODULES = {"utils/compile_cache.py"}  # ROADMAP "Not to port"
RENAMED_MODULES = {"embedding/jax_encoder.py": "embedding/encoder.py"}


def _public_names(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_every_jax_module_and_public_name_has_a_counterpart():
    ref_root, port_root = os.path.join(ROOT, "hipporag_tpu"), os.path.join(ROOT, "hipporag_tpu_torch")
    missing = {}
    for dirpath, _dirs, files in os.walk(ref_root):
        for rel in (os.path.relpath(os.path.join(dirpath, f), ref_root) for f in files if f.endswith(".py")):
            port = os.path.join(port_root, RENAMED_MODULES.get(rel, rel))
            if rel in JAX_ONLY_MODULES:
                continue
            if not os.path.exists(port):
                missing[rel] = "no module"
                continue
            names = (_public_names(os.path.join(ref_root, rel)) - _public_names(port) - JAX_ALIAS
                     - JAX_ONLY_NAMES.get(rel, set()))
            if names:
                missing[rel] = sorted(names)
    assert not missing, missing
