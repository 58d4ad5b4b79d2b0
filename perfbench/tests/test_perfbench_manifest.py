"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell, configuration, traffic mix and metric reader by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from tiny import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# a width: a hidden, intermediate, latent, state or projection size, a
# key ending in _dim or _rank, a head size, an expansion factor, or the
# number of experts per token
WIDTH_ENDS = ("_size", "_dim", "_rank")
WIDTH_WORDS = ("expansion", "experts_per_tok")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in m["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    script = next(w for w in m["command"] if w.endswith(".py"))
    assert any(script.startswith(p + "/") for p in m["paths"])


def test_names_units_and_entries():
    m = manifest()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        names = [e["name"] for e in m[group]]
        assert len(names) == len(set(names))
        for e in m[group]:
            assert set(e) == keys, e["name"]
            assert NAME.match(e["name"]) and _line(e["why"])
    for c in m["configs"]:
        assert _line(c["source"]) and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(WIDTH_ENDS) or any(w in k for w in WIDTH_WORDS) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as fh:
            held = json.load(fh)
        assert all(k in held for k in c["reduced"])
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher") and x["source"] in SOURCES
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(x["layer"])


def test_cells_and_metrics_fit_together():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = {w["name"]: w for w in m["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(cells)
    assert configs == {w["config"] for w in m["workloads"]}
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in m["workloads"]) and len(four) <= max(1, len(cells) // 4)

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for x in list(e2e.values()) + m["per_layer"]:
        assert set(x.get("workloads", [])) <= set(cells)
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        for cell in x.get("workloads", cells):
            assert reports(e2e[x["moves"]], cell), (x["name"], cell)
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(x, cell) for n, x in e2e.items() if n != "setup_s")
        assert any(reports(x, cell) for x in m["per_layer"])
        # its own whole-step share, which bounds any kernel's gain there
        assert len([x for x in m["per_layer"] if x["name"].startswith("step_mfu") and reports(x, cell)]) == 1, cell
    layers = {}
    for x in m["per_layer"]:
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_name_resolves_to_a_file():
    from perfbench import run

    m = manifest()
    bench = os.path.join(ROOT, "perfbench")
    for w in m["workloads"]:
        cell, config, params, limits = run.cell_spec(m, w["name"])
        assert os.path.isfile(os.path.join(bench, "drivers", params["driver"] + ".py"))
        assert limits and all(v >= 0 for v in limits.values())
        assert config["index_vectors"]["dim"] == config["hipporag"]["embedding_dim"]
    from tiny import encoder_spec

    for config in [run.cell_spec(m, w["name"])[1] for w in m["workloads"]] + [encoder_spec()[1]]:
        if config.get("query_encoder"):
            name = config["query_encoder"]
            assert os.path.isfile(os.path.join(bench, "encoders", name + ".py")), name
            assert os.path.isfile(os.path.join(bench, "reference", "encoders", name + ".py")), name
            assert config["hidden_size"] == config["index_vectors"]["dim"]
    for x in m["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics", x["name"] + ".py")), x["name"]


def test_a_new_cell_traffic_and_metric_are_found_by_name(tmp_path):
    """Adding a cell means adding files and entries: the harness finds a new
    traffic file, cell file and metric reader without an edited file."""
    from perfbench import run

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest()
    (root / "perfbench" / "traffic" / "small.json").write_text(json.dumps(
        {"driver": "batch", "entry": "retrieve", "questions_per_call": 100, "sample": 8}))
    (root / "perfbench" / "workloads" / "nvembed2-musique.small.json").write_text(json.dumps(
        {"params": {"questions_per_call": 60}, "limits": {"malformed": 0}}))
    (root / "perfbench" / "metrics" / "probe_ms.batch.py").write_text(
        "def read(ctx):\n    return ctx.counters.get('probe')\n")
    m["workloads"].append({"name": "nvembed2-musique.small", "config": "nvembed2-musique",
                           "traffic": "small", "chips": 1, "why": "a probe"})
    cell, config, params, limits = run.cell_spec(m, "nvembed2-musique.small", root=str(root))
    assert params["questions_per_call"] == 60 and params["driver"] == "batch" and limits == {"malformed": 0}
    assert config["name"] == "nvembed2-musique"
    ctx = run.Context(counters={"probe": 1.5})
    assert run.read_metric("probe_ms.batch", ctx, root=str(root)) == 1.5


@pytest.mark.parametrize("metric", [x["name"] for x in manifest()["per_layer"]])
def test_readers_return_nothing_without_a_reading(metric):
    """A reader that finds nothing to read returns None, never 0."""
    from perfbench import run

    empty = run.Context(counters={}, trace=None, window_s=0.0, stages=[], traced_stages=[])
    assert run.read_metric(metric, empty) is None
