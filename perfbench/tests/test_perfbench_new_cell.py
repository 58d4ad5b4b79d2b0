"""An encoder cell at published widths joins the benchmark with new files
and new manifest entries only.

In a copy of the benchmark, a configuration that names the ``bert`` pair at
widths no CPU could run is added with its workload file, its cell and its
own whole-step share. The copy's own per-cell and manifest tests then pass
on it in a subprocess, with the encoder at the sizes its module states for
the CPU, and no file of the copy is edited."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from tiny import ROOT

from perfbench.encoders import bert

WIDE = "bert-wide-musique"
CELL = WIDE + ".batch"
MFU = "step_mfu.wide"
WIDE_SIZES = {"hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 64, "intermediate_size": 16384,
              "torch_dtype": "bfloat16"}
# Loaded by the copy's test run from outside the copy: each side logs the
# encoder's sizes as it builds it, and refuses any but the module's tiny
# ones before a weight is drawn.
PLUGIN = '''
import json
import os

from perfbench.encoders import bert
from perfbench.reference.encoders import bert as plain


def _held(side, fn):
    def held(config, *args, **kwargs):
        sizes = {k: config[k] for k in bert.TINY}
        with open(os.environ["PERFBENCH_GUARD_LOG"], "a") as fh:
            fh.write(json.dumps({"side": side, "sizes": sizes}) + "\\n")
        assert sizes == bert.TINY, sizes
        return fn(config, *args, **kwargs)
    return held


bert.program = _held("program", bert.program)
plain.weights = _held("reference", plain.weights)
'''


def _files(top: str) -> dict:
    out = {}
    for base, dirs, names in os.walk(top):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".pytest_cache")]
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = fh.read()
    return out


def _add_wide_cell(root) -> None:
    """The new files and manifest entries of a cell, as a later change adds them."""
    bench = root / "perfbench"
    with open(bench / "configs" / "nvembed2-musique.json") as fh:
        config = json.load(fh)
    config.update(WIDE_SIZES, name=WIDE, query_encoder="bert", vocab_size=30522, max_position_embeddings=512,
                  layer_norm_eps=1e-12, hidden_act="gelu_new")
    config["hipporag"]["embedding_model_name"] = "bert-wide"
    (bench / "configs" / f"{WIDE}.json").write_text(json.dumps(config, indent=2))
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"params": {}, "limits": {"malformed": 0, "fact_gap": 5e-06, "rank_gap": 5e-06, "embed_err": 0.02}}))
    (bench / "metrics" / f"{MFU}.py").write_text(
        "from perfbench.metrics import step_mfu\n\n\ndef read(ctx):\n    return step_mfu(ctx)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": WIDE, "source": "https://arxiv.org/abs/1810.04805",
                         "file": f"perfbench/configs/{WIDE}.json", "reduced": [],
                         "why": "the bert pair at widths no CPU runs"})
    m["workloads"].append({"name": CELL, "config": WIDE, "traffic": "batch", "chips": 1,
                           "why": "batch traffic with the questions encoded inside the timed call"})
    m["per_layer"].append({"name": MFU, "unit": "%", "better": "higher", "source": "device_trace",
                           "layer": "Whole step", "moves": "retrieve_qps", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=2))


def test_an_encoder_cell_at_published_widths_joins_with_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    _add_wide_cell(root)
    (tmp_path / "plugins").mkdir()
    (tmp_path / "plugins" / "perfbench_guard.py").write_text(PLUGIN)
    log, report = tmp_path / "sizes.jsonl", tmp_path / "report.xml"
    env = dict(os.environ, PERFBENCH_GUARD_LOG=str(log),
               PYTHONPATH=os.pathsep.join([str(root), str(tmp_path / "plugins"), ROOT]))
    tests = [os.path.join("perfbench", "tests", f) for f in ("test_perfbench_runs.py", "test_perfbench_manifest.py")]
    # the manifest's tests take no cell as a parameter: the module's name selects them
    out = subprocess.run([sys.executable, "-m", "pytest", *tests, "-q", "-k", "bert-wide or test_perfbench_manifest",
                          "-p", "perfbench_guard", "-p", "no:cacheprovider", f"--junitxml={report}"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]

    outcomes = {}
    for case in ET.parse(report).iter("testcase"):
        kinds = {child.tag for child in case} & {"failure", "error", "skipped"}
        outcomes[case.get("name")] = kinds.pop() if kinds else "passed"
    for name in ("test_the_reference_agrees_with_the_port", "test_traced_run_reads_its_metrics", "test_control_runs"):
        assert outcomes[f"{name}[{CELL}]"] == "passed", outcomes
    assert outcomes[f"test_control_fails_at_the_cells_size[{CELL}]"] in ("passed", "skipped")
    assert outcomes["test_cells_and_metrics_fit_together"] == "passed"
    assert outcomes["test_every_name_resolves_to_a_file"] == "passed"
    assert outcomes[f"test_readers_return_nothing_without_a_reading[{MFU}]"] == "passed"
    assert not [n for n in outcomes if "nvembed2" in n], outcomes

    # both sides built the encoder, each time at the module's tiny sizes
    built = [json.loads(line) for line in log.read_text().splitlines()]
    assert {b["side"] for b in built} == {"program", "reference"}
    assert all(b["sizes"] == bert.TINY for b in built)

    # every file of the checkout's benchmark is in the copy as it was
    before, after = _files(os.path.join(ROOT, "perfbench")), _files(str(root / "perfbench"))
    assert {k: after.get(k) for k in before} == before
    assert set(after) - set(before) == {f"configs/{WIDE}.json", f"workloads/{CELL}.json", f"metrics/{MFU}.py"}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        old = json.load(fh)
    new = json.loads((root / "BENCHMARK.json").read_text())
    assert set(new) == set(old)
    for key, value in old.items():
        assert new[key][:len(value)] == value if isinstance(value, list) else new[key] == value, key
