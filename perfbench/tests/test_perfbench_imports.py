"""Nothing the harness or its reference loads is JAX or the JAX package
(top-level module names compared whole: ``hipporag_tpu_torch`` is the
port, ``hipporag_tpu`` the JAX package), and the reference loads nothing
of the port either."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "hipporag_tpu"}
BENCH = os.path.join(ROOT, "perfbench")


def _loaded_after(code: str) -> set:
    script = ("import json, sys\n" f"sys.path.insert(0, {ROOT!r})\n" + code +
              "\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    readers = sorted(glob.glob(os.path.join(BENCH, "metrics", "*.*.py")))
    code = ("import perfbench.run as run, perfbench.control, perfbench.drivers.batch\n"
            "import perfbench.deployment, perfbench.adapters, perfbench.work, perfbench.trace\n"
            "import perfbench.encoders.bert\n"
            f"for i, p in enumerate({readers!r}):\n    run.load_file_module(p, 'reader%d' % i)\n")
    assert not _loaded_after(code) & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = ("import perfbench.reference.retrieval, perfbench.check, perfbench.roofline\n"
            "import perfbench.reference.encoders.bert\n")
    loaded = _loaded_after(code)
    assert not loaded & (FORBIDDEN | {"hipporag_tpu_torch"})


def test_no_source_names_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
                if os.sep + "reference" + os.sep in path:
                    assert name.split(".")[0] != "hipporag_tpu_torch", (path, name)
