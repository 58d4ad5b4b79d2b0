#!/usr/bin/env python3
"""Run a question encoder on the query path of the batch cell, at a
model's published widths, without a cell of its own in BENCHMARK.json.

    python3 perfbench/encoder_probe.py --encoder bert --seeds 11,12 \
        [--seconds 20] [--trace-seeds 11] [--control-seeds 11,12,13]

The spec is ``nvembed2-musique.batch``'s, with the published sizes that
the encoder's module states (``encoders/<name>.py``'s ``PUBLISHED``) added
to its configuration and the index vectors made at the encoder's width;
its limits are the cell's and the module's ``PROBE_LIMITS``. Any encoder
whose module states both can be probed.
Each seed is one run of ``run.execute`` (traced for ``--trace-seeds``),
each control seed one ``control.control_numbers`` at the traffic's sample
size, all in this one process. One JSON line per run: the result, and for
a traced run the profiled calls' least ``encode`` time and its share of
the device time in ``retrieve/embed``, both from the result's breakdown.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import run  # noqa: E402  (sets the build and cache directories first)

CELL = "nvembed2-musique.batch"


def encoder_names() -> list:
    """The encoders with a module under ``encoders/``."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(run.BENCH, "encoders"))
                  if f.endswith(".py") and f != "__init__.py")


def spec_for(manifest: dict, encoder: str):
    from perfbench.encoders import load

    module = load(encoder)
    if not hasattr(module, "PUBLISHED"):
        raise SystemExit(f"encoder_probe: encoders/{encoder}.py states no PUBLISHED sizes")
    cell, config, params, limits = run.cell_spec(manifest, CELL)
    config = copy.deepcopy(config)
    config.update(module.PUBLISHED, query_encoder=encoder, name=f"{config['name']}-{encoder}")
    dim = config["hidden_size"]
    config["index_vectors"]["dim"] = dim
    config["hipporag"]["embedding_dim"] = dim
    name = f"{config['name']}.{cell['traffic']}"
    return name, (dict(cell, name=name, config=config["name"]), config, params,
                  dict(limits, **module.PROBE_LIMITS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", required=True, choices=encoder_names())
    ap.add_argument("--seeds", default="")
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import control

    if not torch.cuda.is_available():
        print("encoder_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    manifest = run.load_json(run.ROOT, "BENCHMARK.json")
    name, spec = spec_for(manifest, args.encoder)
    manifest = copy.deepcopy(manifest)
    for m in manifest["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(name)

    def split(s):
        return [int(x) for x in s.split(",") if x]

    t_start = T_START
    for seed, traced in [(s, False) for s in split(args.seeds)] + [(s, True) for s in split(args.trace_seeds)]:
        result, _rows = run.execute(manifest, name, seed, args.seconds, traced, device, t_start, spec=spec)
        line = {"kind": "run", "spec": name, "seed": seed, "trace": traced, **result}
        if traced:
            embed_s = dict(result["breakdown"]["range_device_s"]).get("retrieve/embed", 0.0)
            least = dict(result["breakdown"]["least_s"]).get("encode", 0.0)
            line.update(encode_least_s=least, encode_roofline=100.0 * least / embed_s if embed_s > 0 else None)
        print(json.dumps(line), flush=True)
        t_start = time.perf_counter()
    _cell, config, params, limits = spec
    for seed in split(args.control_seeds):
        t0 = time.perf_counter()
        numbers = control.control_numbers(config, params, seed, params["sample"], device)
        failed = [n for n, v in numbers.items() if n in limits and v > limits[n]]
        print(json.dumps({"kind": "control", "spec": name, "seed": seed, "numbers": numbers, "fails": failed,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
