"""Question encoders on the query path, one module per encoder that a
configuration's ``query_encoder`` key names, beside its plain reference
(``reference/encoders/<name>.py``, which also holds the weights drawn from
the seed and the tokenizer both sides read).

A module ``<name>.py`` here defines:

- ``program(config, hcfg, device, seed)``: a port ``BaseEmbeddingModel``
  that encodes questions on ``device`` inside the timed call;
- ``work(config, token_counts)``: (FLOPs, bytes, precision) of encoding
  sequences of ``token_counts`` tokens once, for ``roofline.least_s``;
- ``TINY``: the configuration keys, ``torch_dtype`` among them, at which
  the CPU tests run the pair in any cell that names it: the architecture's
  kinds of heads and blocks in two layers or more, at a width the CPU runs
  in seconds; ``TINY_LIMITS``: the comparison's limits at those sizes;
- optionally ``PUBLISHED`` and ``PROBE_LIMITS``: a published model's keys
  and the limits there, for ``encoder_probe.py``.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"perfbench.encoders.{name}")
