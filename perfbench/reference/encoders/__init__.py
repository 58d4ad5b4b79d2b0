"""Plain reference encoders of question text, one module per encoder that a
configuration's ``query_encoder`` key names, and what both sides of the
comparison read: the instructions a question is encoded under, the
weights drawn from the seed and the tokenizer.

A module ``<name>.py`` here defines:

- ``weights(config, seed, device)``: the encoder's weights, drawn from the
  seed on ``device`` in the type the configuration serves them in; the
  program builds its encoder from them and the reference draws them again
  once the program's state is freed;
- ``tokenizer(config)``: ``tok(texts, max_length) -> (ids, mask)``, int32
  arrays padded to the longest row, the same for both sides;
- ``format_query(config, instruction, text)``: the text the encoder reads
  for a question under an instruction, as the program forms it;
- ``encode(config, weights, texts, device, operand=None)``: float32 unit
  rows [len(texts), D] in float32 with TF32 off, computed in blocks of
  sequences; ``operand`` rounds both operands of every product (the
  control's lower precision).

It imports nothing of the port or of JAX.
"""

from __future__ import annotations

import importlib

import torch

# the port's two question instructions (``prompts/linking.py``), written
# out here, in the order it encodes them: the fact rows, then the passage rows
INSTRUCTIONS = (
    ("triple", "Given a question, retrieve triplet facts that match it."),
    ("passage", "Given a question, retrieve documents that best answer it."),
)
KINDS = tuple(kind for kind, _text in INSTRUCTIONS)
# the precision one step below what a configuration states, for the control
LOWER = {"float32": "tf32", "bfloat16": "fp8"}
_FP8_MAX = 448.0


def load(name: str):
    return importlib.import_module(f"perfbench.reference.encoders.{name}")


def queries(config: dict, questions) -> list:
    """Every text the encoder reads for ``questions``: each question under
    the fact instruction, then each under the passage instruction."""
    module = load(config["query_encoder"])
    return [module.format_query(config, instruction, q) for _kind, instruction in INSTRUCTIONS for q in questions]


def token_counts(config: dict, questions) -> list:
    """Tokens of each distinct text the encoder reads for ``questions``:
    the least it has to encode (a symmetric encoder reads one text under
    both instructions)."""
    tok = load(config["query_encoder"]).tokenizer(config)
    _ids, mask = tok(list(dict.fromkeys(queries(config, questions))), int(config["max_position_embeddings"]))
    return mask.sum(axis=1).tolist()


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded as a product's operand in ``precision``:
    ``tf32`` keeps 10 mantissa bits (rounded to nearest); ``fp8`` is
    e4m3 with one scale per tensor, its largest magnitude at 448."""
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"no operand rounding for {precision!r}")


def rows(config: dict, seed: int, questions, device, precision: str = None) -> tuple:
    """(fact rows, passage rows) of ``questions``: float32 unit rows of
    the reference encoder, or of the control with ``precision``."""
    module = load(config["query_encoder"])
    device = torch.device(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        weights = module.weights(config, seed, device)
        operand = None if precision is None else (lambda x: round_operand(x, precision))
        texts = queries(config, questions)
        distinct = list(dict.fromkeys(texts))
        out = module.encode(config, weights, distinct, device, operand=operand)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    at = {text: i for i, text in enumerate(distinct)}
    out = out[torch.tensor([at[text] for text in texts], device=out.device)]
    n = len(questions)
    return out[:n], out[n:]
