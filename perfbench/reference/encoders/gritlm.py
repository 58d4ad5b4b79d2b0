"""A plain GritLM-8x7B embedding model, as its published code computes it
(huggingface.co/GritLM/GritLM-8x7B and the ``gritlm`` package, arXiv:2402.09906;
the decoder is Mixtral-8x7B's, arXiv:2401.04088 and Hugging Face's
``MixtralModel``), in float32.

1. A bidirectional Mixtral decoder (GritLM's ``attn="bbcc"``: a mask at
   padding only): token embedding; per layer ``h = x + o(attn(rms(x)))`` and
   ``x = h + moe(rms(h))``; a final RMSNorm. RMSNorm is ``x * rsqrt(mean(x^2)
   + rms_norm_eps) * w``. Attention has ``num_attention_heads`` query heads
   of ``head_dim`` and ``num_key_value_heads`` key/value heads repeated to
   them (``repeat_kv``: query head h reads key/value head h // repeats),
   rotary positions (``rope_theta``, rotate-half, frequencies and angles in
   float32, positions 0.. from BOS), logits scaled by ``head_dim ** -0.5``
   and a softmax over the real positions.
2. The mixture of experts (``MixtralSparseMoeBlock``): router logits ``l =
   rms(h) @ W_router`` ([num_local_experts], no bias); ``p = softmax(l)`` in
   float32; the ``num_experts_per_tok`` largest ``p`` kept, the lower expert
   index first on a tie, and divided by their sum (``g``); the output is
   ``sum_j g_j * down_j(silu(gate_j(y)) * up_j(y))`` over the chosen experts
   ``j``, each expert computed on the tokens that chose it.
3. The mean over the pooled positions, then an L2 norm.

Instructions, as HippoRAG 2's GritLM wrapper hands them to GritLM's
``encode``: the text is ``"<|user|>\\n{instruction}\\n<|embed|>\\n" +
question`` (``format_query``; ``"<|embed|>\\n" + question`` without an
instruction), no EOS is appended, and the pool mask is the attention mask
with its first ``len(tokenize(instruction))`` positions zeroed, counted with
BOS (``instruction_lens``). Here the instruction is the text up to and
including ``"<|embed|>\\n"``; with BOS at position 0 the mean leaves out BOS,
``<|user|>``, the instruction's words and ``<|embed|>``.

Departures from the published model:

- the tokenizer: words split at white space, case kept; a word's id is 3
  plus the first six hex digits of its MD5 digest modulo ``vocab_size -
  3``; a text reads BOS (1) and its words, at most ``max_length`` ids; the
  checkpoint's SentencePiece tokenizer is not in the repository;
- float32 everywhere (TF32 off for matmul and cuDNN) in place of the
  checkpoint's 16-bit weights and products;
- weights drawn from the seed (the checkpoint is not in the repository):
  every linear (the router's and the experts' included) and the embedding
  N(0, 0.02), every norm scale 1 + N(0, 0.1). Linear weights are ``[in,
  out]``, applied as ``x @ W``; the experts' are stacked, ``gate_w`` and
  ``up_w`` [E, D, F], ``down_w`` [E, F, D]. A random router routes nearly
  evenly, where a trained one would be skewed.
- the tie rule: a stable sort of ``p`` in place of ``torch.topk``, which
  states no order among equal values.

Configuration keys: ``hidden_size``, ``num_hidden_layers``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``intermediate_size``, ``num_local_experts``, ``num_experts_per_tok``,
``vocab_size``, ``rope_theta``, ``rms_norm_eps``,
``max_position_embeddings`` (the tokenizer's longest text) and
``torch_dtype`` (the type the weights are drawn in).

The weights are converted to float32 one layer at a time, each layer
applied to every block of texts before the next is converted.
"""

from __future__ import annotations

import numpy as np
import torch

from .nvembed2 import _DTYPES, Tokenizer as _EOSTokenizer, _rms_norm, _rotate_half, _softmax

BOS = 1
USER, EMBED = "<|user|>\n", "\n<|embed|>\n"


def _layer_shapes(config: dict) -> list:
    d, f = int(config["hidden_size"]), int(config["intermediate_size"])
    hd, e = int(config["head_dim"]), int(config["num_local_experts"])
    h, kv = int(config["num_attention_heads"]), int(config["num_key_value_heads"])
    return [("attn_norm", (d,), "s"), ("q_w", (d, h * hd), "w"), ("k_w", (d, kv * hd), "w"),
            ("v_w", (d, kv * hd), "w"), ("o_w", (h * hd, d), "w"), ("mlp_norm", (d,), "s"),
            ("router_w", (d, e), "w"), ("gate_w", (e, d, f), "w"), ("up_w", (e, d, f), "w"),
            ("down_w", (e, f, d), "w")]


def _generator_seed(seed: int) -> int:
    lo, hi = (int(x) for x in np.random.SeedSequence([int(seed), 6]).generate_state(2, np.uint32))
    return lo | (hi & 0x7FFFFFFF) << 32


def weights(config: dict, seed: int, device) -> dict:
    """Every leaf drawn on ``device`` in the configuration's ``torch_dtype``,
    one at a time from one generator: the embedding and the final norm, then
    each layer's."""
    device = torch.device(device)
    dtype = _DTYPES[config["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(_generator_seed(seed))

    def draw(shape, kind):
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return x.mul_(0.1).add_(1.0) if kind == "s" else x.mul_(0.02)

    d = int(config["hidden_size"])
    out = {"embed": draw((int(config["vocab_size"]), d), "w"), "norm": draw((d,), "s")}
    out["layers"] = [{name: draw(shape, kind) for name, shape, kind in _layer_shapes(config)}
                     for _ in range(int(config["num_hidden_layers"]))]
    return out


class Tokenizer(_EOSTokenizer):
    """The hashing tokenizer of the module's docstring: BOS and the words, no EOS."""

    def __call__(self, texts, max_length: int):
        rows = [[BOS] + self.words(t)[: max_length - 1] for t in texts]
        width = max(len(r) for r in rows)
        ids = np.zeros((len(rows), width), np.int32)
        mask = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask


def tokenizer(config: dict) -> Tokenizer:
    return Tokenizer(config["vocab_size"])


def format_query(config: dict, instruction: str, text: str) -> str:
    return (f"{USER}{instruction}{EMBED}" if instruction else EMBED[1:]) + text


def masked_positions(tok: Tokenizer, text: str) -> int:
    """How many leading positions the mean leaves out: BOS and the instruction's tokens."""
    if text.startswith(USER) and EMBED in text:
        return 1 + len(tok.words(text[:text.index(EMBED) + len(EMBED)]))
    if text.startswith(EMBED[1:]):
        return 1 + len(tok.words(EMBED[1:]))
    return 0


def _silu(x):
    return x * torch.sigmoid(x)


def _moe(hs, p, config, mm):
    """The mixture-of-experts block on normed rows ``hs`` [b, n, d]."""
    flat = hs.reshape(-1, hs.shape[-1])
    probs = _softmax(mm(flat, p["router_w"]))
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top = int(config["num_experts_per_tok"])
    gates, chosen = order.values[:, :top], order.indices[:, :top]
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(flat)
    for e in range(p["router_w"].shape[1]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            x = flat[tok]
            h = _silu(mm(x, p["gate_w"][e])) * mm(x, p["up_w"][e])
            out.index_add_(0, tok, mm(h, p["down_w"][e]) * gates[tok, slot, None])
    return out.view(hs.shape)


def _decoder_layer(x, real, p, config, cos, sin, mm):
    b, n, _ = x.shape
    h, kv, hd = int(config["num_attention_heads"]), int(config["num_key_value_heads"]), int(config["head_dim"])
    eps = float(config["rms_norm_eps"])
    hs = _rms_norm(x, p["attn_norm"], eps)
    q = mm(hs, p["q_w"]).view(b, n, h, hd).transpose(1, 2)
    k = mm(hs, p["k_w"]).view(b, n, kv, hd).transpose(1, 2)
    v = mm(hs, p["v_w"]).view(b, n, kv, hd).transpose(1, 2)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    k, v = k.repeat_interleave(h // kv, dim=1), v.repeat_interleave(h // kv, dim=1)
    logits = mm(q, k.transpose(-1, -2)) * hd ** -0.5
    logits = logits.masked_fill(~real[:, None, None, :], float("-inf"))
    ctx = mm(_softmax(logits), v).transpose(1, 2).reshape(b, n, h * hd)
    x = x + mm(ctx, p["o_w"])
    return x + _moe(_rms_norm(x, p["mlp_norm"], eps), p, config, mm)


def encode(config: dict, weights: dict, texts, device, operand=None, block: int = 256) -> torch.Tensor:
    device = torch.device(device)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rnd = operand or (lambda x: x)

    def mm(a, b):
        return rnd(a) @ rnd(b)

    try:
        tok = tokenizer(config)
        hd = int(config["head_dim"])
        inv_freq = 1.0 / float(config["rope_theta"]) ** (torch.arange(0, hd, 2, device=device).float() / hd)
        blocks = []
        for start in range(0, len(texts), block):
            part = texts[start:start + block]
            ids, mask = tok(part, int(config["max_position_embeddings"]))
            pool = mask.copy()
            for i, text in enumerate(part):
                pool[i, :masked_positions(tok, text)] = 0
            ids = torch.from_numpy(ids).long().to(device)
            angles = torch.arange(ids.shape[1], device=device).float()[:, None] * inv_freq[None, :]
            angles = torch.cat((angles, angles), dim=-1)
            blocks.append({"x": weights["embed"][ids].float(), "real": torch.from_numpy(mask).bool().to(device),
                           "pool": torch.from_numpy(pool).bool().to(device), "cos": angles.cos(),
                           "sin": angles.sin()})
        for layer in weights["layers"]:
            p = {k: v.float() for k, v in layer.items()}
            for blk in blocks:
                blk["x"] = _decoder_layer(blk["x"], blk["real"], p, config, blk["cos"], blk["sin"], mm)
            del p
        norm, eps = weights["norm"].float(), float(config["rms_norm_eps"])
        out = []
        for blk in blocks:
            x = _rms_norm(blk["x"], norm, eps)
            m = blk["pool"][..., None].float()
            pooled = (x * m).sum(1) / m.sum(1)
            out.append(pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True))
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
