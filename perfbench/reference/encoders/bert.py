"""A plain BERT encoder, as the port's on-device encoder states it
(``embedding/encoder.py``): token, position and type-0 embeddings and a
LayerNorm, then per layer self-attention and a GELU MLP, each added to the
residual and followed by a LayerNorm (post-LN), then the mean over the
real tokens and an L2 norm.

Configuration keys (Hugging Face's BERT names): ``hidden_size``,
``num_hidden_layers``, ``num_attention_heads``, ``intermediate_size``,
``vocab_size``, ``max_position_embeddings``, ``layer_norm_eps``,
``hidden_act`` (``gelu`` is the exact form, ``gelu_new`` the tanh form)
and ``torch_dtype`` (the weights' and products' type: ``float32`` or
``bfloat16``).

Weights: linear weights are ``[in, out]`` and applied as ``x @ W``, the
layout of the port's encoder. Every leaf is drawn from the seed: linears,
embeddings and biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.1) and
biases N(0, 0.02), so that each leaf moves the output.

Text: the encoder is symmetric, as the port states its BERT encoder: a
question is read bare under either instruction. Tokens: the text
lowercased and split at white space; each word's id is 1000 plus the
first six hex digits of its MD5 digest modulo ``vocab_size - 1000``,
between ``[CLS]`` (101) and ``[SEP]`` (102), at most ``max_length`` in all.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

CLS, SEP = 101, 102
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _shapes(config: dict) -> list:
    """(name, shape, kind) of every leaf, in the order they are drawn."""
    d, f, layers = int(config["hidden_size"]), int(config["intermediate_size"]), int(config["num_hidden_layers"])
    out = [("word_emb", (int(config["vocab_size"]), d), "w"), ("pos_emb", (int(config["max_position_embeddings"]), d), "w"),
           ("type_emb", (2, d), "w"), ("emb_ln_s", (d,), "s"), ("emb_ln_b", (d,), "w")]
    for i in range(layers):
        for name, shape in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("attn_out", (d, d)),
                            ("ffn_in", (d, f)), ("ffn_out", (f, d))):
            out += [(f"{i}.{name}_w", shape, "w"), (f"{i}.{name}_b", shape[1:], "w")]
        out += [(f"{i}.attn_ln_s", (d,), "s"), (f"{i}.attn_ln_b", (d,), "w"),
                (f"{i}.ffn_ln_s", (d,), "s"), (f"{i}.ffn_ln_b", (d,), "w")]
    return out


def _generator_seed(seed: int) -> int:
    lo, hi = (int(x) for x in np.random.SeedSequence([int(seed), 3]).generate_state(2, np.uint32))
    return lo | (hi & 0x7FFFFFFF) << 32


def weights(config: dict, seed: int, device) -> dict:
    """The port's encoder layout (``word_emb`` ... ``layers``), drawn in two
    calls on ``device`` in the configuration's ``torch_dtype``."""
    device = torch.device(device)
    dtype = _DTYPES[config["torch_dtype"]]
    shapes = _shapes(config)
    sizes = [math.prod(shape) for _n, shape, _k in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(_generator_seed(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype).mul_(0.02)
    scales = torch.randn(sum(s for s, (_n, _sh, k) in zip(sizes, shapes) if k == "s"), generator=gen,
                         device=device, dtype=dtype).mul_(0.1).add_(1.0)
    out = {"layers": [{} for _ in range(int(config["num_hidden_layers"]))]}
    at = at_s = 0
    for (name, shape, kind), size in zip(shapes, sizes):
        if kind == "s":
            leaf = scales[at_s:at_s + size].view(shape)
            at_s += size
        else:
            leaf = flat[at:at + size].view(shape)
            at += size
        if "." in name:
            layer, leaf_name = name.split(".")
            out["layers"][int(layer)][leaf_name] = leaf
        else:
            out[name] = leaf
    return out


class Tokenizer:
    def __init__(self, vocab: int):
        self.vocab = int(vocab)
        self._ids: dict = {}

    def _word(self, w: str) -> int:
        wid = self._ids.get(w)
        if wid is None:
            wid = self._ids[w] = 1000 + int(hashlib.md5(w.encode()).hexdigest()[:6], 16) % (self.vocab - 1000)
        return wid

    def __call__(self, texts, max_length: int):
        rows = [[CLS] + [self._word(w) for w in t.lower().split()[: max_length - 2]] + [SEP] for t in texts]
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
    return text


def _layer_norm(x, scale, bias, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _gelu(x, act: str):
    if act == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if act in ("gelu_new", "gelu_pytorch_tanh"):
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    raise ValueError(f"no activation {act!r}")


def encode(config: dict, weights: dict, texts, device, operand=None, block: int = 256) -> torch.Tensor:
    device = torch.device(device)
    heads = int(config["num_attention_heads"])
    eps = float(config["layer_norm_eps"])
    act = config["hidden_act"]
    w = {k: v.float() for k, v in weights.items() if k != "layers"}
    layers = [{k: v.float() for k, v in layer.items()} for layer in weights["layers"]]
    rnd = operand or (lambda x: x)

    def mm(a, b):
        return rnd(a) @ rnd(b)

    tok = tokenizer(config)
    out = []
    for start in range(0, len(texts), block):
        ids, mask = tok(texts[start:start + block], int(config["max_position_embeddings"]))
        ids = torch.from_numpy(ids).long().to(device)
        real = torch.from_numpy(mask).bool().to(device)
        b, n = ids.shape
        x = w["word_emb"][ids] + w["pos_emb"][:n][None] + w["type_emb"][0]
        x = _layer_norm(x, w["emb_ln_s"], w["emb_ln_b"], eps)
        for p in layers:
            def heads_of(t):
                return t.view(b, n, heads, -1).transpose(1, 2)

            q, k, v = (heads_of(mm(x, p[f"{s}_w"]) + p[f"{s}_b"]) for s in ("q", "k", "v"))
            logits = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
            logits = logits.masked_fill(~real[:, None, None, :], float("-inf"))
            ctx = mm(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, n, -1)
            x = _layer_norm(x + mm(ctx, p["attn_out_w"]) + p["attn_out_b"], p["attn_ln_s"], p["attn_ln_b"], eps)
            h = _gelu(mm(x, p["ffn_in_w"]) + p["ffn_in_b"], act)
            x = _layer_norm(x + mm(h, p["ffn_out_w"]) + p["ffn_out_b"], p["ffn_ln_s"], p["ffn_ln_b"], eps)
        m = real[..., None].float()
        pooled = (x * m).sum(1) / m.sum(1)
        out.append(pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True))
    return torch.cat(out)
