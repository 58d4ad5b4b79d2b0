"""A plain NV-Embed-v2, as its published code computes it
(huggingface.co/nvidia/NV-Embed-v2: ``config.json`` and
``modeling_nvembed.py``; arXiv:2405.17428), in float32.

1. A bidirectional Mistral-7B decoder (``MistralModel`` with a mask at
   padding only): token embedding; per layer ``h = x + o(attn(rms(x)))``
   and ``x = h + down(silu(gate(rms(h))) * up(rms(h)))``; a final RMSNorm.
   RMSNorm is ``x * rsqrt(mean(x^2) + rms_norm_eps) * w``. Attention has
   ``num_attention_heads`` query heads of ``head_dim`` and
   ``num_key_value_heads`` key/value heads repeated to them
   (``repeat_kv``: query head h reads key/value head h // repeats), rotary
   positions (``rope_theta``, rotate-half, frequencies and angles in
   float32 as Mistral's code computes them, positions 0.. from BOS), logits
   scaled by ``head_dim ** -0.5`` and a softmax over the real positions.
2. Latent-attention pooling (``LatentAttentionModel``): ``x = x +
   to_out(attn(q=to_q(LN_q(x)), kv=to_kv(LN_kv(latents))))`` with
   ``num_cross_heads`` heads of ``cross_dim_head``, no bias, logits scaled
   by ``cross_dim_head ** -0.5``, the keys and values projected from the
   ``num_latents`` latents for every block of texts as the published code
   projects them for every batch; then ``x = x + W2(a * gelu(g)) + b2``
   with ``[a, g] = W1(LN_ff(x)) + b1`` (GEGLU, the exact GELU, inner width
   ``latent_mlp_mult * hidden_size``). LayerNorms are affine with the
   biased variance and eps 1e-5 (``torch.nn.LayerNorm``'s default).
3. The mean over the pooled positions, then an L2 norm.

Instructions, as HippoRAG 2's ``NVEmbedV2`` hands them to NV-Embed-v2's
``encode``: the text is ``"Instruct: {instruction}\\nQuery: " + question``
(``format_query``), EOS is appended, and the pool mask is the attention
mask with its first ``len(tokenizer.tokenize(prefix))`` positions zeroed,
the prefix counted without BOS. Here a text that starts with
``"Instruct: "`` and holds ``"\\nQuery: "`` has its prefix up to and
including that separator; with BOS at position 0, the mean leaves out BOS
and every word of the prefix but ``Query:``.

Departures from the published model:

- the tokenizer: words split at white space, case kept; a word's id is 3
  plus the first six hex digits of its MD5 digest modulo ``vocab_size -
  3``; a text reads BOS (1), its words and EOS (2), at most ``max_length``
  ids; Mistral's SentencePiece tokenizer is not in the repository;
- float32 everywhere (TF32 off for matmul and cuDNN) in place of the
  checkpoint's 16-bit weights and products;
- weights drawn from the seed (the checkpoint is not in the repository):
  every linear, the embedding and every bias N(0, 0.02), every norm scale
  1 + N(0, 0.1), the latents N(0, 1), so that each leaf moves the output.
  Linear weights are ``[in, out]``, applied as ``x @ W``.

Configuration keys: ``hidden_size``, ``num_hidden_layers``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``intermediate_size``, ``vocab_size``, ``rope_theta``, ``rms_norm_eps``,
``num_latents``, ``num_cross_heads``, ``cross_dim_head``,
``latent_mlp_mult``, ``max_position_embeddings`` (the tokenizer's longest
text) and ``torch_dtype`` (the type the weights are drawn in).

The weights are converted to float32 one layer at a time, each layer
applied to every block of texts before the next is converted.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

BOS, EOS = 1, 2
FIRST_WORD = 3
LN_EPS = 1e-5
PREFIX, SEPARATOR = "Instruct: ", "\nQuery: "
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer_shapes(config: dict) -> list:
    d, f = int(config["hidden_size"]), int(config["intermediate_size"])
    hd = int(config["head_dim"])
    h, kv = int(config["num_attention_heads"]), int(config["num_key_value_heads"])
    return [("attn_norm", (d,), "s"), ("q_w", (d, h * hd), "w"), ("k_w", (d, kv * hd), "w"),
            ("v_w", (d, kv * hd), "w"), ("o_w", (h * hd, d), "w"), ("mlp_norm", (d,), "s"),
            ("gate_w", (d, f), "w"), ("up_w", (d, f), "w"), ("down_w", (f, d), "w")]


def _top_shapes(config: dict) -> list:
    d = int(config["hidden_size"])
    inner = int(config["num_cross_heads"]) * int(config["cross_dim_head"])
    wide = int(config["latent_mlp_mult"]) * d
    return [("embed", (int(config["vocab_size"]), d), "w"), ("norm", (d,), "s"),
            ("latents", (int(config["num_latents"]), d), "latent"), ("lat_ln_s", (d,), "s"), ("lat_ln_b", (d,), "w"),
            ("q_ln_s", (d,), "s"), ("q_ln_b", (d,), "w"), ("to_q_w", (d, inner), "w"),
            ("to_kv_w", (d, 2 * inner), "w"), ("to_out_w", (inner, d), "w"),
            ("ff_ln_s", (d,), "s"), ("ff_ln_b", (d,), "w"), ("ff_in_w", (d, 2 * wide), "w"),
            ("ff_in_b", (2 * wide,), "w"), ("ff_out_w", (wide, d), "w"), ("ff_out_b", (d,), "w")]


def _generator_seed(seed: int) -> int:
    lo, hi = (int(x) for x in np.random.SeedSequence([int(seed), 5]).generate_state(2, np.uint32))
    return lo | (hi & 0x7FFFFFFF) << 32


def weights(config: dict, seed: int, device) -> dict:
    """Every leaf drawn on ``device`` in the configuration's ``torch_dtype``,
    one at a time from one generator: the top-level leaves, then each
    layer's."""
    device = torch.device(device)
    dtype = _DTYPES[config["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(_generator_seed(seed))

    def draw(shape, kind):
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        if kind == "s":
            return x.mul_(0.1).add_(1.0)
        return x if kind == "latent" else x.mul_(0.02)

    out = {name: draw(shape, kind) for name, shape, kind in _top_shapes(config)}
    out["layers"] = [{name: draw(shape, kind) for name, shape, kind in _layer_shapes(config)}
                     for _ in range(int(config["num_hidden_layers"]))]
    return out


class Tokenizer:
    def __init__(self, vocab: int):
        self.vocab = int(vocab)
        self._ids: dict = {}

    def words(self, text: str) -> list:
        out = []
        for w in text.split():
            wid = self._ids.get(w)
            if wid is None:
                wid = self._ids[w] = FIRST_WORD + int(hashlib.md5(w.encode()).hexdigest()[:6], 16) % (
                    self.vocab - FIRST_WORD)
            out.append(wid)
        return out

    def __call__(self, texts, max_length: int):
        rows = [[BOS] + self.words(t)[: max_length - 2] + [EOS] for t in texts]
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
    return f"{PREFIX}{instruction}{SEPARATOR}{text}"


def masked_positions(tok: Tokenizer, text: str) -> int:
    """How many leading positions the mean leaves out: the prefix's tokens."""
    if not text.startswith(PREFIX) or SEPARATOR not in text:
        return 0
    return len(tok.words(text[:text.index(SEPARATOR) + len(SEPARATOR)]))


def _rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _layer_norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale + bias


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def _softmax(logits):
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


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
    hs = _rms_norm(x, p["mlp_norm"], eps)
    g = mm(hs, p["gate_w"])
    return x + mm(g * torch.sigmoid(g) * mm(hs, p["up_w"]), p["down_w"])


def _pool(x, pool, w, config, mm):
    b, n, d = x.shape
    heads, dh = int(config["num_cross_heads"]), int(config["cross_dim_head"])
    ctx = _layer_norm(w["latents"], w["lat_ln_s"], w["lat_ln_b"])
    k, v = mm(ctx, w["to_kv_w"]).chunk(2, dim=-1)
    q = mm(_layer_norm(x, w["q_ln_s"], w["q_ln_b"]), w["to_q_w"]).view(b, n, heads, dh).transpose(1, 2)
    k = k.view(-1, heads, dh).transpose(0, 1)[None]
    v = v.view(-1, heads, dh).transpose(0, 1)[None]
    attn = mm(_softmax(mm(q, k.transpose(-1, -2)) * dh ** -0.5), v)
    x = x + mm(attn.transpose(1, 2).reshape(b, n, heads * dh), w["to_out_w"])
    a, gate = (mm(_layer_norm(x, w["ff_ln_s"], w["ff_ln_b"]), w["ff_in_w"]) + w["ff_in_b"]).chunk(2, dim=-1)
    x = x + mm(a * _gelu(gate), w["ff_out_w"]) + w["ff_out_b"]
    m = pool[..., None].float()
    pooled = (x * m).sum(1) / m.sum(1)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)


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
        w = {k: v.float() for k, v in weights.items() if k not in ("layers", "embed")}
        eps = float(config["rms_norm_eps"])
        return torch.cat([_pool(_rms_norm(blk["x"], w["norm"], eps), blk["pool"], w, config, mm) for blk in blocks])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
