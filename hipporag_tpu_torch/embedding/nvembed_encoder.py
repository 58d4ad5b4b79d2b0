"""NV-Embed-v2 on a torch device, built from a parameter dict.

The model (huggingface.co/nvidia/NV-Embed-v2, ``modeling_nvembed.py``;
arXiv:2405.17428) has three parts:

1. a bidirectional Mistral-7B decoder: token embedding, then per layer a
   pre-RMSNorm grouped-query self-attention (``num_attention_heads`` query
   heads share ``num_key_value_heads`` key/value heads; query head ``h``
   reads key/value head ``h // (heads / kv_heads)``, Mistral's
   ``repeat_kv``) with rotary positions (``rope_theta``, the rotate-half
   form, positions 0.. counted from BOS) and a mask at padding only, and a
   pre-RMSNorm SwiGLU MLP (``down(silu(gate(x)) * up(x))``), each added to
   the residual; a final RMSNorm; no LM head;
2. latent-attention pooling: a cross-attention block whose queries are the
   decoder's last hidden states after a LayerNorm and whose keys and values
   come from ``num_latents`` learned latents after their own LayerNorm
   (``num_cross_heads`` heads of ``cross_dim_head``, no bias, softmax
   scaled by ``cross_dim_head ** -0.5``), then a GEGLU MLP block
   (``x * gelu(gate)``, the exact GELU, ``latent_mlp_mult`` widths, with
   biases), each pre-LayerNorm (affine, eps 1e-5) with a residual;
3. a mean over the pooled positions and an L2 norm.

Instructions: a text under an instruction reads ``"Instruct:
{instruction}\\nQuery: " + text``, then EOS (``format_with_instruction`` and
the tokenizer). NV-Embed-v2's ``encode`` leaves out of the mean the first
``len(tokenizer.tokenize(prefix))`` positions of the tokenized text, the
prefix counted without BOS; since BOS sits at position 0, that is BOS and
every token of the prefix but its last. In this route's tokenizer (words
split at white space) the prefix is ``Instruct:``, the instruction's words
and ``Query:``: BOS and every prefix word up to the instruction's last are
left out, and ``Query:``, the question's words and EOS are pooled. All
positions are attended to. A text without an instruction pools every real
position.

Precision: every product has ``compute_dtype`` operands and a float32
result (:func:`encoder._operand` / :func:`encoder._matmul`: bf16 cuBLAS
products with a float32 output on CUDA, bf16-rounded operands in float32 on
the CPU). RMSNorm, LayerNorm, RoPE, softmax, the SiLU and GELU gates, the
residual stream and the pooling are float32. Between a decoder layer's six
products the element-wise work (the residual adds, the norms, RoPE, the
layouts of the grouped heads, the masked softmax, SwiGLU and the casts to
the operand type) is five ops, six calls a layer (:func:`add_rms_norm`,
:func:`rope_qkv`, :func:`masked_softmax`, :func:`ungroup_operand`,
:func:`swiglu`): a hand-written kernel each on CUDA
(``csrc/nvembed_layer.cu``), their plain torch compositions on the CPU.

The latents' keys and values depend on the weights alone. They are
computed once per set of weights, when the model is built (the published
code repeats the latents per text and projects them in every forward: the
same products on the same operands), and held as product operands.

Selected by the embedding name ``NV-Embed-v2/random`` (the published sizes)
or ``NV-Embed-v2/random-<key>=<value>,...`` (sizes by their Hugging Face
names, and ``seed``): weights drawn on the device from the seed, and a
hashing tokenizer with Mistral's 32,000 ids (:class:`HashTokenizer`).
Loading the published checkpoint goes through ``embedding/nvembed.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops._kernels import LaunchCounter, load
from ..utils.precision import full_f32
from ..utils.timing import count
from .base import BaseEmbeddingModel
from .encoder import _HostArray, _matmul, _operand, torch_dtype

ROUTE = "NV-Embed-v2/random"
# nvidia/NV-Embed-v2's config.json: its text_config (Mistral-7B-v0.1) and
# its latent_attention_config
PUBLISHED = {"hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
             "head_dim": 128, "intermediate_size": 14336, "vocab_size": 32000, "rope_theta": 10000.0,
             "rms_norm_eps": 1e-5, "num_latents": 512, "num_cross_heads": 8, "cross_dim_head": 4096,
             "latent_mlp_mult": 4}
LAYER_NORM_EPS = 1e-5  # torch.nn.LayerNorm's default, as the pooling's PreNorm builds it
BOS, EOS = 1, 2
_FIRST_WORD_ID = 3  # above <unk>, <s> and </s>


def parse_name(name: str) -> tuple:
    """(sizes, seed) of an embedding name ``NV-Embed-v2/random[-k=v,...]``."""
    if name != ROUTE and not name.startswith(ROUTE + "-"):
        raise ValueError(f"not an NV-Embed-v2 random route: {name!r}")
    sizes, seed = dict(PUBLISHED), 0
    for item in filter(None, name[len(ROUTE) + 1:].split(",")):
        key, _, value = item.partition("=")
        if key == "seed":
            seed = int(value)
        elif key in sizes:
            sizes[key] = type(PUBLISHED[key])(value)
        else:
            raise ValueError(f"{name!r}: no size {key!r}")
    return sizes, seed


def route_name(sizes: Dict, seed: int = 0) -> str:
    """The embedding name that builds ``sizes`` with weights from ``seed``."""
    items = [f"{k}={sizes[k]}" for k in PUBLISHED if sizes[k] != PUBLISHED[k]]
    items += [f"seed={seed}"] if seed else []
    return ROUTE + ("-" + ",".join(items) if items else "")


# ----------------------------------------------------------------------
# Weights
# ----------------------------------------------------------------------
def param_shapes(sizes: Dict) -> Dict:
    """Every leaf's shape: linear weights ``[in, out]``, applied as ``x @ W``."""
    d, f = sizes["hidden_size"], sizes["intermediate_size"]
    hd, h, kv = sizes["head_dim"], sizes["num_attention_heads"], sizes["num_key_value_heads"]
    inner = sizes["num_cross_heads"] * sizes["cross_dim_head"]
    wide = sizes["latent_mlp_mult"] * d
    layer = {"attn_norm": (d,), "q_w": (d, h * hd), "k_w": (d, kv * hd), "v_w": (d, kv * hd), "o_w": (h * hd, d),
             "mlp_norm": (d,), "gate_w": (d, f), "up_w": (d, f), "down_w": (f, d)}
    return {"embed": (sizes["vocab_size"], d), "layers": [dict(layer) for _ in range(sizes["num_hidden_layers"])],
            "norm": (d,),
            "latents": (sizes["num_latents"], d), "lat_ln_s": (d,), "lat_ln_b": (d,),
            "q_ln_s": (d,), "q_ln_b": (d,), "to_q_w": (d, inner), "to_kv_w": (d, 2 * inner), "to_out_w": (inner, d),
            "ff_ln_s": (d,), "ff_ln_b": (d,), "ff_in_w": (d, 2 * wide), "ff_in_b": (2 * wide,),
            "ff_out_w": (wide, d), "ff_out_b": (d,)}


def params_random(sizes: Dict, seed: int = 0, device: Union[str, torch.device] = "cpu",
                  dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Random weights drawn on ``device`` in ``dtype``, one leaf at a time:
    linears and the embedding N(0, 0.02), latents N(0, 1) (their
    published initialisation), norm scales 1 and biases 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def leaf(name, shape):
        if name.endswith(("norm", "_ln_s")):
            return torch.ones(shape, device=device, dtype=dtype)
        if name.endswith("_b"):
            return torch.zeros(shape, device=device, dtype=dtype)
        scale = 1.0 if name == "latents" else 0.02
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)

    shapes = param_shapes(sizes)
    out = {k: leaf(k, v) for k, v in shapes.items() if k != "layers"}
    out["layers"] = [{k: leaf(k, v) for k, v in layer.items()} for layer in shapes["layers"]]
    return out


def _leaf(x, device) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return t.to(device)


def _weight(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A linear weight as a product operand (:func:`encoder._operand`)."""
    t = _leaf(x, device)
    return _operand(t if t.dtype == dtype else t.float(), dtype).contiguous()


def _vector(x, device) -> torch.Tensor:
    return _leaf(x, device).float().contiguous()


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def _dense(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    lead = x.shape[:-1]
    return _matmul(_operand(x.reshape(-1, x.shape[-1]), dtype), w).reshape(*lead, w.shape[1])


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32."""
    return F.rms_norm(x, x.shape[-1:], scale, eps)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], scale, bias, LAYER_NORM_EPS)


def _rope(x: torch.Tensor, cos: torch.Tensor, signed_sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE, ``x * cos + rotate_half(x) * sin``, on [B, L, heads,
    head_dim]; ``cos`` and ``signed_sin`` are [L, 1, head_dim], the sine's
    first half negated, so that ``rotate_half(x) * sin`` is ``roll(x) *
    signed_sin``, element for element."""
    return x * cos + x.roll(x.shape[-1] // 2, dims=-1) * signed_sin


def _group_queries(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, H, L, hd] -> [B * kv_heads, (H / kv_heads) * L, hd]: the query
    heads that share key/value head g, side by side (head h to g = h // rep)."""
    b, h, l, hd = q.shape
    return q.reshape(b * kv_heads, (h // kv_heads) * l, hd)


def _ungroup(ctx: torch.Tensor, b: int, heads: int) -> torch.Tensor:
    """The inverse of :func:`_group_queries`: [B, H, L, hd]."""
    return ctx.reshape(b, heads, -1, ctx.shape[-1])


# ----------------------------------------------------------------------
# The element-wise chain between a decoder layer's products
# ----------------------------------------------------------------------
# Each op below runs its plain torch composition (``<op>_plain``, beside it)
# on a CPU tensor and its kernel in csrc/nvembed_layer.cu on a CUDA tensor:
# six launches per layer in place of some 30 torch ops. A CUDA operand the
# kernel does not take raises. The ops write the next product's operand in
# ``dtype`` (bfloat16 on CUDA, as :func:`encoder._operand` casts it; float32
# holding the rounded values on the CPU).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_KERNEL_ARGS = {  # each takes the stream last
    "add_rms_norm": [_P, _P, _P, _P, ctypes.c_int, _I, _I, _F],
    "rope_qkv": [_P, _P, _P, _P, _P, _P, ctypes.c_int, _I, _I, _I, _I, _I],
    "masked_softmax": [_P, _P, _P, ctypes.c_int, _I, _I, _I, _F],
    "ungroup_operand": [_P, _P, ctypes.c_int, _I, _I, _I, _I, _I],
    "swiglu": [_P, _P, ctypes.c_int, _I, _I],
}
LAUNCHES = {name: LaunchCounter() for name in _KERNEL_ARGS}


def layer_kernel_launches() -> int:
    """Launches of the five kernels so far, in this process."""
    return sum(c.count for c in LAUNCHES.values())


def _cuda_operands(name: str, dtype: torch.dtype, *tensors, ints=()) -> None:
    """Raise unless every tensor is float32 (those in ``ints`` int64),
    contiguous, 16-byte aligned and on one CUDA device, and ``dtype`` is an
    operand type the kernels write."""
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in (*tensors, *ints)):
        raise ValueError(f"{name}: every operand must be on one CUDA device (or all on the CPU)")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: operands in {dtype}; the kernel writes bfloat16 or float32")
    for t, want in [(t, torch.float32) for t in tensors] + [(t, torch.int64) for t in ints]:
        if t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs contiguous, 16-byte aligned {want} operands; got {t.dtype}, "
                             f"shape {tuple(t.shape)}, strides {t.stride()}")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(load("nvembed_layer"), "nvembed_" + name)
    if fn.argtypes is None:
        fn.argtypes = _KERNEL_ARGS[name] + [_P]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):  # the kernel launches on the current device
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nvembed_layer {name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name].add()


def add_rms_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor], scale: torch.Tensor, eps: float,
                       dtype: torch.dtype) -> torch.Tensor:
    if delta is not None:
        x.add_(delta)
    return _operand(_rms_norm(x, scale, eps), dtype)


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor], scale: torch.Tensor, eps: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """``x += delta`` in place (the residual, float32 [M, D]; nothing added
    when ``delta`` is None), then the next product's operand
    ``rms_norm(x) * scale`` in ``dtype``."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta, scale, eps, dtype)
    _cuda_operands("add_rms_norm", dtype, x, scale, *([] if delta is None else [delta]))
    if x.dim() != 2 or tuple(scale.shape) != (x.shape[1],) or (delta is not None and delta.shape != x.shape):
        raise ValueError(f"add_rms_norm: x {tuple(x.shape)}, scale {tuple(scale.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}; want [M, D], [D], [M, D]")
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    _launch("add_rms_norm", x.device, x.data_ptr(), None if delta is None else delta.data_ptr(), scale.data_ptr(),
            y.data_ptr(), int(dtype == torch.bfloat16), x.shape[0], x.shape[1], eps)
    return y


def rope_qkv_plain(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, kv_heads: int,
                   dtype: torch.dtype) -> tuple:
    b, l, _ = qkv.shape
    hd = cos.shape[-1]
    qk = _rope(qkv[..., :(heads + kv_heads) * hd].view(b, l, heads + kv_heads, hd), cos, sin)
    q = _group_queries(qk[:, :, :heads].transpose(1, 2), kv_heads)
    k = qk[:, :, heads:].transpose(1, 2).reshape(b * kv_heads, l, hd)
    v = qkv[..., (heads + kv_heads) * hd:].reshape(b, l, kv_heads, hd).transpose(1, 2).reshape(b * kv_heads, l, hd)
    return _operand(q, dtype), _operand(k, dtype), _operand(v, dtype)


def rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, heads: int, kv_heads: int,
             dtype: torch.dtype) -> tuple:
    """The qkv product's output [B, L, (heads + 2 kv_heads) * hd] (float32)
    -> operands (q [B * kv_heads, rep * L, hd] as :func:`_group_queries`
    lays it out, k and v [B * kv_heads, L, hd]), RoPE on q and k
    (:func:`_rope`; ``cos``, ``sin`` [L, 1, hd])."""
    if qkv.device.type == "cpu":
        return rope_qkv_plain(qkv, cos, sin, heads, kv_heads, dtype)
    b, l, width = qkv.shape
    hd = cos.shape[-1]
    _cuda_operands("rope_qkv", dtype, qkv, cos, sin)
    if (hd % 2 or heads % kv_heads or width != (heads + 2 * kv_heads) * hd
            or tuple(cos.shape) != (l, 1, hd) or sin.shape != cos.shape):
        raise ValueError(f"rope_qkv: qkv {tuple(qkv.shape)}, cos {tuple(cos.shape)}, sin {tuple(sin.shape)} "
                         f"for {heads} heads over {kv_heads}; want an even head_dim")
    q = torch.empty(b * kv_heads, (heads // kv_heads) * l, hd, dtype=dtype, device=qkv.device)
    k = torch.empty(b * kv_heads, l, hd, dtype=dtype, device=qkv.device)
    v = torch.empty_like(k)
    _launch("rope_qkv", qkv.device, qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), int(dtype == torch.bfloat16), b, l, heads, kv_heads, hd)
    return q, k, v


def masked_softmax_plain(logits: torch.Tensor, lengths: torch.Tensor, scale: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """Scales ``logits`` in place."""
    b, l = lengths.shape[0], logits.shape[-1]
    key_mask = torch.arange(l, device=logits.device)[None, :] < lengths[:, None]
    masked = logits.mul_(scale).view(b, -1, l).masked_fill_(~key_mask[:, None, :], -1e30)
    return _operand(torch.softmax(masked, dim=-1).view(logits.shape), dtype)


def masked_softmax(logits: torch.Tensor, lengths: torch.Tensor, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """QK^T logits [B * kv, R, L] (float32, rows of text b = row // kv) ->
    probabilities in ``dtype``: ``softmax(logits * scale)`` over keys, keys
    at positions >= ``lengths[b]`` at -1e30."""
    if logits.device.type == "cpu":
        return masked_softmax_plain(logits, lengths, scale, dtype)
    b, l = lengths.shape[0], logits.shape[-1]
    _cuda_operands("masked_softmax", dtype, logits, ints=(lengths,))
    if logits.dim() != 3 or lengths.dim() != 1 or b == 0 or logits.shape[0] % b:
        raise ValueError(f"masked_softmax: logits {tuple(logits.shape)}, lengths {tuple(lengths.shape)}; "
                         "want [B * kv, R, L] and [B]")
    probs = torch.empty(logits.shape, dtype=dtype, device=logits.device)
    _launch("masked_softmax", logits.device, logits.data_ptr(), lengths.data_ptr(), probs.data_ptr(),
            int(dtype == torch.bfloat16), logits.numel() // l, logits.numel() // (b * l), l, scale)
    return probs


def ungroup_operand_plain(ctx: torch.Tensor, b: int, heads: int, dtype: torch.dtype) -> torch.Tensor:
    return _operand(_ungroup(ctx, b, heads).transpose(1, 2).reshape(-1, heads * ctx.shape[-1]), dtype)


def ungroup_operand(ctx: torch.Tensor, b: int, heads: int, dtype: torch.dtype) -> torch.Tensor:
    """The PV output [B * kv, rep * L, hd] (float32, :func:`_group_queries`'
    layout) -> the o product's operand [B * L, heads * hd] in ``dtype``."""
    if ctx.device.type == "cpu":
        return ungroup_operand_plain(ctx, b, heads, dtype)
    hd = ctx.shape[-1]
    _cuda_operands("ungroup_operand", dtype, ctx)
    kv = ctx.shape[0] // b if b else 0
    if ctx.dim() != 3 or hd % 2 or kv * b != ctx.shape[0] or kv == 0 or heads % kv or ctx.shape[1] % (heads // kv):
        raise ValueError(f"ungroup_operand: ctx {tuple(ctx.shape)} for {b} texts of {heads} heads; "
                         "want [B * kv, (heads / kv) * L, hd] with an even hd")
    l = ctx.shape[1] // (heads // kv)
    out = torch.empty(b * l, heads * hd, dtype=dtype, device=ctx.device)
    _launch("ungroup_operand", ctx.device, ctx.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16), b, l,
            heads, kv, hd)
    return out


def swiglu_plain(gate_up: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return _operand(F.silu(gate) * up, dtype)


def swiglu(gate_up: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gate_up product's output [M, 2F] (float32) -> the down product's
    operand ``silu(gate) * up`` [M, F] in ``dtype``."""
    if gate_up.device.type == "cpu":
        return swiglu_plain(gate_up, dtype)
    _cuda_operands("swiglu", dtype, gate_up)
    if gate_up.dim() != 2 or gate_up.shape[1] % 2:
        raise ValueError(f"swiglu: gate_up {tuple(gate_up.shape)}; want [M, 2F]")
    m, f = gate_up.shape[0], gate_up.shape[1] // 2
    out = torch.empty(m, f, dtype=dtype, device=gate_up.device)
    _launch("swiglu", gate_up.device, gate_up.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16), m, f)
    return out


def _self_attention(y: torch.Tensor, lengths: torch.Tensor, layer: "DecoderLayer", enc: "NVEmbedV2Encoder", cos,
                    sin) -> torch.Tensor:
    """The attention block's o product [B * L, D] (float32) from its normed operand ``y`` [B * L, D]."""
    b = lengths.shape[0]
    h, kv, hd, dtype = enc.heads, enc.kv_heads, enc.head_dim, enc.dtype
    q, k, v = rope_qkv(_matmul(y, layer.qkv_w).view(b, y.shape[0] // b, -1), cos, sin, h, kv, dtype)
    probs = masked_softmax(_matmul(q, k.transpose(1, 2)), lengths, hd ** -0.5, dtype)
    return _matmul(ungroup_operand(_matmul(probs, v), b, h, dtype), layer.o_w)


def _mlp(y: torch.Tensor, layer: "DecoderLayer", enc: "NVEmbedV2Encoder") -> torch.Tensor:
    """The MLP block's down product [B * L, D] (float32) from its normed operand ``y``."""
    return _matmul(swiglu(_matmul(y, layer.gate_up_w), enc.dtype), layer.down_w)


def _latent_attention(x: torch.Tensor, enc: "NVEmbedV2Encoder") -> torch.Tensor:
    """The cross-attention block over the latents' keys and values, with its residual."""
    b, l, _ = x.shape
    heads, dh, dtype = enc.cross_heads, enc.cross_dim_head, enc.dtype
    q = _dense(_layer_norm(x, enc.q_ln_s, enc.q_ln_b), enc.to_q_w, dtype)
    q = q.reshape(b * l, heads, dh).transpose(0, 1)  # [heads, B*L, dh]
    logits = _matmul(_operand(q, dtype), enc.lat_k.transpose(1, 2)).mul_(dh ** -0.5)
    out = _matmul(_operand(torch.softmax(logits, dim=-1), dtype), enc.lat_v)  # [heads, B*L, dh]
    return x + _dense(out.transpose(0, 1).reshape(b, l, heads * dh), enc.to_out_w, dtype)


def _geglu(x: torch.Tensor, enc: "NVEmbedV2Encoder") -> torch.Tensor:
    """The pooling's GEGLU MLP block, with its residual."""
    h = _dense(_layer_norm(x, enc.ff_ln_s, enc.ff_ln_b), enc.ff_in_w, enc.dtype) + enc.ff_in_b
    a, gate = h.chunk(2, dim=-1)
    return x + _dense(a * F.gelu(gate), enc.ff_out_w, enc.dtype) + enc.ff_out_b


def _forward(enc: "NVEmbedV2Encoder", ids: torch.Tensor, lengths: torch.Tensor,
             pool_from: torch.Tensor) -> torch.Tensor:
    """Right-padded ids [B, L], real lengths [B] and the first pooled
    position [B] -> unit rows [B, D] (float32). The residual ``x`` [B * L,
    D] takes each block's product in the next block's :func:`add_rms_norm`."""
    b, l = ids.shape
    cos, sin = enc.rope_tables(l)
    x = F.embedding(ids, enc.embed).float().view(b * l, -1)
    delta = None
    for layer in enc.layers:
        attn = _self_attention(add_rms_norm(x, delta, layer.attn_norm, enc.eps, enc.dtype), lengths, layer, enc,
                               cos, sin)
        delta = _mlp(add_rms_norm(x, attn, layer.mlp_norm, enc.eps, enc.dtype), layer, enc)
    if delta is not None:
        x.add_(delta)
    x = _rms_norm(x.view(b, l, -1), enc.norm, enc.eps)
    x = _geglu(_latent_attention(x, enc), enc)
    pos = torch.arange(l, device=ids.device)
    pool = ((pos[None, :] < lengths[:, None]) & (pos[None, :] >= pool_from[:, None]))[..., None].float()
    pooled = (x * pool).sum(1) / pool.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)


class DecoderLayer(nn.Module):
    """One decoder layer: the query, key and value weights side by side in
    one operand, the gate and up weights in another."""

    def __init__(self, layer: Dict, dtype: torch.dtype, device):
        super().__init__()
        self.register_buffer("attn_norm", _vector(layer["attn_norm"], device))
        self.register_buffer("mlp_norm", _vector(layer["mlp_norm"], device))
        self.register_buffer("qkv_w", torch.cat([_weight(layer[k], dtype, device) for k in ("q_w", "k_w", "v_w")], 1))
        self.register_buffer("o_w", _weight(layer["o_w"], dtype, device))
        self.register_buffer("gate_up_w", torch.cat([_weight(layer[k], dtype, device) for k in ("gate_w", "up_w")], 1))
        self.register_buffer("down_w", _weight(layer["down_w"], dtype, device))


class NVEmbedV2Encoder(nn.Module):
    """NV-Embed-v2's weights on one device in the form the forward uses.

    ``params`` has the leaves of :func:`param_shapes` (numpy or torch, any
    float type). Linear weights become product operands, the embedding
    keeps its type (its rows are read in float32), norms and biases
    are float32, and the latents' keys and values are computed here once.
    """

    def __init__(self, params: Dict, sizes: Dict, compute_dtype: str = "bfloat16",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.dtype = dtype = torch_dtype(compute_dtype)
        self.heads, self.kv_heads = int(sizes["num_attention_heads"]), int(sizes["num_key_value_heads"])
        self.head_dim = int(sizes["head_dim"])
        self.cross_heads, self.cross_dim_head = int(sizes["num_cross_heads"]), int(sizes["cross_dim_head"])
        self.eps = float(sizes["rms_norm_eps"])
        if self.heads % self.kv_heads:
            raise ValueError(f"{self.heads} query heads do not share {self.kv_heads} key/value heads evenly")
        for key, shape in param_shapes(sizes).items():
            if key != "layers" and tuple(params[key].shape) != tuple(shape):
                raise ValueError(f"{key}: shape {tuple(params[key].shape)}, the sizes give {shape}")
        self.register_buffer("embed", _leaf(params["embed"], device))
        self.layers = nn.ModuleList(DecoderLayer(p, dtype, device) for p in params["layers"])
        for name in ("norm", "q_ln_s", "q_ln_b", "ff_ln_s", "ff_ln_b", "ff_in_b", "ff_out_b"):
            self.register_buffer(name, _vector(params[name], device))
        for name in ("to_q_w", "to_out_w", "ff_in_w", "ff_out_w"):
            self.register_buffer(name, _weight(params[name], dtype, device))
        with torch.inference_mode(), full_f32():
            latents = _layer_norm(_vector(params["latents"], device), _vector(params["lat_ln_s"], device),
                                  _vector(params["lat_ln_b"], device))
            kv = _dense(latents, _weight(params["to_kv_w"], dtype, device), dtype)
            for name, t in zip(("lat_k", "lat_v"), kv.chunk(2, dim=-1)):  # [heads, latents, cross_dim_head]
                t = t.reshape(latents.shape[0], self.cross_heads, self.cross_dim_head).transpose(0, 1)
                self.register_buffer(name, _operand(t.contiguous(), dtype))
        # Mistral's rotary frequencies, computed in float32 as its code computes them
        self.register_buffer("inv_freq", 1.0 / float(sizes["rope_theta"]) ** (
            torch.arange(0, self.head_dim, 2, device=device).float() / self.head_dim))
        self._rope_cache: Dict[int, tuple] = {}
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None

    @property
    def device(self) -> torch.device:
        return self.norm.device

    @property
    def dim(self) -> int:
        return int(self.norm.shape[0])

    def rope_tables(self, length: int) -> tuple:
        """(cos, signed sin) [length, 1, head_dim] in float32 for positions
        0..length-1 (:func:`_rope`)."""
        tables = self._rope_cache.get(length)
        if tables is None:
            angles = torch.arange(length, device=self.inv_freq.device).float()[:, None] * self.inv_freq
            sin = angles.sin()
            tables = self._rope_cache[length] = (torch.cat((angles.cos(), angles.cos()), dim=-1)[:, None],
                                                 torch.cat((-sin, sin), dim=-1)[:, None])
        return tables

    @torch.inference_mode()
    def encode_forward(self, ids: torch.Tensor, lengths: torch.Tensor, pool_from: torch.Tensor) -> torch.Tensor:
        """Unit rows [B, D] (float32) of right-padded ``ids`` [B, L]. On
        CUDA the forward of each shape [B, L] is captured once as a CUDA
        graph and replayed: a forward launches some 430-460 kernels, which
        the host could not launch as fast as the card runs them."""
        if not ids.is_cuda:
            return _forward(self, ids, lengths, pool_from)
        graph = self._graphs.get(tuple(ids.shape))
        if graph is None:
            graph = self._graphs[tuple(ids.shape)] = self._capture(ids, lengths, pool_from)
        graph, inputs, out, _launches = graph
        for static, given in zip(inputs, (ids, lengths, pool_from)):
            static.copy_(given)
        graph.replay()
        return out.clone()  # the graph's next replay overwrites ``out``

    def fused_launches(self, shape: tuple) -> int:
        """Launches of the layer kernels (csrc/nvembed_layer.cu) in one
        replay of the forward of ``shape`` [B, L], as counted when it was
        captured; 0 off CUDA, where the forward runs the plain torch ops."""
        graph = self._graphs.get(tuple(shape))
        return graph[3] if graph is not None else 0

    def _capture(self, *inputs) -> tuple:
        """(graph, its input tensors, its output, the layer kernels'
        launches it holds) of one forward of the inputs' shapes. The graphs
        share one memory pool: they replay one at a time on one stream."""
        inputs = tuple(t.clone() for t in inputs)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # an eager forward first, as capture asks (it also fills the RoPE tables)
            _forward(self, *inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = layer_kernel_launches()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            out = _forward(self, *inputs)
        return graph, inputs, out, layer_kernel_launches() - before


# ----------------------------------------------------------------------
# Tokenizer and embedding model
# ----------------------------------------------------------------------
class HashTokenizer:
    """Words split at white space, case kept; a word's id is 3 plus the
    first six hex digits of its MD5 digest modulo ``vocab - 3`` (above
    ``<unk>`` 0, BOS 1 and EOS 2). A text reads BOS, its words and EOS, at
    most ``max_length`` ids."""

    def __init__(self, vocab: int = 32000):
        self.vocab = int(vocab)
        self._memo: Dict[str, int] = {}

    def _word_id(self, w: str) -> int:
        wid = self._memo.get(w)
        if wid is None:
            wid = self._memo[w] = _FIRST_WORD_ID + int(hashlib.md5(w.encode()).hexdigest()[:6], 16) % (
                self.vocab - _FIRST_WORD_ID)
        return wid

    def tokenize(self, text: str) -> List[int]:
        """The text's word ids, without BOS and EOS."""
        return [self._word_id(w) for w in text.split()]

    def __call__(self, texts: List[str], max_length: int):
        """(ids [B, L] int64, lengths [B] int64), right-padded with 0."""
        rows = [[BOS] + self.tokenize(t)[: max_length - 2] + [EOS] for t in texts]
        lengths = np.array([len(r) for r in rows], np.int64)
        ids = np.zeros((len(rows), int(lengths.max())), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        return ids, lengths


class NVEmbedV2DeviceEmbeddingModel(BaseEmbeddingModel):
    """``NV-Embed-v2/random[-k=v,...]`` on a torch device.

    Weights are ``params`` when given (the leaves of :func:`param_shapes`,
    adopted without a copy where they already are operands on the device),
    else drawn on the device from the name's seed. A batch is padded to its
    longest text. Each forward adds ``texts``, ``tokens`` (real positions,
    BOS and EOS included), ``pooled``, ``padded_tokens`` (positions
    computed), ``forwards`` and ``fused_kernels`` (the layer kernels' launches
    the forward replayed; 0 on the CPU) to the open span (``retrieve/embed``
    on the query path)."""

    def __init__(self, global_config=None, device: Union[str, torch.device] = "cuda", params: Optional[Dict] = None):
        super().__init__(global_config)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        sizes, seed = parse_name(self.global_config.embedding_model_name)
        self.compute_dtype = (
            "bfloat16" if self.global_config.embedding_model_dtype in ("auto", "bfloat16") else "float32"
        )
        if params is None:
            params = params_random(sizes, seed, device, torch_dtype(self.compute_dtype))
        self.encoder = NVEmbedV2Encoder(params, sizes, self.compute_dtype, device)
        del params
        self.tokenizer = HashTokenizer(sizes["vocab_size"])
        self.embedding_dim = self.encoder.dim
        self.device = device
        self._pool_from = 0

    def batch_encode(self, texts, instruction: str = "", norm=None) -> np.ndarray:
        """The base class's cached batch encoding; the instruction's prefix
        positions are left out of the mean, as NV-Embed-v2's ``encode``
        leaves them out."""
        self._pool_from = self._masked_positions(instruction)
        try:
            with full_f32():
                return super().batch_encode(texts, instruction, norm)
        finally:
            self._pool_from = 0

    def _masked_positions(self, instruction: str) -> int:
        """How many leading positions the mean leaves out: the tokens of the
        instruction's prefix (the module's docstring)."""
        return len(self.tokenizer.tokenize(self.format_with_instruction("", instruction)))

    def _encode_batch(self, texts: List[str]) -> _HostArray:
        ids, lengths = self.tokenizer(texts, self.global_config.embedding_max_seq_len)
        pool_from = np.minimum(self._pool_from, lengths)
        count("texts", len(texts))
        count("tokens", int(lengths.sum()))
        count("pooled", int((lengths - pool_from).sum()))
        count("padded_tokens", int(ids.size))
        count("forwards", 1)
        dev = self.encoder.device
        out = self.encoder.encode_forward(torch.from_numpy(ids).to(dev), torch.from_numpy(lengths).to(dev),
                                          torch.from_numpy(pool_from).to(dev))
        count("fused_kernels", self.encoder.fused_launches(ids.shape))
        return _HostArray(out)
