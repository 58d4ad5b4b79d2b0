"""On-device BERT-family encoder on PyTorch (port of ``hipporag_tpu/embedding/jax_encoder.py``).

The forward pass is the JAX package's, op for op: token + position + type
embeddings, LayerNorm, per layer self-attention (two products and a float32
softmax) and a tanh-GELU MLP, each followed by a residual LayerNorm, then
masked mean pooling and an L2 norm. ``compute_dtype="bfloat16"`` rounds
the operands of every product to bfloat16 and keeps float32 results, as
``preferred_element_type=jnp.float32`` does: on CUDA through cuBLAS
products with a float32 output (``out_dtype``), on the CPU by products of
the bf16-rounded operands in float32, which are exact and summed in
float32. The residual stream, LayerNorm, softmax and pooling are float32.
Masked logits are -1e30, not -inf, so a row without a real token pools to
a zero vector and not to NaN.

Weights come from ``params_random`` (the JAX package's random model, drawn
bit-identically from the same numpy stream), from an HF BERT ``state_dict``
(``params_from_state_dict``; ``params_from_hf_bert`` loads a checkpoint
through ``transformers``, imported only then), or from the JAX pytree
(``hipporag_tpu_torch.convert.encoder_params_from_jax``). All three give
the JAX layout: linear weights ``[in, out]``, applied as ``x @ W``.

Selected by the ``jax/<model-or-path>`` embedding names, so one
``BaseConfig`` drives both packages; ``jax/random-<dim>x<layers>`` is the
offline model with its hashing tokenizer.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import full_f32
from .base import BaseEmbeddingModel

_BF16 = torch.bfloat16
_F32 = torch.float32
_LINEARS = ("q", "k", "v", "attn_out", "ffn_in", "ffn_out")


def torch_dtype(compute_dtype: str) -> torch.dtype:
    if compute_dtype == "bfloat16":
        return _BF16
    if compute_dtype == "float32":
        return _F32
    raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")


# ----------------------------------------------------------------------
# Functional encoder
# ----------------------------------------------------------------------
def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as an operand of a product in ``dtype``: bfloat16 on CUDA (for
    cuBLAS), float32 holding the bf16-rounded values on the CPU."""
    if dtype == _F32:
        return x
    x = x.to(_BF16)
    return x if x.is_cuda else x.float()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b`` of two :func:`_operand` results ([M, K] x [K, N], or batched)."""
    if a.dtype == _BF16:
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=_F32)
    return a @ b


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-12):
    """LayerNorm with the biased variance, as ``jnp.var``."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    lead = x.shape[:-1]
    return (_matmul(_operand(x.reshape(-1, x.shape[-1]), dtype), w) + b).reshape(*lead, w.shape[1])


def _attention(x: torch.Tensor, layer: "EncoderLayer", mask: torch.Tensor, num_heads: int,
               dtype: torch.dtype) -> torch.Tensor:
    b, l, d = x.shape
    hd = d // num_heads

    def split(t):  # [B, L, D] -> [B*H, L, hd]
        return t.reshape(b, l, num_heads, hd).transpose(1, 2).reshape(b * num_heads, l, hd)

    q = split(_dense(x, layer.q_w, layer.q_b, dtype))
    k = split(_dense(x, layer.k_w, layer.k_b, dtype))
    v = split(_dense(x, layer.v_w, layer.v_b, dtype))

    logits = _matmul(_operand(q, dtype), _operand(k, dtype).transpose(1, 2)).div_(math.sqrt(hd))
    logits = logits.view(b, num_heads, l, l).masked_fill_(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)  # float32 softmax
    ctx = _matmul(_operand(probs.view(b * num_heads, l, l), dtype), _operand(v, dtype))
    ctx = ctx.view(b, num_heads, l, hd).transpose(1, 2).reshape(b, l, d)
    out = _dense(ctx, layer.attn_out_w, layer.attn_out_b, dtype)
    return _layernorm(x + out, layer.attn_ln_s, layer.attn_ln_b)


def _ffn(x: torch.Tensor, layer: "EncoderLayer", dtype: torch.dtype) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh form
    h = F.gelu(_dense(x, layer.ffn_in_w, layer.ffn_in_b, dtype), approximate="tanh")
    out = _dense(h, layer.ffn_out_w, layer.ffn_out_b, dtype)
    return _layernorm(x + out, layer.ffn_ln_s, layer.ffn_ln_b)


def _forward_body(enc: "BertEncoder", input_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Shared encoder body: integer ids + bool mask [B, L] -> [B, D] float32 embeddings."""
    l = input_ids.shape[1]
    x = F.embedding(input_ids, enc.word_emb) + enc.pos_emb[:l][None] + enc.type_emb[0][None, None]
    x = _layernorm(x, enc.emb_ln_s, enc.emb_ln_b)
    for layer in enc.layers:
        x = _attention(x, layer, mask, enc.num_heads, enc.dtype)
        x = _ffn(x, layer, enc.dtype)

    m = mask[..., None].to(x.dtype)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp_min(1e-12)


class EncoderLayer(nn.Module):
    """One transformer layer's weights: linears ``[in, out]`` as product
    operands, biases and LayerNorm parameters in float32."""

    def __init__(self, layer: Dict, dtype: torch.dtype, device):
        super().__init__()
        for name in _LINEARS:
            self.register_buffer(f"{name}_w", _operand(_as_tensor(layer[f"{name}_w"], device), dtype))
            self.register_buffer(f"{name}_b", _as_tensor(layer[f"{name}_b"], device))
        for name in ("attn_ln_s", "attn_ln_b", "ffn_ln_s", "ffn_ln_b"):
            self.register_buffer(name, _as_tensor(layer[name], device))


def _as_tensor(x, device) -> torch.Tensor:
    """A numpy or torch leaf as a contiguous float32 tensor on ``device``."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return t.to(device=device, dtype=_F32).contiguous()


class BertEncoder(nn.Module):
    """The encoder's weights on one device, held once in the form the
    forward uses, so a forward casts no weight.

    ``params`` is the JAX package's pytree layout with numpy (or torch)
    leaves. The linear weights are product operands (:func:`_operand`):
    under ``compute_dtype="bfloat16"`` bfloat16 on CUDA and their
    bf16-rounded values in float32 on the CPU; embeddings, biases and
    LayerNorm stay float32.
    """

    def __init__(self, params: Dict, num_heads: int, compute_dtype: str = "bfloat16",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = torch.device(device)
        self.num_heads = int(num_heads)
        self.compute_dtype = compute_dtype
        self.dtype = torch_dtype(compute_dtype)
        for name in ("word_emb", "pos_emb", "type_emb", "emb_ln_s", "emb_ln_b"):
            self.register_buffer(name, _as_tensor(params[name], device))
        self.layers = nn.ModuleList(EncoderLayer(p, self.dtype, device) for p in params["layers"])

    @property
    def device(self) -> torch.device:
        return self.word_emb.device

    @property
    def max_positions(self) -> int:
        return int(self.pos_emb.shape[0])

    @property
    def dim(self) -> int:
        return int(self.word_emb.shape[1])

    def forward(self, input_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return _forward_body(self, input_ids, mask)

    @torch.inference_mode()
    def encode_forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Mean-pooled, L2-normalized embeddings [B, D] (float32) from ids and a mask."""
        return _forward_body(self, input_ids, attention_mask.to(torch.bool))

    @torch.inference_mode()
    def encode_forward_wire(self, input_ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """:meth:`encode_forward` for right-padded rows: the mask is rebuilt
        on the device from the per-row count of real tokens."""
        l = input_ids.shape[1]
        mask = torch.arange(l, device=lengths.device)[None, :] < lengths[:, None]
        return _forward_body(self, input_ids, mask)


# ----------------------------------------------------------------------
# Weight loading / init
# ----------------------------------------------------------------------
def params_random(dim: int, num_layers: int, vocab: int = 30522, max_len: int = 512,
                  seed: int = 0) -> tuple[Dict, int]:
    """The JAX package's random model (numpy leaves): the same
    ``default_rng(seed)`` draws in the same order, so the weights are
    bit-identical to ``jax_encoder.params_random``."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return rng.standard_normal(shape).astype(np.float32) * scale

    def ones(n):
        return np.ones(n, np.float32)

    def zeros(n):
        return np.zeros(n, np.float32)

    num_heads = max(1, dim // 64)
    ffn = dim * 4
    params = {
        "word_emb": w(vocab, dim),
        "pos_emb": w(max_len, dim),
        "type_emb": w(2, dim),
        "emb_ln_s": ones(dim), "emb_ln_b": zeros(dim),
        "layers": [
            {
                "q_w": w(dim, dim), "q_b": zeros(dim),
                "k_w": w(dim, dim), "k_b": zeros(dim),
                "v_w": w(dim, dim), "v_b": zeros(dim),
                "attn_out_w": w(dim, dim), "attn_out_b": zeros(dim),
                "attn_ln_s": ones(dim), "attn_ln_b": zeros(dim),
                "ffn_in_w": w(dim, ffn), "ffn_in_b": zeros(ffn),
                "ffn_out_w": w(ffn, dim), "ffn_out_b": zeros(dim),
                "ffn_ln_s": ones(dim), "ffn_ln_b": zeros(dim),
            }
            for _ in range(num_layers)
        ],
    }
    return params, num_heads


def params_from_state_dict(sd: Dict[str, torch.Tensor], num_layers: int) -> Dict:
    """An HF BERT ``state_dict`` (``BertModel`` keys) as the JAX layout.

    torch ``Linear`` stores ``[out, in]``; the encoder applies ``x @ W``
    with ``W`` as ``[in, out]``, so each linear weight is transposed.
    """

    def t(name):
        return sd[name].detach().float()

    def lin(prefix):
        return t(f"{prefix}.weight").T.contiguous(), t(f"{prefix}.bias")

    params = {
        "word_emb": t("embeddings.word_embeddings.weight"),
        "pos_emb": t("embeddings.position_embeddings.weight"),
        "type_emb": t("embeddings.token_type_embeddings.weight"),
        "emb_ln_s": t("embeddings.LayerNorm.weight"),
        "emb_ln_b": t("embeddings.LayerNorm.bias"),
        "layers": [],
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        layer = {}
        for name, sub in (("q", "attention.self.query"), ("k", "attention.self.key"),
                          ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                          ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense")):
            layer[f"{name}_w"], layer[f"{name}_b"] = lin(f"{p}.{sub}")
        layer["attn_ln_s"] = t(f"{p}.attention.output.LayerNorm.weight")
        layer["attn_ln_b"] = t(f"{p}.attention.output.LayerNorm.bias")
        layer["ffn_ln_s"] = t(f"{p}.output.LayerNorm.weight")
        layer["ffn_ln_b"] = t(f"{p}.output.LayerNorm.bias")
        params["layers"].append(layer)
    return params


def params_from_hf_bert(model_name_or_path: str) -> tuple[Dict, int]:
    """Load an HF BERT-architecture checkpoint (needs ``transformers``)."""
    from transformers import AutoModel

    model = AutoModel.from_pretrained(model_name_or_path)
    cfg = model.config
    return params_from_state_dict(model.state_dict(), cfg.num_hidden_layers), cfg.num_attention_heads


class _HashTokenizer:
    """Deterministic whitespace tokenizer for the random test model (a copy
    of the JAX package's, whose module imports jax)."""

    def __init__(self, vocab: int = 30522):
        self.vocab = vocab
        self._memo: Dict[str, int] = {}  # md5 per distinct word, once

    def _word_id(self, w: str) -> int:
        wid = self._memo.get(w)
        if wid is None:
            import hashlib

            wid = int(hashlib.md5(w.encode()).hexdigest()[:6], 16) % (self.vocab - 1000) + 1000
            self._memo[w] = wid
        return wid

    def __call__(self, texts: List[str], max_length: int):
        ids, mask = [], []
        for t in texts:
            words = t.lower().split()[: max_length - 2]
            row = [101] + [self._word_id(w) for w in words] + [102]
            ids.append(row)
            mask.append([1] * len(row))
        l = max(len(r) for r in ids)
        ids = [r + [0] * (l - len(r)) for r in ids]
        mask = [r + [0] * (l - len(r)) for r in mask]
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


class _HostArray:
    """A [B, D] result on its way to host memory.

    On CUDA the copy goes into pinned memory without a wait and
    ``np.asarray`` waits on the copy's event, so ``batch_encode`` can
    tokenize the next batch while the device runs this one.
    """

    def __init__(self, x: torch.Tensor):
        self._event = None
        if x.is_cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = x

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)


class TorchEncoderEmbeddingModel(BaseEmbeddingModel):
    """``jax/<hf-model-or-path>`` or ``jax/random-<dim>x<layers>`` on a torch device."""

    # padded sequence lengths, as in the JAX package (clamped to
    # embedding_max_seq_len and the model's positions at encode time)
    _BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)

    def __init__(self, global_config=None, device: Union[str, torch.device] = "cuda",
                 mesh_devices=None):
        super().__init__(global_config)
        cfg = self.global_config
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        spec = cfg.embedding_model_name.split("/", 1)[1]
        m = re.fullmatch(r"random-(\d+)x(\d+)", spec)
        if m:
            params, num_heads = params_random(int(m.group(1)), int(m.group(2)))
            self._tokenize = _HashTokenizer()
        else:
            from transformers import AutoTokenizer

            params, num_heads = params_from_hf_bert(spec)
            tok = AutoTokenizer.from_pretrained(spec)

            def _tokenize(texts, max_length):
                out = tok(texts, padding=True, truncation=True, max_length=max_length,
                          return_tensors="np")
                return out["input_ids"].astype(np.int32), out["attention_mask"].astype(np.int32)

            self._tokenize = _tokenize
        # float16 (like anything but auto/bfloat16) computes in float32, as in the JAX package
        self.compute_dtype = (
            "bfloat16" if cfg.embedding_model_dtype in ("auto", "bfloat16") else "float32"
        )
        self.encoder = BertEncoder(params, num_heads, self.compute_dtype, device)
        self.embedding_dim = self.encoder.dim
        self.device = device
        # multi-device: the batch split over every mesh device, the weights
        # once per distinct device (encoding is data-parallel). Too few
        # CUDA devices for the mesh and none given: unsharded, as in the
        # JAX package
        self._shard_encoders = None
        n_mesh = int(np.prod(cfg.mesh_shape))
        if n_mesh > 1:
            from ..parallel.mesh import mesh_devices_for

            try:
                devices = mesh_devices_for(n_mesh, device, mesh_devices)
            except RuntimeError:
                devices = None
            if devices is not None:
                encoders = {device: self.encoder}
                for d in devices:
                    if d not in encoders:
                        encoders[d] = BertEncoder(params, num_heads, self.compute_dtype, d)
                self._shard_encoders = [encoders[d] for d in devices]

    def format_with_instruction(self, text: str, instruction: str) -> str:
        return text  # symmetric encoder

    def batch_encode(self, texts, instruction: str = "", norm=None) -> np.ndarray:
        """The base class's cached batch encoding, its float32 products
        pinned to full float32 (``utils/precision.full_f32``)."""
        with full_f32():
            return super().batch_encode(texts, instruction, norm)

    def _pad_bucket(self, l: int) -> int:
        max_len = min(self.global_config.embedding_max_seq_len, self.encoder.max_positions)
        for b in self._BUCKETS:
            if b >= max_len:
                return max_len
            if l <= b:
                return b
        return max_len

    def pretokenize(self, texts: List[str]):
        """Host tokenization + bucket padding only (no device work).

        The tokenizer truncates to ``embedding_max_seq_len``; the cut to
        the bucket (at most the model's positions) comes after, so a text
        longer than the model keeps its first ids and loses ``[SEP]``,
        as in the JAX package."""
        ids, mask = self._tokenize(texts, self.global_config.embedding_max_seq_len)
        l = self._pad_bucket(ids.shape[1])
        if ids.shape[1] < l:
            pad = l - ids.shape[1]
            ids = np.pad(ids, ((0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        else:
            ids, mask = ids[:, :l], mask[:, :l]
        return ids, mask

    def encode_pretokenized(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Device forward over ``pretokenize`` output: [B, D] float32 on the device.

        A right-padded mask (always so for ``pretokenize`` output) ships
        only its row lengths and is rebuilt on the device; any other mask
        ships whole."""
        lengths = np.ascontiguousarray(mask, dtype=np.int32).sum(axis=1)
        monotone = bool(
            (mask.astype(bool) == (np.arange(ids.shape[1])[None, :] < lengths[:, None])).all()
        )
        if self._shard_encoders is None:
            return self._forward(self.encoder, ids, mask, lengths, monotone)
        # batch sharding: padded to a multiple of the mesh size with fully
        # masked rows, one chunk per mesh device, concatenated in order
        b_real, n = ids.shape[0], len(self._shard_encoders)
        pad_b = (-b_real) % n
        if pad_b:
            ids = np.pad(ids, ((0, pad_b), (0, 0)))
            mask = np.pad(mask, ((0, pad_b), (0, 0)))
            lengths = np.pad(lengths, (0, pad_b))
        rows = ids.shape[0] // n
        outs = [
            self._forward(enc, ids[i * rows:(i + 1) * rows], mask[i * rows:(i + 1) * rows],
                          lengths[i * rows:(i + 1) * rows], monotone).to(self.device, non_blocking=True)
            for i, enc in enumerate(self._shard_encoders)
        ]
        return torch.cat(outs)[:b_real]

    @staticmethod
    def _forward(enc: BertEncoder, ids, mask, lengths, monotone: bool) -> torch.Tensor:
        """One forward of ``enc`` on its device: the lengths path for a
        right-padded mask, else the whole mask."""
        ids_dev = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(enc.device)
        if monotone:
            return enc.encode_forward_wire(ids_dev, torch.from_numpy(np.ascontiguousarray(lengths)).to(enc.device))
        mask_dev = torch.from_numpy(np.ascontiguousarray(mask, dtype=np.int32)).to(enc.device)
        return enc.encode_forward(ids_dev, mask_dev)

    def _encode_batch(self, texts: List[str]) -> _HostArray:
        ids, mask = self.pretokenize(texts)
        return _HostArray(self.encode_pretokenized(ids, mask))
