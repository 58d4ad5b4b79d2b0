"""GritLM-8x7B's embedding model on a torch device, built from a parameter dict.

GritLM (huggingface.co/GritLM/GritLM-8x7B; arXiv:2402.09906) reads
embeddings with a Mixtral-8x7B decoder (arXiv:2401.04088) under
bidirectional attention, masked at padding only (its ``attn="bbcc"``
mode): token embedding; per layer a pre-RMSNorm grouped-query
self-attention with rotary positions, NV-Embed-v2's decoder attention
(``nvembed_encoder.py``: the same ops, shared with it), and a pre-RMSNorm
sparse mixture of experts (``ops/moe.py``): a linear router (no bias) over
``num_local_experts`` SwiGLU experts, each token's top
``num_experts_per_tok`` kept with their softmax weights renormalised to sum
to 1, the block's output the gated sum of their down products; each block
added to the residual; a final RMSNorm; no LM head. The last hidden states
are mean-pooled and L2-normalised.

Instructions: a text under an instruction reads
``"<|user|>\\n{instruction}\\n<|embed|>\\n" + text`` (``gritlm_instruction``;
``"<|embed|>\\n" + text`` without one), with no EOS appended, and the mean
leaves out its first ``len(tokenize(gritlm_instruction(instruction)))``
positions counted with BOS, as GritLM's ``encode`` sets
``instruction_lens``. In this route's tokenizer (words split at white
space) those are BOS, ``<|user|>``, the instruction's words and
``<|embed|>``.

Precision: every product has ``compute_dtype`` operands and a float32
result, the router's included (Mixtral computes its gate in the model's
type); the softmax, the gates, RMSNorm, RoPE, the residual stream and the
pooling are float32, and the gates multiply each expert's float32 down
product. Tokens at padded positions are left out of the mixture of
experts (exact: no padded row reaches a real one). On CUDA the experts' products take
bfloat16 operands only (``ops/moe.py``): ``compute_dtype`` float32 runs on
the CPU.

Selected by the embedding name ``GritLM/random`` (the published sizes) or
``GritLM/random-<key>=<value>,...`` (sizes by their Hugging Face names, and
``seed``): weights drawn on the device from the seed, and a hashing
tokenizer with Mixtral's 32,000 ids. A checkpoint name (``GritLM/GritLM-7B``,
``GritLM/GritLM-8x7B``) goes to ``gritlm_embed.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from ..ops import moe
from ..utils.timing import on_close
from . import nvembed_encoder as nv
from .encoder import _matmul
from .gritlm_embed import gritlm_instruction
from .nvembed_encoder import DecoderEmbeddingModel, DecoderEncoder, _leaf, _vector, _weight

ROUTE = "GritLM/random"
# GritLM/GritLM-8x7B's config.json (Mixtral-8x7B-v0.1's shape): no sliding window
PUBLISHED = {"hidden_size": 4096, "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
             "head_dim": 128, "intermediate_size": 14336, "num_local_experts": 8, "num_experts_per_tok": 2,
             "vocab_size": 32000, "rope_theta": 1e6, "rms_norm_eps": 1e-5}


def parse_name(name: str) -> tuple:
    """(sizes, seed) of an embedding name ``GritLM/random[-k=v,...]``."""
    return nv.parse_route(name, ROUTE, PUBLISHED)


def route_name(sizes: Dict, seed: int = 0) -> str:
    """The embedding name that builds ``sizes`` with weights from ``seed``."""
    return nv.format_route(ROUTE, PUBLISHED, sizes, seed)


def param_shapes(sizes: Dict) -> Dict:
    """Every leaf's shape: linear weights ``[in, out]``, applied as ``x @ W``;
    each expert's weights stacked over the experts."""
    d, f, e = sizes["hidden_size"], sizes["intermediate_size"], sizes["num_local_experts"]
    hd, h, kv = sizes["head_dim"], sizes["num_attention_heads"], sizes["num_key_value_heads"]
    layer = {"attn_norm": (d,), "q_w": (d, h * hd), "k_w": (d, kv * hd), "v_w": (d, kv * hd), "o_w": (h * hd, d),
             "mlp_norm": (d,), "router_w": (d, e), "gate_w": (e, d, f), "up_w": (e, d, f), "down_w": (e, f, d)}
    return {"embed": (sizes["vocab_size"], d), "layers": [dict(layer) for _ in range(sizes["num_hidden_layers"])],
            "norm": (d,)}


def params_random(sizes: Dict, seed: int = 0, device: Union[str, torch.device] = "cpu",
                  dtype: torch.dtype = torch.bfloat16) -> Dict:
    """GritLM's weights drawn from ``seed`` (``nvembed_encoder.draw_leaves``)."""
    return nv.draw_leaves(param_shapes(sizes), seed, device, dtype)


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def _moe(y: torch.Tensor, lengths: torch.Tensor, layer: "MoELayer", enc: "GritLMEncoder") -> torch.Tensor:
    """The mixture-of-experts block's output [B * L, D] (float32) from its
    normed operand ``y`` [B * L, D]: the router product, then ``ops/moe.py``
    with the decoder layer's SwiGLU between the two grouped products."""
    r = moe.moe_route(_matmul(y, layer.router_w), lengths, enc.top_k, enc.moe_stats)
    h = nv.swiglu(moe.moe_gate_up(y, layer.gate_w, layer.up_w, r), enc.dtype)
    return moe.moe_combine(moe.moe_down(h, layer.down_w, r), r)


def _forward(enc: "GritLMEncoder", ids: torch.Tensor, lengths: torch.Tensor, pool_from: torch.Tensor) -> torch.Tensor:
    """Right-padded ids [B, L], real lengths [B] and the first pooled
    position [B] -> unit rows [B, D] (float32)."""
    x = nv._decoder(enc, ids, lengths, lambda y, layer, e: _moe(y, lengths, layer, e))
    return nv._mean_pool(x, lengths, pool_from)


class MoELayer(nn.Module):
    """One decoder layer: the query, key and value weights side by side in
    one operand (a copy); the router's and the experts' weights as they are
    given, stacked over the experts (adopted without a copy where they
    already are operands on the device)."""

    def __init__(self, layer: Dict, dtype: torch.dtype, device):
        super().__init__()
        self.register_buffer("attn_norm", _vector(layer["attn_norm"], device))
        self.register_buffer("mlp_norm", _vector(layer["mlp_norm"], device))
        self.register_buffer("qkv_w", torch.cat([_weight(layer[k], dtype, device) for k in ("q_w", "k_w", "v_w")], 1))
        for name in ("o_w", "router_w", "gate_w", "up_w", "down_w"):
            self.register_buffer(name, _weight(layer[name], dtype, device))


class GritLMEncoder(DecoderEncoder):
    """GritLM's weights on one device in the form the forward uses.

    ``params`` has the leaves of :func:`param_shapes` (numpy or torch, any
    float type). Linear weights become product operands, the embedding
    keeps its type (its rows are read in float32), norms are float32.
    ``moe_stats`` (int64 [2], on the device) adds up the (token, expert)
    pairs routed and each layer's largest expert's rows over every forward
    but the eager one that precedes a capture.
    """

    LAUNCH_COUNTERS = {**DecoderEncoder.LAUNCH_COUNTERS, "moe_kernels": moe.moe_kernel_launches}

    def __init__(self, params: Dict, sizes: Dict, compute_dtype: str = "bfloat16",
                 device: Union[str, torch.device] = "cuda"):
        device = torch.device(device)
        super().__init__(sizes, compute_dtype, device)
        self.top_k = int(sizes["num_experts_per_tok"])
        if not 1 <= self.top_k <= int(sizes["num_local_experts"]):
            raise ValueError(f"top {self.top_k} of {sizes['num_local_experts']} experts")
        shapes = param_shapes(sizes)
        given = [(k, params[k]) for k in ("embed", "norm")]
        given += [(f"layers.{i}.{k}", p[k]) for i, p in enumerate(params["layers"]) for k in p]
        want = [(k, shapes[k]) for k in ("embed", "norm")]
        want += [(f"layers.{i}.{k}", s) for i, layer in enumerate(shapes["layers"]) for k, s in layer.items()]
        if len(params["layers"]) != len(shapes["layers"]):
            raise ValueError(f"{len(params['layers'])} layers; the sizes give {len(shapes['layers'])}")
        for (key, leaf), (_key, shape) in zip(given, want):
            if tuple(leaf.shape) != tuple(shape):
                raise ValueError(f"{key}: shape {tuple(leaf.shape)}, the sizes give {shape}")
        self.register_buffer("embed", _leaf(params["embed"], device))
        self.layers = nn.ModuleList(MoELayer(p, self.dtype, device) for p in params["layers"])
        self.register_buffer("norm", _vector(params["norm"], device))
        self.register_buffer("moe_stats", torch.zeros(2, dtype=torch.int64, device=device))

    def run(self, ids: torch.Tensor, lengths: torch.Tensor, pool_from: torch.Tensor) -> torch.Tensor:
        return _forward(self, ids, lengths, pool_from)

    def _capture(self, *inputs) -> tuple:
        """:meth:`DecoderEncoder._capture`, with ``moe_stats`` as it was
        before its eager forward."""
        saved = self.moe_stats.clone()
        captured = super()._capture(*inputs)
        self.moe_stats.copy_(saved)
        return captured


class GritLMDeviceEmbeddingModel(DecoderEmbeddingModel):
    """``GritLM/random[-k=v,...]`` on a torch device
    (``nvembed_encoder.DecoderEmbeddingModel``; no EOS). Besides its
    counters, a span open over its forwards gets ``moe_kernels`` (the
    mixture-of-experts kernels' launches the forwards replayed; 0 on the
    CPU), and, read once from the device when the span closes, ``routed``
    (the (token, expert) pairs computed, summed over layers) and
    ``expert_rows_max`` (the largest expert's rows, summed over layers and
    forwards)."""

    ENCODER = GritLMEncoder
    EOS = False

    def __init__(self, global_config=None, device: Union[str, torch.device] = "cuda", params: Optional[Dict] = None):
        super().__init__(global_config, device, params, parse_name, params_random)

    def format_with_instruction(self, text: str, instruction: str) -> str:
        return gritlm_instruction(instruction) + text

    def _masked_positions(self, instruction: str) -> int:
        """BOS and the tokens of the instruction's template (the module's docstring)."""
        return 1 + len(self.tokenizer.tokenize(gritlm_instruction(instruction)))

    def _routing_counts(self):
        stats = self.encoder.moe_stats
        before = stats.clone()

        def read() -> Dict[str, int]:
            routed, rows_max = (stats - before).tolist()
            return {"routed": routed, "expert_rows_max": rows_max}

        return read

    def _encode_batch(self, texts: List[str]):
        on_close("moe_stats", self._routing_counts)
        return super()._encode_batch(texts)
