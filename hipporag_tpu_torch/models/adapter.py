"""Trainable embedding adapter (port of ``hipporag_tpu/models/adapter.py``).

A residual MLP over frozen embeddings, trained contrastively (symmetric
in-batch InfoNCE) on (query, positive passage/fact) pairs, so linking can
be tuned per corpus without re-embedding. Parameters are a NamedTuple of
leaf tensors; the products are ``torch.matmul`` in float32 (TF32 stays
off, as everywhere in the port).

The multi-device train step of the JAX package (batch over data
parallelism, the hidden dimension split over devices) is not ported here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class AdapterParams(NamedTuple):
    w_in: torch.Tensor  # [D, H]
    b_in: torch.Tensor  # [H]
    w_out: torch.Tensor  # [H, D]


def init_adapter(dim: int, hidden: int, generator: torch.Generator | None = None,
                 scale: float = 0.02, device="cuda") -> AdapterParams:
    """Normal(0, scale) weights and a zero bias, drawn on the host from
    ``generator`` (so a seed gives the same weights on any device), as leaf
    tensors that require grad."""
    w_in = torch.randn(dim, hidden, generator=generator) * scale
    w_out = torch.randn(hidden, dim, generator=generator) * scale
    return AdapterParams(
        w_in=w_in.to(device).requires_grad_(),
        b_in=torch.zeros(hidden, device=device, requires_grad=True),
        w_out=w_out.to(device).requires_grad_(),
    )


def adapter_apply(params: AdapterParams, x: torch.Tensor) -> torch.Tensor:
    """Residual MLP: x + gelu(x @ w_in + b) @ w_out, L2-renormalized.

    The GELU is the tanh approximation, which ``jax.nn.gelu`` computes by
    default; the norm is clamped at 1e-12.
    """
    h = F.gelu(x @ params.w_in + params.b_in, approximate="tanh")
    out = x + h @ params.w_out
    return out / torch.clamp_min(torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-12)


def info_nce_loss(params: AdapterParams, queries: torch.Tensor, positives: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric in-batch InfoNCE between adapted queries and positives:
    the mean of the cross-entropies over ``logits`` and ``logits.T``."""
    q = adapter_apply(params, queries)
    logits = (q @ positives.T) / temperature
    labels = torch.arange(q.shape[0], device=q.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def adamw(params: AdapterParams, learning_rate: float) -> torch.optim.AdamW:
    """AdamW with ``optax.adamw``'s defaults (betas 0.9/0.999, eps 1e-8,
    weight decay 1e-4 on every parameter). Both decay the parameter by
    lr x wd x the parameter before the step and take the bias-corrected
    m / (sqrt(v) + eps), so the two follow each other step for step, to
    float32 rounding."""
    return torch.optim.AdamW(list(params), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def make_train_step(optimizer: torch.optim.Optimizer, temperature: float = 0.05):
    """A step ``train_step(params, queries, positives) -> loss`` that
    updates ``params`` in place through ``optimizer`` (built over the same
    tensors, e.g. by ``adamw``) and returns the loss before the update."""

    def train_step(params: AdapterParams, queries: torch.Tensor, positives: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        loss = info_nce_loss(params, queries, positives, temperature)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
