"""Trainable embedding adapter (port of ``hipporag_tpu/models/adapter.py``).

A residual MLP over frozen embeddings, trained contrastively (symmetric
in-batch InfoNCE) on (query, positive passage/fact) pairs, so linking can
be tuned per corpus without re-embedding. Parameters are a NamedTuple of
leaf tensors; the products are ``torch.matmul`` in float32, pinned to full
float32 by ``utils/precision.full_f32`` in the train steps.

``make_sharded_train_step`` is the multi-device step on a ("dp",
"corpus") mesh: the batch split over dp, the hidden dimension over the
corpus axis (megatron-style column/row parallel linear pair, whose partial
products are summed across the corpus shards).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import CORPUS_AXIS, DP_AXIS, Mesh, Sharding
from ..utils.precision import full_f32


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
        with full_f32():
            optimizer.zero_grad(set_to_none=True)
            loss = info_nce_loss(params, queries, positives, temperature)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return train_step


def adapter_shardings(mesh: Mesh):
    """(param shardings, batch sharding) for the ("dp", "corpus") mesh:
    ``w_in`` column-parallel and ``b_in`` split along H over the corpus
    axis, ``w_out`` row-parallel, the batch split over dp."""
    param_sharding = AdapterParams(
        w_in=Sharding(mesh, (None, CORPUS_AXIS)),
        b_in=Sharding(mesh, (CORPUS_AXIS,)),
        w_out=Sharding(mesh, (CORPUS_AXIS, None)),
    )
    return param_sharding, Sharding(mesh, (DP_AXIS, None))


def make_sharded_train_step(mesh: Mesh, optimizer, temperature: float = 0.05):
    """dp+tp train step: batch split over dp, hidden dimension over corpus.

    ``optimizer`` builds the optimizer over a list of tensors (e.g.
    ``lambda ps: adamw(ps, 1e-2)``). Returns ``(train_step, place)``:

    - ``place(params, queries, positives) -> (sharded, queries, positives)``
      lays out an ``AdapterParams`` as fields of per-shard leaf tensors
      (shard c of every parameter on mesh device (0, c), so the optimizer
      state, created with the parameters it updates, lives there too) and
      the pairs as per-group blocks, and builds the optimizer over the shards;
    - ``train_step(sharded, queries, positives) -> loss`` updates the shards
      in place and returns the loss before the update, on device (0, 0).

    Each dp group g computes its rows on devices (g, c): the hidden shards
    through the column-parallel ``w_in`` and the row-parallel ``w_out``,
    whose partial products are summed in shard order on (g, 0). InfoNCE
    needs the whole batch's negatives, so the groups' outputs are gathered
    on (0, 0) before the loss, as the JAX package's global batch is. The
    parameters reach the other groups' devices through differentiable
    copies, so autograd sums the groups' gradients into the shards: the dp
    gradient all-reduce, with none written by hand.
    """
    param_sh, batch_sh = adapter_shardings(mesh)
    state = {}

    def place(params: AdapterParams, queries, positives):
        sharded = AdapterParams(*(
            [t.detach().clone().requires_grad_() for t in sh.place(p.detach())[0]]
            for sh, p in zip(param_sh, params)
        ))
        state["optimizer"] = optimizer([t for field in sharded for t in field])
        q, pos = batch_sh.place(queries), batch_sh.place(positives)
        return sharded, [row[0] for row in q], [row[0] for row in pos]

    def forward(sharded: AdapterParams, queries, positives):
        home = mesh.devices[0, 0]
        outs = []
        for g, x in enumerate(queries):
            partial = None
            for c in range(mesh.corpus):
                dev = mesh.devices[g, c]
                h = F.gelu(x.to(dev) @ sharded.w_in[c].to(dev) + sharded.b_in[c].to(dev), approximate="tanh")
                part = (h @ sharded.w_out[c].to(dev)).to(x.device)
                partial = part if partial is None else partial + part
            out = x + partial
            out = out / torch.clamp_min(torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-12)
            outs.append(out.to(home))
        q = torch.cat(outs)
        pos = torch.cat([p.to(home) for p in positives])
        logits = (q @ pos.T) / temperature
        labels = torch.arange(q.shape[0], device=home)
        return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))

    def train_step(sharded: AdapterParams, queries, positives):
        opt = state["optimizer"]
        with full_f32():
            opt.zero_grad(set_to_none=True)
            loss = forward(sharded, queries, positives)
            loss.backward()
            opt.step()
        return loss.detach()

    return train_step, place
