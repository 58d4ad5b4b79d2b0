"""Collectives over per-shard tensor lists (single-controller).

``xs[s]`` is shard ``s``'s tensor on its own device; each collective
returns one tensor per shard, on that shard's device, with the semantics
of the ``jax.lax`` collective of the same name over one mesh axis. Copies
between devices are ``.to(device, non_blocking=True)``: torch orders a copy
between two GPUs against both devices' current streams, and a copy to the
device a tensor is already on is no copy at all, so virtual shards of one
device exchange nothing. A result that several shards on one device share
is computed once on that device.

Reductions sum (or take the extremum) in shard order on shard 0's device,
so every shard receives the same bits.
"""

from __future__ import annotations

import torch


def _to(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def _broadcast(x: torch.Tensor, like) -> list:
    """``x`` on the device of every tensor in ``like``, once per device."""
    out, copies = [], {}
    for t in like:
        if t.device not in copies:
            copies[t.device] = _to(x, t.device)
        out.append(copies[t.device])
    return out


def _reduce(xs, op) -> list:
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, _to(x, acc.device))
    return _broadcast(acc, xs)


def psum(xs) -> list:
    """Sum over shards, in shard order."""
    return _reduce(xs, torch.add)


def pmax(xs) -> list:
    return _reduce(xs, torch.maximum)


def pmin(xs) -> list:
    return _reduce(xs, torch.minimum)


def all_gather(xs, axis: int = 0) -> list:
    """Every shard's tensor on every shard, concatenated along ``axis`` in
    shard order (``lax.all_gather(..., tiled=True)``)."""
    out, done = [], {}
    for t in xs:
        if t.device not in done:
            done[t.device] = torch.cat([_to(x, t.device) for x in xs], dim=axis)
        out.append(done[t.device])
    return out


def all_to_all(xs, split_axis: int = 0, concat_axis: int = 0) -> list:
    """Shard ``t`` splits its tensor into C blocks along ``split_axis`` and
    sends block ``s`` to shard ``s``; shard ``s`` concatenates what it
    receives along ``concat_axis`` in sender order
    (``lax.all_to_all(..., tiled=True)``). So receiver ``s``'s block ``t``
    is sender ``t``'s block ``s``."""
    blocks = [x.chunk(len(xs), dim=split_axis) for x in xs]
    return [
        torch.cat([_to(blocks[t][s], xs[s].device) for t in range(len(xs))], dim=concat_axis)
        for s in range(len(xs))
    ]
