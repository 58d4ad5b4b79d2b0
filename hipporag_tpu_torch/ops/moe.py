"""A sparse mixture-of-experts block, Mixtral's (arXiv:2401.04088), with its
routing on the device.

A token's router logits [E] (the product of the block's normed operand with
the router's weights, computed by the caller) choose its ``top_k`` experts:
the largest logits, the lower expert index first on a tie. Its gates are
the softmax renormalised over the chosen, ``exp(l_j - l_1) / sum_i exp(l_i -
l_1)`` with ``l_1`` its largest logit: Mixtral's float32 softmax over all
experts, cut to the top ``top_k`` and divided by their sum, whose full
denominator cancels. Expert ``e`` computes ``down_e(silu(gate_e(y)) *
up_e(y))``; the block's output for a token is the sum of its experts'
float32 down products, each times its gate, in the order they were chosen.

Four ops, each a hand-written Triton kernel on CUDA and its plain torch
version (``<op>_plain``, beside it) on the CPU, which is also the kernel's
oracle; a CUDA operand a kernel does not take raises:

- :func:`moe_route`: the top-k, the gates, the per-expert row counts and
  offsets, and each (token, expert) pair's row in an order grouped by
  expert, ascending by token within an expert. Tokens at padded positions
  are not routed: under a mask at padding only no padded row reaches a real
  one, so leaving them out is exact;
- :func:`moe_gate_up`: the grouped product of each pair's token row with its
  expert's gate and up weights, into the pair's row (the SwiGLU that
  follows is the decoder layer's ``swiglu``, ``embedding/nvembed_encoder.py``);
- :func:`moe_down`: the grouped down product;
- :func:`moe_combine`: each token's gated rows summed, in the order they
  were chosen and without atomics, into the residual's delta.

Every shape is fixed by the number of tokens, none by the routing: the
grouped products' grids are sized for the worst case (a program for every
expert and column tile; each reads its expert's rows from the device
offsets and loops over them), so the block is captured in a CUDA graph with
no host sync. The routing adds its pairs and its largest expert's rows to a
device counter (``stats``), which the caller reads when it wants them.

What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s in bf16): at a forward of
16 texts of about 22 tokens (352 tokens, 704 pairs), each expert sees about
88 rows, 88 operations per weight byte, under the 295 at which the tensor
cores rather than the memory bound a product: the grouped products stream
every expert's weights once a layer (2.8 GB of GritLM-8x7B's 4096 x 14,336
experts, 0.84 ms), one program per expert and column tile, its expert's
rows in one tile of up to ``BLOCK_M`` rows, so that each weight byte is
read once. The routing and the combine move kilobytes and tens of
megabytes. No TPU kernel is replaced: the JAX package has no mixture of
experts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..embedding.encoder import _matmul
from ._kernels import LaunchCounter

OPS = ("moe_route", "moe_gate_up", "moe_down", "moe_combine")
LAUNCHES = {name: LaunchCounter() for name in OPS}
ROUTE_BLOCK_T = 128  # tokens a step of the routing program reads
# the grouped products' tiles: a stage of A and B is 32 KB, four in flight
PRODUCT_BLOCK = dict(BLOCK_N=128, BLOCK_K=64, num_warps=8, num_stages=4)
COMBINE_BLOCK_D = 1024


def moe_kernel_launches() -> int:
    """Launches of the four kernels so far, in this process."""
    return sum(c.count for c in LAUNCHES.values())


class Routing(NamedTuple):
    """Where a block's (token, expert) pairs go; T tokens, k experts each."""

    gates: torch.Tensor  # [T, k] float32; 0 at a token not routed
    experts: torch.Tensor  # [T, k] int32, in the order chosen; -1 at a token not routed
    slots: torch.Tensor  # [T, k] int32: the pair's row in the grouped order; -1 at a token not routed
    tokens: torch.Tensor  # [T * k] int32: each grouped row's token (rows from offsets[E] on: unset)
    offsets: torch.Tensor  # [E + 1] int32: expert e's rows are offsets[e] <= row < offsets[e + 1]


# ----------------------------------------------------------------------
# Kernels
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _kernels():
    """The Triton kernels, built at first use on the card (this module is
    imported where there is no Triton)."""
    import triton
    import triton.language as tl

    @triton.jit
    def _choose(vals, ecol, E_PAD: tl.constexpr):
        """Each row's largest value, its lowest column, that column as a
        mask, and the rows with it taken out."""
        top = tl.max(vals, axis=1)
        idx = tl.min(tl.where(vals == top[:, None], ecol, E_PAD), axis=1)
        hit = ecol == idx[:, None]
        return top, idx, hit, tl.where(hit, float("-inf"), vals)

    @triton.jit
    def _block_logits(logits, lengths, t0, n_tokens, seq_len, n_exp, ecol, BLOCK_T: tl.constexpr):
        rows = t0 + tl.arange(0, BLOCK_T)
        inside = rows < n_tokens
        text = rows // seq_len
        real = inside & ((rows - text * seq_len) < tl.load(lengths + text, mask=inside, other=0))
        vals = tl.load(logits + rows[:, None] * n_exp + ecol, mask=inside[:, None] & (ecol < n_exp),
                       other=float("-inf"))
        return rows, inside, real, vals

    @triton.jit
    def moe_route_kernel(logits, lengths, gates, experts, slots, tokens, offsets, stats, n_tokens, seq_len, n_exp,
                         TOP_K: tl.constexpr, E_PAD: tl.constexpr, BLOCK_T: tl.constexpr, STATS: tl.constexpr):
        # one program: a first pass counts each expert's pairs, a second
        # writes each pair's gate, expert and row, its block's pairs placed
        # after the earlier blocks' on each expert
        col = tl.arange(0, E_PAD)
        ecol = col[None, :]
        counts = tl.zeros([E_PAD], dtype=tl.int32)
        for t0 in range(0, n_tokens, BLOCK_T):
            rows, inside, real, left = _block_logits(logits, lengths, t0, n_tokens, seq_len, n_exp, ecol, BLOCK_T)
            for _j in tl.static_range(TOP_K):
                _top, _idx, hit, left = _choose(left, ecol, E_PAD)
                counts += tl.sum((hit & real[:, None]).to(tl.int32), axis=0)
        total = tl.sum(counts, axis=0)
        base = tl.cumsum(counts, axis=0) - counts
        tl.store(offsets + col, base, mask=col < n_exp)
        tl.store(offsets + n_exp, total)
        if STATS:
            tl.store(stats, tl.load(stats) + total.to(tl.int64))
            tl.store(stats + 1, tl.load(stats + 1) + tl.max(counts, axis=0).to(tl.int64))
        for t0 in range(0, n_tokens, BLOCK_T):
            rows, inside, real, vals = _block_logits(logits, lengths, t0, n_tokens, seq_len, n_exp, ecol, BLOCK_T)
            first = tl.max(vals, axis=1)
            member = tl.zeros([BLOCK_T, E_PAD], dtype=tl.int32)
            denom = tl.zeros([BLOCK_T], dtype=tl.float32)
            left = vals
            for _j in tl.static_range(TOP_K):
                top, _idx, hit, left = _choose(left, ecol, E_PAD)
                member += hit.to(tl.int32)
                denom += tl.exp(top - first)
            member = tl.where(real[:, None], member, 0)
            rank = base[None, :] + tl.cumsum(member, axis=0) - member  # earlier pairs on each expert
            left = vals
            for j in tl.static_range(TOP_K):
                top, idx, hit, left = _choose(left, ecol, E_PAD)
                slot = tl.sum(tl.where(hit, rank, 0), axis=1)
                pair = rows * TOP_K + j
                tl.store(gates + pair, tl.where(real, tl.exp(top - first) / denom, 0.0), mask=inside)
                tl.store(experts + pair, tl.where(real, idx, -1), mask=inside)
                tl.store(slots + pair, tl.where(real, slot, -1), mask=inside)
                tl.store(tokens + slot, rows, mask=real)
            base += tl.sum(member, axis=0)

    @triton.jit
    def _expert_rows(a, tokens, w, out, start, end, k_dim, w_cols, out_cols, cols, out_at, GATHER: tl.constexpr,
                     BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr, BLOCK_K: tl.constexpr, EVEN_K: tl.constexpr,
                     EVEN_N: tl.constexpr):
        """out[r, out_at + cols] = a[row r's token, or row r] @ w[:, cols]
        (float32) for the rows start <= r < end, BLOCK_M at a time."""
        rk = tl.arange(0, BLOCK_K)
        cmask = cols < w_cols
        for m0 in range(start, end, BLOCK_M):
            rm = m0 + tl.arange(0, BLOCK_M)
            mmask = rm < end
            if GATHER:
                arow = tl.load(tokens + rm, mask=mmask, other=0)
            else:
                arow = rm
            a_ptr = a + arow.to(tl.int64)[:, None] * k_dim + rk[None, :]
            w_ptr = w + rk[:, None] * w_cols + cols[None, :]
            acc = tl.zeros([BLOCK_M, BLOCK_N], dtype=tl.float32)
            for k0 in range(0, k_dim, BLOCK_K):
                if EVEN_K:
                    x = tl.load(a_ptr, mask=mmask[:, None], other=0.0)
                    if EVEN_N:
                        y = tl.load(w_ptr)
                    else:
                        y = tl.load(w_ptr, mask=cmask[None, :], other=0.0)
                else:
                    kmask = (k0 + rk) < k_dim
                    x = tl.load(a_ptr, mask=mmask[:, None] & kmask[None, :], other=0.0)
                    y = tl.load(w_ptr, mask=kmask[:, None] & cmask[None, :], other=0.0)
                acc = tl.dot(x, y, acc)
                a_ptr += BLOCK_K
                w_ptr += BLOCK_K * w_cols
            o = out + rm.to(tl.int64)[:, None] * out_cols + out_at + cols[None, :]
            tl.store(o, acc, mask=mmask[:, None] & cmask[None, :])

    @triton.jit
    def moe_gate_up_kernel(y, tokens, offsets, gate, up, out, d, f, BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                           BLOCK_K: tl.constexpr, EVEN_K: tl.constexpr, EVEN_N: tl.constexpr):
        # program (column tile of [gate | up], expert)
        tiles = tl.cdiv(f, BLOCK_N)
        pid, e = tl.program_id(0), tl.program_id(1)
        half = pid // tiles
        cols = (pid - half * tiles) * BLOCK_N + tl.arange(0, BLOCK_N)
        at = e.to(tl.int64) * d * f
        if half == 0:
            w = gate + at
        else:
            w = up + at
        _expert_rows(y, tokens, w, out, tl.load(offsets + e), tl.load(offsets + e + 1), d, f, 2 * f, cols, half * f,
                     True, BLOCK_M, BLOCK_N, BLOCK_K, EVEN_K, EVEN_N)

    @triton.jit
    def moe_down_kernel(h, offsets, down, out, f, d, BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                        BLOCK_K: tl.constexpr, EVEN_K: tl.constexpr, EVEN_N: tl.constexpr):
        # program (column tile, expert)
        e = tl.program_id(1)
        cols = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        _expert_rows(h, h, down + e.to(tl.int64) * f * d, out, tl.load(offsets + e), tl.load(offsets + e + 1), f, d,
                     d, cols, 0, False, BLOCK_M, BLOCK_N, BLOCK_K, EVEN_K, EVEN_N)

    @triton.jit
    def moe_combine_kernel(rows, gates, slots, out, d, TOP_K: tl.constexpr, BLOCK_D: tl.constexpr):
        # program (token, column block)
        t = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
        cmask = cols < d
        acc = tl.zeros([BLOCK_D], dtype=tl.float32)
        for j in tl.static_range(TOP_K):
            slot = tl.load(slots + t * TOP_K + j)
            x = tl.load(rows + slot.to(tl.int64) * d + cols, mask=cmask & (slot >= 0), other=0.0)
            acc += tl.load(gates + t * TOP_K + j) * x
        tl.store(out + t.to(tl.int64) * d + cols, acc, mask=cmask)

    return {"route": moe_route_kernel, "gate_up": moe_gate_up_kernel, "down": moe_down_kernel,
            "combine": moe_combine_kernel, "cdiv": triton.cdiv, "next_power_of_2": triton.next_power_of_2}


def _check(name: str, *tensors, f32=(), ints=()) -> None:
    """Raise unless every tensor is contiguous on one CUDA device: those of
    ``tensors`` in bfloat16 (the products' operands), ``f32`` in float32,
    ``ints`` int32 or int64."""
    device = (*tensors, *f32)[0].device
    if device.type != "cuda" or any(t.device != device for t in (*tensors, *f32, *ints)):
        raise ValueError(f"{name}: every operand must be on one CUDA device (or all on the CPU)")
    wants = [(t, (torch.bfloat16,)) for t in tensors] + [(t, (torch.float32,)) for t in f32]
    wants += [(t, (torch.int32, torch.int64)) for t in ints]
    for t, want in wants:
        if t.dtype not in want or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous {want} operands; got {t.dtype}, shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")


def _rows_block(pairs: int, n_exp: int) -> int:
    """Rows of an expert's tile: a power of two from 16 up to 128 that
    holds a quarter more than an even share of the pairs, so that an
    expert's rows take one tile at the forwards the encoder runs."""
    return int(min(128, max(16, _kernels()["next_power_of_2"](-(-5 * pairs // (4 * n_exp))))))


# ----------------------------------------------------------------------
# Routing
# ----------------------------------------------------------------------
def _real_tokens(lengths: torch.Tensor, tokens: int) -> torch.Tensor:
    """[T, 1]: token ``b * L + p`` is real when ``p < lengths[b]``."""
    seq = tokens // lengths.shape[0]
    return (torch.arange(seq, device=lengths.device)[None, :] < lengths[:, None]).reshape(tokens, 1)


def moe_route_plain(logits: torch.Tensor, lengths: torch.Tensor, top_k: int,
                    stats: Optional[torch.Tensor] = None) -> Routing:
    t, n_exp = logits.shape
    dev = logits.device
    real = _real_tokens(lengths, t)
    order = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :top_k]  # ties: lower index first
    chosen = logits.gather(1, order)
    weights = torch.exp(chosen - chosen[:, :1])
    gates = torch.where(real, weights / weights.sum(1, keepdim=True), 0.0)
    pair = torch.arange(t * top_k, device=dev).view(t, top_k)
    grouped = torch.argsort(torch.where(real, order, n_exp).mul(t * top_k).add(pair).reshape(-1))  # row -> pair
    slots = torch.empty(t * top_k, dtype=torch.int64, device=dev)
    slots[grouped] = torch.arange(t * top_k, device=dev)
    counts = F.one_hot(order, n_exp).mul(real[..., None]).sum((0, 1))
    if stats is not None:
        stats += torch.stack([counts.sum(), counts.max()])
    return Routing(gates, torch.where(real, order, -1).int(), torch.where(real, slots.view(t, top_k), -1).int(),
                   (grouped // top_k).int(), F.pad(counts.cumsum(0), (1, 0)).int())


def moe_route(logits: torch.Tensor, lengths: torch.Tensor, top_k: int,
              stats: Optional[torch.Tensor] = None) -> Routing:
    """Router logits [T, E] (float32; token ``b * L + p`` of texts of
    ``lengths`` [B]) -> the :class:`Routing` of their pairs. With ``stats``
    (int64 [2], on the logits' device), adds the pairs routed and the
    largest expert's rows to it."""
    if logits.device.type == "cpu":
        return moe_route_plain(logits, lengths, top_k, stats)
    t, n_exp = logits.shape
    _check("moe_route", f32=(logits,), ints=(lengths, *([] if stats is None else [stats])))
    if logits.dim() != 2 or lengths.dim() != 1 or t % max(1, lengths.shape[0]) or not 1 <= top_k <= n_exp:
        raise ValueError(f"moe_route: logits {tuple(logits.shape)}, lengths {tuple(lengths.shape)}, top {top_k}; "
                         "want [B * L, E], [B] and 1 <= top_k <= E")
    if stats is not None and (stats.dtype != torch.int64 or stats.numel() != 2):
        raise ValueError(f"moe_route: stats {stats.dtype} {tuple(stats.shape)}; want int64 [2]")
    k = _kernels()
    dev = logits.device
    gates = torch.empty(t, top_k, dtype=torch.float32, device=dev)
    experts = torch.empty(t, top_k, dtype=torch.int32, device=dev)
    slots = torch.empty(t, top_k, dtype=torch.int32, device=dev)
    tokens = torch.empty(t * top_k, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_exp + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        k["route"][(1,)](logits, lengths, gates, experts, slots, tokens, offsets,
                         offsets if stats is None else stats, t, t // lengths.shape[0], n_exp, TOP_K=top_k,
                         E_PAD=k["next_power_of_2"](n_exp), BLOCK_T=ROUTE_BLOCK_T, STATS=stats is not None,
                         num_warps=4)
    LAUNCHES["moe_route"].add()
    return Routing(gates, experts, slots, tokens, offsets)


# ----------------------------------------------------------------------
# Grouped products and combine
# ----------------------------------------------------------------------
def _expert_spans(r: Routing) -> list:
    offsets = r.offsets.tolist()
    return [slice(offsets[e], offsets[e + 1]) for e in range(len(offsets) - 1)]


def moe_gate_up_plain(y: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor, r: Routing) -> torch.Tensor:
    f = gate_w.shape[2]
    out = torch.zeros(r.tokens.shape[0], 2 * f, dtype=torch.float32, device=y.device)
    for e, rows in enumerate(_expert_spans(r)):
        x = y[r.tokens[rows].long()]
        out[rows, :f] = _matmul(x, gate_w[e])
        out[rows, f:] = _matmul(x, up_w[e])
    return out


def moe_gate_up(y: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor, r: Routing) -> torch.Tensor:
    """[T * k, 2F] float32: grouped row ``p`` of expert ``e`` is ``y[tokens[p]]
    @ [gate_w[e] | up_w[e]]``; ``y`` [T, D] and the weights [E, D, F] are
    product operands (bfloat16 on CUDA: the kernel takes no other). Rows from ``offsets[E]`` on are
    left unset (0 in the plain version)."""
    if y.device.type == "cpu":
        return moe_gate_up_plain(y, gate_w, up_w, r)
    n_exp, d, f = gate_w.shape
    _check("moe_gate_up", y, gate_w, up_w, ints=(r.tokens, r.offsets))
    if y.dim() != 2 or y.shape[1] != d or up_w.shape != gate_w.shape or r.offsets.numel() != n_exp + 1:
        raise ValueError(f"moe_gate_up: y {tuple(y.shape)}, gate {tuple(gate_w.shape)}, up {tuple(up_w.shape)}, "
                         f"{r.offsets.numel() - 1} experts routed; want [T, D], [E, D, F] twice")
    k = _kernels()
    pairs = r.tokens.shape[0]
    out = torch.empty(pairs, 2 * f, dtype=torch.float32, device=y.device)
    blocks = PRODUCT_BLOCK
    grid = (2 * k["cdiv"](f, blocks["BLOCK_N"]), n_exp)
    with torch.cuda.device(y.device):
        k["gate_up"][grid](y, r.tokens, r.offsets, gate_w, up_w, out, d, f, BLOCK_M=_rows_block(pairs, n_exp),
                           EVEN_K=d % blocks["BLOCK_K"] == 0,
                           EVEN_N=f % blocks["BLOCK_N"] == 0, **blocks)
    LAUNCHES["moe_gate_up"].add()
    return out


def moe_down_plain(h: torch.Tensor, down_w: torch.Tensor, r: Routing) -> torch.Tensor:
    out = torch.zeros(h.shape[0], down_w.shape[2], dtype=torch.float32, device=h.device)
    for e, rows in enumerate(_expert_spans(r)):
        out[rows] = _matmul(h[rows], down_w[e])
    return out


def moe_down(h: torch.Tensor, down_w: torch.Tensor, r: Routing) -> torch.Tensor:
    """[T * k, D] float32: grouped row ``p`` of expert ``e`` is ``h[p] @
    down_w[e]``; ``h`` [T * k, F] and ``down_w`` [E, F, D] are product
    operands. Rows from ``offsets[E]`` on are left unset (0 in the plain
    version)."""
    if h.device.type == "cpu":
        return moe_down_plain(h, down_w, r)
    n_exp, f, d = down_w.shape
    _check("moe_down", h, down_w, ints=(r.offsets,))
    if h.dim() != 2 or h.shape[1] != f or r.offsets.numel() != n_exp + 1:
        raise ValueError(f"moe_down: h {tuple(h.shape)}, down {tuple(down_w.shape)}, {r.offsets.numel() - 1} "
                         "experts routed; want [T * k, F] and [E, F, D]")
    k = _kernels()
    out = torch.empty(h.shape[0], d, dtype=torch.float32, device=h.device)
    blocks = PRODUCT_BLOCK
    grid = (k["cdiv"](d, blocks["BLOCK_N"]), n_exp)
    with torch.cuda.device(h.device):
        k["down"][grid](h, r.offsets, down_w, out, f, d, BLOCK_M=_rows_block(h.shape[0], n_exp),
                        EVEN_K=f % blocks["BLOCK_K"] == 0,
                        EVEN_N=d % blocks["BLOCK_N"] == 0, **blocks)
    LAUNCHES["moe_down"].add()
    return out


def moe_combine_plain(rows: torch.Tensor, r: Routing) -> torch.Tensor:
    picked = rows[r.slots.clamp_min(0).long()]  # [T, k, D]
    picked = torch.where((r.slots >= 0)[..., None], picked, 0.0)
    out = torch.zeros(picked.shape[0], picked.shape[2], dtype=torch.float32, device=rows.device)
    for j in range(picked.shape[1]):
        out += r.gates[:, j, None] * picked[:, j]
    return out


def moe_combine(rows: torch.Tensor, r: Routing) -> torch.Tensor:
    """The grouped down rows [T * k, D] (float32) -> each token's ``sum_j
    gates[t, j] * rows[slots[t, j]]`` [T, D] (float32), ``j`` in the order
    chosen; 0 at a token not routed."""
    if rows.device.type == "cpu":
        return moe_combine_plain(rows, r)
    t, top_k = r.slots.shape
    _check("moe_combine", f32=(rows, r.gates), ints=(r.slots,))
    if rows.dim() != 2 or rows.shape[0] != t * top_k or r.gates.shape != r.slots.shape:
        raise ValueError(f"moe_combine: rows {tuple(rows.shape)}, slots {tuple(r.slots.shape)}, gates "
                         f"{tuple(r.gates.shape)}; want [T * k, D], [T, k] and [T, k]")
    k = _kernels()
    d = rows.shape[1]
    out = torch.empty(t, d, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        k["combine"][(t, k["cdiv"](d, COMBINE_BLOCK_D))](rows, r.gates, r.slots, out, d, TOP_K=top_k,
                                                         BLOCK_D=COMBINE_BLOCK_D, num_warps=4)
    LAUNCHES["moe_combine"].add()
    return out

