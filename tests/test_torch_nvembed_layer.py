"""The five ops between an NV-Embed-v2 decoder layer's products
(``embedding/nvembed_encoder.py``: ``add_rms_norm``, ``rope_qkv``,
``masked_softmax``, ``ungroup_operand``, ``swiglu``).

On the CPU each op runs its plain version, which must equal, element for
element, the torch composition the forward ran before the ops existed (or an
index-by-index derivation where the op's point is a layout). Tests marked
``chip`` hold the kernels of ``csrc/nvembed_layer.cu`` to the plain versions
on a CUDA card at the benchmark's widths and skip without one; this file
imports no JAX, so on the GPU machine they run without the suite's
conftest: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_nvembed_layer.py -m chip``.

Card tolerances (``chip_smoke.py`` phase 11 holds the kernels to the same):
float32 outputs to 1e-6 relative; bfloat16 outputs at most one bfloat16 step
apart, on at most 1e-5 of the elements (the kernels round as the torch ops
do; add_rms_norm sums its squares in another order, and may differ only
where the exact value is a rounding tie); the replayed
forward's unit rows within ``chip_smoke.NV_FORWARD_L2`` (0.04) in L2 of the
eager forward through the plain versions (a few steps of rounding, carried
through 32 random layers: see the test).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from hipporag_tpu_torch.embedding import nvembed_encoder as nv
from hipporag_tpu_torch.embedding.encoder import _operand
from perfbench.encoders.nvembed2 import TINY
from perfbench.reference.encoders import nvembed2 as plain

torch.set_num_threads(1)

DTYPES = (torch.bfloat16, torch.float32)
LENGTHS = (1, 5, 22)
REPEATS = (1, 4)
HD, KV, B = 16, 2, 3
EPS = 1e-5


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _rounded(a: np.ndarray, dtype) -> torch.Tensor:
    return _operand(torch.from_numpy(np.ascontiguousarray(a, np.float32)), dtype)


# ----------------------------------------------------------------------
# CPU: the plain versions against what they replace
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("with_delta", (True, False), ids=("delta", "first_layer"))
@pytest.mark.parametrize("l", LENGTHS)
def test_add_rms_norm_is_the_residual_add_the_norm_and_the_cast(l, with_delta, dtype):
    g = _gen(l)
    x, delta = torch.randn(B * l, 64, generator=g), torch.randn(B * l, 64, generator=g)
    scale = 1 + 0.1 * torch.randn(64, generator=g)
    want_x = x + delta if with_delta else x.clone()
    want_y = _operand(F.rms_norm(want_x, (64,), scale, EPS), dtype)
    y = nv.add_rms_norm(x, delta if with_delta else None, scale, EPS, dtype)
    assert torch.equal(x, want_x) and torch.equal(y, want_y)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rep", REPEATS)
@pytest.mark.parametrize("l", LENGTHS)
def test_rope_qkv_rotates_and_lays_out_each_head(l, rep, dtype):
    """q[b * kv + g, r * L + t] is query head g * rep + r of token t, rotated
    by HF's ``x * cos + rotate_half(x) * sin``; k and v [b * kv + g, t]."""
    heads = KV * rep
    qkv = torch.randn(B, l, (heads + 2 * KV) * HD, generator=_gen(l + rep))
    cos, sin = cs.nv_rope_tables(l, HD, "cpu")
    q, k, v = nv.rope_qkv(qkv, cos, sin, heads, KV, dtype)
    x = qkv.numpy().reshape(B, l, heads + 2 * KV, HD)
    c, s = cos[:, 0].numpy(), sin[:, 0].numpy()
    s_unsigned = np.concatenate([s[:, HD // 2:], s[:, HD // 2:]], -1)  # sin(angles) on both halves

    def rope(vec, t):
        rotate_half = np.concatenate([-vec[HD // 2:], vec[:HD // 2]])
        return vec * c[t] + rotate_half * s_unsigned[t]

    want_q = np.zeros((B * KV, rep * l, HD), np.float32)
    want_k = np.zeros((B * KV, l, HD), np.float32)
    want_v = np.zeros_like(want_k)
    for b in range(B):
        for t in range(l):
            for head in range(heads):
                want_q[b * KV + head // rep, (head % rep) * l + t] = rope(x[b, t, head], t)
            for g in range(KV):
                want_k[b * KV + g, t] = rope(x[b, t, heads + g], t)
                want_v[b * KV + g, t] = x[b, t, heads + KV + g]
    for got, want in ((q, want_q), (k, want_k), (v, want_v)):
        assert torch.equal(got, _rounded(want, dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("padded", (True, False), ids=("padded_keys", "full"))
@pytest.mark.parametrize("rep", REPEATS)
@pytest.mark.parametrize("l", LENGTHS)
def test_masked_softmax_is_the_scaled_masked_softmax_and_the_cast(l, rep, padded, dtype):
    logits = 4 * torch.randn(B * KV, rep * l, l, generator=_gen(10 * l + rep))
    lengths = torch.tensor([max(1, l - 3 * i) if padded else l for i in range(B)])
    key_mask = torch.arange(l)[None, :] < lengths[:, None]
    want = logits.clone().mul_(HD ** -0.5).view(B, KV, -1, l).masked_fill_(~key_mask[:, None, None, :], -1e30)
    want = _operand(torch.softmax(want, dim=-1).view(B * KV, -1, l), dtype)
    got = nv.masked_softmax(logits, lengths, HD ** -0.5, dtype)
    assert torch.equal(got, want)
    if padded and l > 1:
        assert got[-KV:, :, int(lengths[-1]):].abs().max() == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rep", REPEATS)
@pytest.mark.parametrize("l", LENGTHS)
def test_ungroup_operand_puts_each_head_back_in_its_token_row(l, rep, dtype):
    heads = KV * rep
    ctx = torch.randn(B * KV, rep * l, HD, generator=_gen(l * rep))
    want = np.zeros((B * l, heads * HD), np.float32)
    for b in range(B):
        for t in range(l):
            for head in range(heads):
                want[b * l + t, head * HD:(head + 1) * HD] = ctx[b * KV + head // rep, (head % rep) * l + t].numpy()
    assert torch.equal(nv.ungroup_operand(ctx, B, heads, dtype), _rounded(want, dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("l", LENGTHS)
def test_swiglu_is_silu_gate_times_up_and_the_cast(l, dtype):
    gate_up = 3 * torch.randn(B * l, 2 * 56, generator=_gen(l))
    gate, up = gate_up.chunk(2, dim=-1)
    assert torch.equal(nv.swiglu(gate_up, dtype), _operand(F.silu(gate) * up, dtype))


def _parent_forward(enc, ids, lengths, pool_from):
    """The forward as it ran before the five ops: the same products, the
    element-wise work as separate torch ops, rounded by ``_operand``."""
    b, l = ids.shape
    h, kv, hd, dtype = enc.heads, enc.kv_heads, enc.head_dim, enc.dtype
    pos = torch.arange(l)
    key_mask = pos[None, :] < lengths[:, None]
    cos, sin = enc.rope_tables(l)
    x = F.embedding(ids, enc.embed).float()
    for layer in enc.layers:
        qkv = nv._dense(nv._rms_norm(x, layer.attn_norm, enc.eps), layer.qkv_w, dtype)
        qk = nv._rope(qkv[..., :(h + kv) * hd].view(b, l, h + kv, hd), cos, sin)
        q = nv._group_queries(qk[:, :, :h].transpose(1, 2), kv)
        k = qk[:, :, h:].transpose(1, 2).reshape(b * kv, l, hd)
        v = qkv[..., (h + kv) * hd:].reshape(b, l, kv, hd).transpose(1, 2).reshape(b * kv, l, hd)
        logits = nv._matmul(_operand(q, dtype), _operand(k, dtype).transpose(1, 2)).mul_(hd ** -0.5)
        logits = logits.view(b, kv, -1, l).masked_fill_(~key_mask[:, None, None, :], -1e30)
        probs = torch.softmax(logits, dim=-1).view(b * kv, -1, l)
        ctx = nv._ungroup(nv._matmul(_operand(probs, dtype), _operand(v, dtype)), b, h)
        x = x + nv._dense(ctx.transpose(1, 2).reshape(b, l, h * hd), layer.o_w, dtype)
        gate, up = nv._dense(nv._rms_norm(x, layer.mlp_norm, enc.eps), layer.gate_up_w, dtype).chunk(2, dim=-1)
        x = x + nv._dense(F.silu(gate) * up, layer.down_w, dtype)
    x = nv._geglu(nv._latent_attention(nv._rms_norm(x, enc.norm, enc.eps), enc), enc)
    pool = (key_mask & (pos[None, :] >= pool_from[:, None]))[..., None].float()
    pooled = (x * pool).sum(1) / pool.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)


@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_the_forward_through_the_ops_is_the_parents_bit_for_bit(dtype):
    """The tiny model on the CPU: values round to the operand type at the
    places they rounded before, so the unit rows are equal."""
    sizes = {k: TINY[k] for k in nv.PUBLISHED}
    enc = nv.NVEmbedV2Encoder(plain.weights(TINY, 2**31 + 20, "cpu"), sizes, dtype, "cpu")
    lengths = torch.tensor([9, 4, 7])
    ids = torch.randint(3, 32000, (3, 9), generator=_gen(20)) * (torch.arange(9)[None, :] < lengths[:, None])
    pool_from = torch.tensor([2, 0, 3])
    with torch.inference_mode():
        got = nv._forward(enc, ids, lengths, pool_from)
        want = _parent_forward(enc, ids, lengths, pool_from)
    assert torch.equal(got, want)
    assert enc.fused_launches(tuple(ids.shape)) == 0 and nv.layer_kernel_launches() == 0


@pytest.mark.parametrize("op", ("add_rms_norm", "rope_qkv", "masked_softmax", "ungroup_operand", "swiglu"))
def test_an_operand_off_the_cpu_and_off_cuda_raises(op):
    """No fallback: a tensor that is neither on the CPU nor on CUDA is refused
    before any launch."""
    meta = {"device": "meta"}
    calls = {
        "add_rms_norm": lambda: nv.add_rms_norm(torch.empty(4, 8, **meta), None, torch.empty(8, **meta), EPS,
                                                torch.bfloat16),
        "rope_qkv": lambda: nv.rope_qkv(torch.empty(1, 2, 6 * HD, **meta), *cs.nv_rope_tables(2, HD, "meta"), 2, 2,
                                        torch.bfloat16),
        "masked_softmax": lambda: nv.masked_softmax(torch.empty(2, 2, 2, **meta), torch.ones(1, dtype=torch.int64,
                                                                                             **meta), 1.0,
                                                    torch.bfloat16),
        "ungroup_operand": lambda: nv.ungroup_operand(torch.empty(2, 2, HD, **meta), 1, 2, torch.bfloat16),
        "swiglu": lambda: nv.swiglu(torch.empty(4, 8, **meta), torch.bfloat16),
    }
    with pytest.raises(ValueError, match=op):
        calls[op]()


# ----------------------------------------------------------------------
# The card: each kernel against its plain version, the replayed forward
# ----------------------------------------------------------------------
CELL_SHAPES = cs.NV_SHAPES + (cs.NV_RAGGED[:2],)  # (B, L): the cell's forwards, and a ragged one
D, F_WIDTH, HEADS, KV_HEADS, HEAD_DIM = (cs.NV_WIDTHS[k] for k in ("d", "f", "heads", "kv_heads", "head_dim"))
OPS = cs.NV_OPS
# (B, L, widths): the published widths at each of CELL_SHAPES, and the ragged
# widths, which take every narrow branch of the kernels
KERNEL_CASES = tuple((b, l, cs.NV_WIDTHS) for b, l in CELL_SHAPES) + (cs.NV_RAGGED,)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}" + ("" if c[2] is cs.NV_WIDTHS else "_ragged_widths"))
def test_each_kernel_matches_its_plain_version_on_the_card(cuda_device, case, dtype):
    """Every output of each kernel (add_rms_norm's residual too) against the
    plain version's on the same inputs (``chip_smoke.nv_held_to_plain``):
    bfloat16 within one step on at most 1e-5 of the elements, add_rms_norm
    only at rounding ties; float32 to 1e-6 relative."""
    b, l, widths = case
    g = torch.Generator(cuda_device).manual_seed(b * 100 + l)
    before = nv.layer_kernel_launches()
    cases = cs.nv_op_cases(b, l, widths, cuda_device, dtype, g)
    for name, (op, draw, _bytes) in cases.items():
        cs.nv_held_to_plain(name, op, draw())
    torch.cuda.synchronize(cuda_device)
    assert nv.layer_kernel_launches() - before == len(cases)


@pytest.mark.chip
def test_a_wrong_operand_raises_on_the_card(cuda_device):
    f32 = {"device": cuda_device}
    x, scale = torch.randn(8, 64, **f32), torch.ones(64, **f32)
    cos, sin = cs.nv_rope_tables(2, HEAD_DIM, cuda_device)
    lengths = torch.ones(2, dtype=torch.int64, device=cuda_device)
    odd = torch.zeros(2, 1, 5, **f32)
    bad = [
        lambda: nv.add_rms_norm(x.half(), None, scale, EPS, torch.bfloat16),  # dtype
        lambda: nv.add_rms_norm(x.t(), None, torch.ones(8, **f32), EPS, torch.bfloat16),  # stride
        lambda: nv.add_rms_norm(x, x[:4], scale, EPS, torch.bfloat16),  # shape
        lambda: nv.add_rms_norm(x, None, scale.cpu(), EPS, torch.bfloat16),  # device
        lambda: nv.add_rms_norm(x, None, scale, EPS, torch.float16),  # operand type
        lambda: nv.rope_qkv(torch.randn(2, 2, 5 * HEAD_DIM, **f32), cos, sin, 2, 1, torch.bfloat16),  # width
        lambda: nv.rope_qkv(torch.randn(2, 2, 3 * 5, **f32), odd, odd, 1, 1, torch.bfloat16),  # odd head_dim
        lambda: nv.masked_softmax(torch.randn(4, 2, 2, **f32), lengths.int(), 1.0, torch.bfloat16),  # int32
        lambda: nv.masked_softmax(torch.randn(3, 2, 2, **f32), lengths, 1.0, torch.bfloat16),  # rows per text
        lambda: nv.ungroup_operand(torch.randn(4, 3, HEAD_DIM, **f32), 2, 4, torch.bfloat16),  # rep * L
        lambda: nv.ungroup_operand(torch.randn(4, 2, HEAD_DIM, **f32)[:, :, 1:], 2, 2, torch.bfloat16),  # stride
        lambda: nv.swiglu(torch.randn(4, 7, **f32), torch.bfloat16),  # odd width
        lambda: nv.swiglu(torch.randn(4 * 8 + 1, **f32)[1:].view(4, 8), torch.bfloat16),  # 16-byte alignment
    ]
    before = nv.layer_kernel_launches()
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} did not raise")
    assert nv.layer_kernel_launches() == before


@pytest.fixture(scope="module")
def published_model():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hipporag_tpu_torch.config import BaseConfig

    cfg = BaseConfig(embedding_model_name=nv.ROUTE, embedding_model_dtype="bfloat16", embedding_batch_size=16)
    model = nv.NVEmbedV2DeviceEmbeddingModel(cfg, torch.device("cuda", 0))
    yield model
    del model
    torch.cuda.empty_cache()


def _checked(name: str, differing: dict):
    """``name``'s kernel, which also runs the plain version on the same
    inputs and counts the output elements where the two differ."""
    kernel, plain_op = getattr(nv, name), getattr(nv, name + "_plain")

    def run(*args):
        def fresh():
            return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        kernel_args, plain_args = fresh(), fresh()
        out, want = kernel(*kernel_args), plain_op(*plain_args)
        for a, w in zip(*((out, want) if isinstance(out, tuple) else ((out,), (want,)))):
            assert cs.bf16_steps_apart(a, w).max().item() <= 1.0, name
            differing[name][0] += int((a != w).sum())
            differing[name][1] += a.numel()
        if name == "add_rms_norm":
            assert torch.equal(kernel_args[0], plain_args[0])
            args[0].copy_(kernel_args[0])
        return out
    return run


@pytest.mark.chip
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_the_replayed_forward_matches_the_plain_forward_on_the_card(published_model, shape, monkeypatch):
    """The replayed graph against the eager forward through the plain
    versions, and, on the kernels' own path, each op's output against its
    plain version on the same inputs: at most one bfloat16 step apart on
    at most 1e-5 of the elements (add_rms_norm's rsqrt differs from
    torch's in a few rows; the other kernels repeat torch's values), the
    binding check. Those few steps carried through 32 random layers move
    the unit rows by 0.024-0.033 in L2, as much as the plain forward moves
    when its RMSNorm alone sums in another order (0.029-0.032). The limit
    ``chip_smoke.NV_FORWARD_L2`` (0.04) lies between the kernels' largest
    reading (0.033) and the bf16 forward's distance from float32
    (0.074-0.080)."""
    enc = published_model.encoder
    b, l = shape
    dev = enc.device
    g = torch.Generator(dev).manual_seed(l)
    lengths = torch.tensor([l - (i % 4) for i in range(b)], device=dev)
    ids = torch.randint(3, 32000, (b, l), generator=g, device=dev) * (torch.arange(l, device=dev) < lengths[:, None])
    pool_from = torch.full((b,), 12, device=dev).minimum(lengths)
    got = enc.encode_forward(ids, lengths, pool_from)
    assert enc.fused_launches((b, l)) == 6 * len(enc.layers) == 192
    assert torch.equal(got, enc.encode_forward(ids, lengths, pool_from))
    differing = {name: [0, 0] for name in OPS}
    for name in OPS:
        monkeypatch.setattr(nv, name, _checked(name, differing))
    with torch.inference_mode():
        torch.testing.assert_close(nv._forward(enc, ids, lengths, pool_from), got, rtol=0, atol=1e-6)
    for name in OPS:
        monkeypatch.setattr(nv, name, getattr(nv, name + "_plain"))
    with torch.inference_mode():
        want = nv._forward(enc, ids, lengths, pool_from)
    assert all(n <= 1e-5 * total for n, total in differing.values()), differing
    err = torch.linalg.vector_norm(got - want, dim=-1).max().item()
    assert err <= cs.NV_FORWARD_L2, err


@pytest.mark.chip
def test_the_embed_span_counts_the_replayed_launches_on_the_card(published_model):
    from hipporag_tpu_torch.utils.timing import recording, span

    texts = [" ".join(f"w{i}x{j}" for j in range(12 + i % 5)) for i in range(40)]
    with recording() as rec:
        with span("retrieve/embed"):
            published_model.batch_encode(texts, instruction="Given a question, retrieve passages", norm=True)
    (embed,) = [s for s in rec.spans() if s.name == "retrieve/embed"]
    assert embed.attrs["forwards"] == 3 and embed.attrs["fused_kernels"] == 192 * 3
