"""The port's fused score/top-k with bfloat16 keys and under an inexact pass A.

The CUDA pass A runs on the TF32 tensor cores with an error-compensated
split, so its tile extrema are exact only to within a small delta; the
refine widens its selection to stay exact. These CPU tests hold the plain
pass A with bf16 keys against the JAX package's fused path (Pallas
interpret mode, as ``tests/test_pallas.py`` runs it), show that the widened
selection survives a pass A perturbed by up to delta while the old
selection does not, check the kernel's operand checks without launching it,
and check the query split and layout the kernel is fed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipporag_tpu.ops import fused_topk as ref_fused
from hipporag_tpu_torch.ops import fused_topk

torch.set_num_threads(1)

GRID = [
    (3, 1024, 384, 1000, 5),
    (8, 512, 128, 512, 8),
    (1, 640, 200, 7, 5),
    (4, 256, 64, 3, 5),
]


def _bf16_inputs(b, n, d, valid_n, seed=0):
    """f32 queries and bf16-representable keys, as numpy float32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = np.zeros((n, d), np.float32)
    keys[:valid_n] = rng.standard_normal((valid_n, d))
    keys = torch.from_numpy(keys).to(torch.bfloat16)
    return q, keys


@pytest.mark.parametrize("b,n,d,valid_n,k", GRID)
def test_bf16_keys_match_jax_fused(b, n, d, valid_n, k):
    """f32 queries x bf16 keys, f32 accumulation, in both packages.

    Both sides form f32 dots of the same f32 query and bf16-exact key values
    and differ only in summation order: relative differences stay within
    ~sqrt(D) * 2^-24, so rtol 1e-5 holds, and the indices are equal.
    """
    q, keys = _bf16_inputs(b, n, d, valid_n)
    norm, raw, idx = (t.numpy() for t in fused_topk.fused_score_topk_reference(
        torch.from_numpy(q), keys, valid_n, k))
    j_keys = jnp.asarray(keys.float().numpy()).astype(jnp.bfloat16)
    j_norm, j_raw, j_idx = (np.asarray(t) for t in ref_fused.fused_score_topk(
        jnp.asarray(q), j_keys, valid_n, k, interpret=True))
    kv = min(k, valid_n)
    np.testing.assert_array_equal(idx[:, :kv], j_idx[:, :kv])
    np.testing.assert_allclose(raw[:, :kv], j_raw[:, :kv], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(norm[:, :kv], j_norm[:, :kv], rtol=1e-5, atol=1e-6)
    if kv < k:
        assert np.all(raw[:, kv:] == -np.inf) and np.all(norm[:, kv:] == 0.0)
        assert np.all(idx[:, kv:] == 0)


@pytest.mark.parametrize("key_dtype", [torch.float32, torch.bfloat16])
def test_kernel_arg_checks_accept_f32_and_bf16_keys(key_dtype):
    q = torch.empty(4, 128, device="meta")
    fused_topk.check_scan_args(q, torch.empty(256, 128, dtype=key_dtype, device="meta"))


@pytest.mark.parametrize(
    "q_dtype,key_dtype",
    [(torch.float32, torch.float16), (torch.float32, torch.float64),
     (torch.bfloat16, torch.bfloat16), (torch.float64, torch.float32)],
)
def test_kernel_arg_checks_refuse_other_dtypes(q_dtype, key_dtype):
    q = torch.empty(4, 128, dtype=q_dtype, device="meta")
    with pytest.raises(TypeError):
        fused_topk.check_scan_args(q, torch.empty(256, 128, dtype=key_dtype, device="meta"))


@pytest.mark.parametrize("n,d", [(200, 128), (256, 48), (0, 64)])
def test_kernel_arg_checks_refuse_unaligned_shapes(n, d):
    q = torch.empty(4, d, device="meta")
    with pytest.raises(ValueError):
        fused_topk.check_scan_args(q, torch.empty(n, d, device="meta"))


# ---------------------------------------------------------------------------
# the widened selection under a pass A that is exact only to within DELTA
# ---------------------------------------------------------------------------
DELTA = 1e-3  # pass-A error the perturbation may reach (far above the kernel's)
EPS = 4e-4  # gap of the near ties: below 2 * DELTA, so the tiles can swap
N_TILES, K = 8, 3


def _near_tie_inputs(seed):
    """Row r scores key column r: its 3rd and 4th tile maxima, and its two
    lowest tile minima, lie EPS apart; every score is exact in f32."""
    rng = np.random.default_rng(seed)
    b, n, d = 2, N_TILES * fused_topk.TILE_N, 64
    keys = rng.uniform(0.1, 0.5, (n, d)).astype(np.float32)
    q = np.zeros((b, d), np.float32)
    tiles = []
    for r in range(b):
        q[r, r] = 1.0
        t = rng.permutation(N_TILES)[:6]
        for tile, value in zip(t, (0.95, 0.9, 0.8, 0.8 - EPS, -0.5, -0.5 + EPS)):
            keys[tile * fused_topk.TILE_N + rng.integers(fused_topk.TILE_N), r] = value
        tiles.append(t)
    return q, keys, tiles


def _perturbed_scan(tiles, seed):
    """The plain pass A moved by up to DELTA: random elsewhere, and against
    the true order on the near ties."""

    def scan(queries, keys, valid_n):
        tmax, tmin = fused_topk.scan_tiles_reference(queries, keys, valid_n)
        rng = np.random.default_rng(seed + 100)
        tmax = tmax + torch.from_numpy(rng.uniform(-DELTA, DELTA, tmax.shape).astype(np.float32))
        tmin = tmin + torch.from_numpy(rng.uniform(-DELTA, DELTA, tmin.shape).astype(np.float32))
        for r, t in enumerate(tiles):
            tmax[r, t[2]] = tmax[r, t[2]].item() - 0.9 * DELTA
            tmax[r, t[3]] = tmax[r, t[3]].item() + 0.9 * DELTA
            tmin[r, t[4]] = tmin[r, t[4]].item() + 0.9 * DELTA
            tmin[r, t[5]] = tmin[r, t[5]].item() - 0.9 * DELTA
        return tmax, tmin

    return scan


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_widened_selection_is_exact_under_perturbed_pass_a(seed):
    q, keys, tiles = _near_tie_inputs(seed)
    n = keys.shape[0]
    tq, tk = torch.from_numpy(q), torch.from_numpy(keys)
    want_norm, want_raw, want_idx = fused_topk.fused_score_topk_reference(tq, tk, n, K)
    j_norm, _j_raw, j_idx = (np.asarray(t) for t in ref_fused.fused_score_topk(
        jnp.asarray(q), jnp.asarray(keys), n, K, interpret=True))
    np.testing.assert_array_equal(want_idx.numpy(), j_idx)
    np.testing.assert_allclose(want_norm.numpy(), j_norm, rtol=1e-6)

    scan = _perturbed_scan(tiles, seed)
    norm, raw, idx = fused_topk._fused_topk(scan, tq, tk, n, K)
    np.testing.assert_array_equal(idx.numpy(), want_idx.numpy())
    np.testing.assert_array_equal(raw.numpy(), want_raw.numpy())
    np.testing.assert_array_equal(norm.numpy(), want_norm.numpy())

    # the selection of one tile per top-k rank misses the k-th value ...
    _n0, _r0, idx0 = fused_topk._fused_topk(scan, tq, tk, n, K, extra_tiles=0, min_tiles=2)
    assert not np.array_equal(idx0.numpy(), want_idx.numpy())
    # ... and one min tile takes the wrong row min
    norm1, _r1, idx1 = fused_topk._fused_topk(scan, tq, tk, n, K, extra_tiles=2, min_tiles=1)
    np.testing.assert_array_equal(idx1.numpy(), want_idx.numpy())
    assert np.abs(norm1.numpy() - want_norm.numpy()).max() > 1e-5


# ---------------------------------------------------------------------------
# the operands the kernel is fed
# ---------------------------------------------------------------------------
def test_tf32_split_bounds():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(50_000).astype(np.float32))
    hi, lo = fused_topk.split_tf32(x)
    for part in (hi, lo):  # TF32 values: the 13 low mantissa bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).count_nonzero()) == 0
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0**-11
    rel = ((x.double() - hi.double() - lo.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0**-22


@pytest.mark.parametrize("d", [64, 4096])
def test_three_term_tf32_dot_within_stated_delta(d):
    """k_hi q_hi + k_hi q_lo + k_lo q_hi, summed exactly, is within
    3 * 2^-22 * sum |q||k| of the exact dot: the split part of the kernel's
    bound (bf16 keys: two terms, 2^-22)."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((16, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    (qh, ql), (kh, kl) = fused_topk.split_tf32(q), fused_topk.split_tf32(k)
    qh, ql, kh, kl = (t.double() for t in (qh, ql, kh, kl))
    exact = q.double() @ k.double().T
    mag = q.double().abs() @ k.double().abs().T
    three = qh @ kh.T + ql @ kh.T + qh @ kl.T
    assert float(((three - exact).abs() / mag).max()) <= 3 * 2.0**-22
    kb = k.to(torch.bfloat16).double()
    two = (qh + ql) @ kb.T
    assert float(((two - q.double() @ kb.T).abs() / (q.double().abs() @ kb.abs().T)).max()) <= 2.0**-22


@pytest.mark.parametrize("b,width", [(5, 8), (128, 128), (300, 128)])
def test_arranged_queries_layout(b, width):
    d = 64
    q = torch.from_numpy(np.random.default_rng(b).standard_normal((b, d)).astype(np.float32))
    assert fused_topk.query_width(b) == width
    arr = fused_topk.arrange_queries(q, width)
    chunks = -(-b // width)
    assert arr.shape == (chunks, d // 32, 2, 4, 2, width, 4) and arr.is_contiguous()
    parts = fused_topk.split_tf32(torch.nn.functional.pad(q, (0, 0, 0, chunks * width - b)))
    qc, s, part, j, h, n, c = np.meshgrid(*(np.arange(x) for x in arr.shape), indexing="ij")
    stacked = torch.stack(parts).numpy()
    want = stacked[part, qc * width + n, 32 * s + 8 * c + 2 * j + h]
    np.testing.assert_array_equal(arr.numpy(), want)


@pytest.mark.parametrize("k", [1, 5])
def test_ties_to_the_last_bit_resolve_the_same_in_any_batch(k):
    """Keys whose scores tie exactly in real arithmetic but may round apart
    in float32 (the same products summed in another order): the query's
    top-k, in batches of 1 to 130 rows, is the float64 scores rounded to
    float32 with ties to the lower key, and identical in every batch."""
    from hipporag_tpu_torch.ops.scoring import topk_lower_index

    rng = np.random.default_rng(11)
    n, d = 1024, 96
    q = rng.standard_normal((1, d)).astype(np.float32)
    q[0, 1] = q[0, 0]
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys[1::2] = keys[::2]
    keys[1::2, 0], keys[1::2, 1] = keys[::2, 1], keys[::2, 0]  # a swapped pair: the same score
    keys_t = torch.from_numpy(keys)
    want_vals, want_idx = topk_lower_index((keys_t.double() @ torch.from_numpy(q).double().T).T.float(), k)
    ranked = want_idx[0].tolist()
    assert all(i - 1 in ranked[:pos] for pos, i in enumerate(ranked) if i % 2)  # ties: the lower key first
    for b in (1, 5, 16, 130):
        queries = np.concatenate([rng.standard_normal((b - 1, d)).astype(np.float32), q])
        _norm, raw, idx = fused_topk.fused_score_topk_reference(torch.from_numpy(queries), keys_t, n, k)
        assert torch.equal(idx[-1:].long(), want_idx), b
        assert torch.equal(raw[-1:], want_vals), b
