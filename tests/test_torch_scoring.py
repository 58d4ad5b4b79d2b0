"""The port's scoring and fused score/top-k against the JAX package.

The JAX fused kernel runs in Pallas interpret mode, as ``tests/test_pallas.py``
runs it; on CPU tensors the port's fused path runs its plain PyTorch pass A
(the CUDA kernel itself is checked against it on the GPU by
``chip_smoke.py``). Tolerances are those of ``tests/test_pallas.py``.

The bf16 fact top-k on the kernel route is held to the JAX package's
default ``fact_topk`` (its XLA path, which rounds the queries to bf16) at
B = 128, N = 32,768, D = 1,024: the same indices in every row, norm within
1e-6. With float32 queries on that route some rows' top-5 differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipporag_tpu.ops import fused_topk as ref_fused
from hipporag_tpu.ops import scoring as ref
from hipporag_tpu_torch.ops import _kernels, fused_topk, scoring

torch.set_num_threads(1)

GRID = [
    (3, 1024, 384, 1000, 5),
    (8, 512, 128, 512, 8),
    (1, 640, 200, 7, 5),  # uneven everything, valid_n > k barely
    (4, 256, 64, 3, 5),  # fewer valid keys than k
]


def _inputs(b, n, d, valid_n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    keys = np.zeros((n, d), np.float32)
    keys[:valid_n] = rng.standard_normal((valid_n, d))
    return q, keys


@pytest.mark.parametrize("b,n,d,valid_n,k", GRID)
def test_fused_matches_jax_fused_and_plain(b, n, d, valid_n, k):
    q, keys = _inputs(b, n, d, valid_n)
    norm, raw, idx = (t.numpy() for t in fused_topk.fused_score_topk(
        torch.from_numpy(q), torch.from_numpy(keys), valid_n, k))
    j_norm, j_raw, j_idx = (np.asarray(t) for t in ref_fused.fused_score_topk(
        jnp.asarray(q), jnp.asarray(keys), valid_n, k, interpret=True))
    _s, p_vals, p_idx = (t.numpy() for t in scoring.score_and_topk(
        torch.from_numpy(q), torch.from_numpy(keys), valid_n, k))

    kv = min(k, valid_n)
    for want_idx, want_norm in ((j_idx, j_norm), (p_idx, p_vals)):
        np.testing.assert_array_equal(idx[:, :kv], want_idx[:, :kv])
        np.testing.assert_allclose(norm[:, :kv], want_norm[:, :kv], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(raw[:, :kv], j_raw[:, :kv], rtol=1e-5, atol=1e-5)
    if kv < k:  # missing candidates: raw -inf, norm 0, index 0
        assert np.all(raw[:, kv:] == -np.inf) and np.all(norm[:, kv:] == 0.0)
        assert np.all(idx[:, kv:] == 0)
    full = q @ keys.T
    for i in range(b):
        for j in range(kv):
            np.testing.assert_allclose(raw[i, j], full[i, idx[i, j]], rtol=1e-5, atol=1e-5)


def test_fused_constant_row_normalizes_to_one():
    norm, _raw, _idx = fused_topk.fused_score_topk(torch.ones(2, 128), torch.ones(256, 128), 256, 4)
    j_norm, _, _ = ref_fused.fused_score_topk(
        jnp.ones((2, 128)), jnp.ones((256, 128)), 256, 4, interpret=True)
    np.testing.assert_allclose(norm.numpy(), 1.0)
    np.testing.assert_array_equal(norm.numpy(), np.asarray(j_norm))


@pytest.mark.parametrize("tile_n", [128, 512])
def test_plain_scan_matches_pallas_scan(tile_n):
    """Pass A alone: per-tile row maxima and the row extrema of the Pallas scan."""
    q, keys = _inputs(8, 1024, 128, 1000, seed=3)
    tmax, tmin = fused_topk.scan_tiles_reference(torch.from_numpy(q), torch.from_numpy(keys), 1000, tile_n)
    n_tiles = 1024 // tile_n
    j_tmax, j_mm = ref_fused._scan_call(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(1000), tile_n, 128, True, "highest")
    j_tmax, j_mm = np.asarray(j_tmax), np.asarray(j_mm)
    if tile_n == 512:
        np.testing.assert_allclose(tmax.numpy(), j_tmax[:, :n_tiles], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmin.numpy().min(1), j_mm[:, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmax.numpy().max(1), j_mm[:, 1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("checkout", [True, False])
def test_kernel_build_dir(tmp_path, monkeypatch, checkout):
    """A checkout builds its kernels into its own build/; an installed
    package into the user's cache."""
    site = tmp_path / "site"
    (site / "hipporag_tpu_torch").mkdir(parents=True)
    if checkout:
        (site / "pyproject.toml").write_text("")
    monkeypatch.setattr(_kernels, "_PKG_DIR", str(site / "hipporag_tpu_torch"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    expected = (site / "build" / "torch_kernels" if checkout
                else tmp_path / "cache" / "hipporag_tpu_torch" / "kernels")
    assert _kernels._build_dir() == str(expected)


@pytest.mark.parametrize("change", ["header", "new header", "source", "flags"])
def test_kernel_library_stale_after_any_source_change(tmp_path, monkeypatch, change):
    """A library is keyed by its flags and every source it may include: a
    changed header marks it stale, not only a changed .cu."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    built = _kernels.library_path("k")
    assert built.startswith(str(tmp_path / "build")) and _kernels.library_path("k") == built
    if change == "header":
        (csrc / "h.cuh").write_text("// v2\n")
    elif change == "new header":
        (csrc / "g.cuh").write_text("// new\n")
    elif change == "source":
        (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    else:
        monkeypatch.setattr(_kernels, "NVCC_FLAGS", (*_kernels.NVCC_FLAGS, "-lineinfo"))
    assert _kernels.library_path("k") != built


def test_scan_wrapper_refuses_non_cpu_non_cuda_tensors():
    """A tensor off the CPU takes the kernel or raises; it never falls back."""
    q = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError):
        fused_topk.scan_tiles(q, torch.empty(256, 128, device="meta"), 256)


@pytest.mark.parametrize("b,n,d,valid_n,k", GRID)
def test_score_and_topk_matches_jax(b, n, d, valid_n, k):
    q, keys = _inputs(b, n, d, valid_n, seed=1)
    scores, vals, idx = (t.numpy() for t in scoring.score_and_topk(
        torch.from_numpy(q), torch.from_numpy(keys), valid_n, k))
    j_scores, j_vals, j_idx = (np.asarray(t) for t in ref.score_and_topk(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(valid_n, jnp.int32), k))
    np.testing.assert_allclose(scores, j_scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vals, j_vals, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(idx, j_idx)


def test_min_max_normalize_edge_cases_match_jax():
    x = np.array([[1.0, 1.0, 1.0, 5.0], [0.0, 2.0, 4.0, 9.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    where = np.array([[True, True, True, False]])
    for w in (None, where):
        got = scoring.min_max_normalize(torch.from_numpy(x), where=None if w is None else torch.from_numpy(w))
        want = ref.min_max_normalize(jnp.asarray(x), where=None if w is None else jnp.asarray(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = scoring.min_max_normalize(torch.from_numpy(x), where=torch.from_numpy(where)).numpy()
    assert np.all(got[:, 3] == 0.0) and np.all(got[0, :3] == 1.0)  # masked 0, constant row 1
    # the second positional parameter is the axis, as in the JAX package
    for axis in (0, 1, -1):
        got = scoring.min_max_normalize(torch.from_numpy(x), axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.min_max_normalize(jnp.asarray(x), axis)))
    col_mask = np.array([[True], [True], [False]])
    got = scoring.min_max_normalize(torch.from_numpy(x), 0, torch.from_numpy(col_mask))
    want = ref.min_max_normalize(jnp.asarray(x), 0, jnp.asarray(col_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_lower_index_matches_lax_top_k_on_ties():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (6, 50)).astype(np.float32)
    x[0, :] = 1.0
    x[1, 10:20] = -np.inf
    vals, idx = scoring.topk_lower_index(torch.from_numpy(x), 12)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 12)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_batched_scores_bfloat16_matches_jax():
    q, keys = _inputs(4, 256, 96, 256, seed=2)
    got = scoring.batched_scores(torch.from_numpy(q), torch.from_numpy(keys), "bfloat16")
    want = ref.batched_scores(jnp.asarray(q), jnp.asarray(keys), "bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fact_topk_routes_to_the_kernel_only_on_cuda():
    assert scoring.fused_topk_route("cuda") is True
    assert scoring.fused_topk_route(torch.device("cuda", 0)) is True
    assert scoring.fused_topk_route("cpu") is False
    q, keys = _inputs(2, 300, 64, 300, seed=5)
    vals, idx = scoring.fact_topk(torch.from_numpy(q), torch.from_numpy(keys), 300, 5)
    j_vals, j_idx = ref.fact_topk(jnp.asarray(q), jnp.asarray(keys), 300, 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-6)
    # use_pallas, the JAX package's name for the route, is the only one
    f_vals, f_idx = scoring.fact_topk(torch.from_numpy(q), torch.from_numpy(keys), 300, 5, use_pallas=True)
    np.testing.assert_array_equal(f_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(f_vals.numpy(), np.asarray(j_vals), rtol=1e-5, atol=1e-6)
    p_vals, p_idx = scoring.fact_topk(torch.from_numpy(q), torch.from_numpy(keys), 300, 5, "float32", False)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p_vals.numpy(), vals.numpy())
    with pytest.raises(TypeError):
        scoring.fact_topk(torch.from_numpy(q), torch.from_numpy(keys), 300, 5, use_fused=True)


# ---------------------------------------------------------------------------
# bf16 fact top-k: the reference's query rounding on the default route
# ---------------------------------------------------------------------------

def _unit_keys_near_queries(b, n, d, seed):
    """Unit-norm keys and queries near random keys (real top-k margins, and
    near ties that bf16 query rounding can reorder)."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((n, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    q = keys[rng.choice(n, b, replace=False)] + 0.02 * rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32), keys


def _record_fused_queries(monkeypatch):
    """Wrap the fused path so a test sees the queries it was handed."""
    seen = []
    inner = fused_topk.fused_score_topk

    def recording(queries, keys, valid_n, k):
        seen.append((queries.clone(), keys.dtype))
        return inner(queries, keys, valid_n, k)

    monkeypatch.setattr(fused_topk, "fused_score_topk", recording)
    return seen


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_default_route_fact_topk_matches_jax_at_scale(monkeypatch, compute_dtype):
    """The kernel route (forced, as on the card) at B=128, N=32,768,
    D=1,024 ranks as the JAX package's default ``fact_topk``: with bf16
    compute that is its XLA path, which rounds the queries to bf16 too."""
    b, n, d, k = 128, 32_768, 1_024, 5
    q, keys = _unit_keys_near_queries(b, n, d, seed=11)
    monkeypatch.setattr(scoring, "fused_topk_route", lambda device: True)
    seen = _record_fused_queries(monkeypatch)
    resident = torch.from_numpy(keys).to(torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32)
    norm, idx = scoring.fact_topk(torch.from_numpy(q), resident, n, k, compute_dtype)
    j_norm, j_idx = ref.fact_topk(jnp.asarray(q), jnp.asarray(keys), n, k, compute_dtype)
    assert len(seen) == 1, "the default route did not take the fused path"
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(norm.numpy(), np.asarray(j_norm), rtol=0, atol=1e-6)
    rounded = torch.equal(seen[0][0], torch.from_numpy(q).to(torch.bfloat16).float())
    assert rounded == (compute_dtype == "bfloat16")


def test_explicit_use_pallas_keeps_f32_queries_as_the_jax_kernel():
    """``use_pallas=True`` is the Pallas kernel's own semantics: float32
    queries against the resident bf16 keys, as the JAX kernel computes."""
    q, keys = _unit_keys_near_queries(16, 2_048, 256, seed=12)
    keys16 = torch.from_numpy(keys).to(torch.bfloat16)
    j_keys = jnp.asarray(keys).astype(jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        seen = _record_fused_queries(mp)
        norm, idx = scoring.fact_topk(torch.from_numpy(q), keys16, 2_000, 5, "bfloat16", use_pallas=True)
    assert torch.equal(seen[0][0], torch.from_numpy(q))
    j_norm, _raw, j_idx = ref_fused.fused_score_topk(jnp.asarray(q), j_keys, 2_000, 5, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(norm.numpy(), np.asarray(j_norm), rtol=0, atol=1e-6)


def test_bf16_query_rounding_rule_at_the_threshold(monkeypatch):
    """The rule in the style of ``tests/test_pallas.py``'s routing grid: the
    default route rounds exactly where the JAX package's TPU route keeps
    its XLA path, and never under float32 compute."""
    gib = 1 << 30
    b = 256
    assert scoring.BF16_QUERY_ROUNDING_SCORE_BYTES == ref._PALLAS_SCORE_BYTES

    def rounds(score_bytes, dtype="bfloat16"):
        return scoring.rounds_bf16_queries(b, score_bytes // (b * 4), dtype)

    assert rounds(3 * gib) is True  # at the threshold: the reference's XLA path
    assert rounds(3 * gib + b * 4) is False  # one more column: its kernel
    for size in (int(0.12 * gib), int(2.44 * gib), int(4.88 * gib), 10 * gib, 3 * gib, 3 * gib + b * 4):
        assert rounds(size) is (not ref.pallas_topk_route(b, size // (b * 4), backend="tpu")), size
        assert rounds(size, "float32") is False

    # fact_topk at both sides, with the threshold moved to a small size;
    # float32 keys are rounded with the queries, as batched_scores rounds them
    q, keys = _unit_keys_near_queries(4, 512, 64, seed=13)
    monkeypatch.setattr(scoring, "fused_topk_route", lambda device: True)
    seen = _record_fused_queries(monkeypatch)
    for threshold, want_rounded in ((4 * 512 * 4, True), (4 * 512 * 4 - 1, False)):
        monkeypatch.setattr(scoring, "BF16_QUERY_ROUNDING_SCORE_BYTES", threshold)
        for keys_dtype in (torch.bfloat16, torch.float32):
            scoring.fact_topk(torch.from_numpy(q), torch.from_numpy(keys).to(keys_dtype), 512, 5, "bfloat16")
            assert torch.equal(seen[-1][0], torch.from_numpy(q).to(torch.bfloat16).float()) is want_rounded
            assert seen[-1][1] == (torch.bfloat16 if want_rounded else keys_dtype)
