"""Fused dense scoring + exact normalized top-k (port of ``hipporag_tpu/ops/fused_topk.py``).

The [B, N] query-by-key score matrix is never formed. Two passes:

  Pass A (``scan_tiles``, the hand-written CUDA kernel
  ``csrc/fused_topk_scan.cu``): per [TILE_N, D] key tile, each row's max
  and min of S = Q K_tile^T over the valid columns (col < valid_n), into
  [B, n_tiles] buffers.

  Refinement (torch ops): the true top-k values of a row live in its top-k
  tiles by max, so those tiles are gathered and re-dotted, one selected
  rank at a time to bound the gather at B * TILE_N * D floats, and a final
  top-k over the k * TILE_N candidates gives the exact result. The row
  extrema for min-max normalization come from the same re-dot: the max is
  the top candidate, the min is taken over the tile with the smallest
  pass-A min.

Normalization follows ``ops.scoring.min_max_normalize``: constant rows map
to 1.0, missing candidates (fewer than k valid keys) to norm 0 and index 0.
Ties within a tile go to the lower index; across tiles with exactly tied
maxima the candidate order follows tile rank, as in the reference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._kernels import LaunchCounter, load
from .scoring import topk_lower_index

TILE_N = 128  # keys per tile; the kernel's TILE_N
_DEPTH_MULTIPLE = 16  # the kernel stages D in 16-wide chunks
# Bound on the [B, cols] score block the plain scan forms at once.
_PLAIN_SCAN_BYTES = 1 << 28

SCAN_LAUNCHES = LaunchCounter()


def scan_tiles_reference(queries: torch.Tensor, keys: torch.Tensor, valid_n, tile_n: int = TILE_N):
    """Plain PyTorch pass A: (tmax, tmin), each [B, N // tile_n] float32.

    Tiles without a valid column carry tmax = -inf and tmin = +inf.
    """
    b = queries.shape[0]
    n_tiles = keys.shape[0] // tile_n
    tmax = queries.new_empty(b, n_tiles, dtype=torch.float32)
    tmin = torch.empty_like(tmax)
    step = max(1, _PLAIN_SCAN_BYTES // (max(b, 1) * tile_n * 4))
    for t0 in range(0, n_tiles, step):
        t1 = min(n_tiles, t0 + step)
        s = (queries.float() @ keys[t0 * tile_n:t1 * tile_n].float().T).view(b, t1 - t0, tile_n)
        col = torch.arange(t0 * tile_n, t1 * tile_n, device=s.device).view(t1 - t0, tile_n)
        valid = col < int(valid_n)
        tmax[:, t0:t1] = torch.where(valid, s, -torch.inf).amax(-1)
        tmin[:, t0:t1] = torch.where(valid, s, torch.inf).amin(-1)
    return tmax, tmin


def scan_tiles(queries: torch.Tensor, keys: torch.Tensor, valid_n):
    """Pass A: (tmax, tmin), each [B, N // TILE_N] float32.

    A CUDA tensor launches the kernel (and counts the launch in
    ``SCAN_LAUNCHES``); a CPU tensor runs :func:`scan_tiles_reference`.
    """
    if queries.device.type == "cpu" and keys.device.type == "cpu":
        return scan_tiles_reference(queries, keys, valid_n)
    if queries.device.type != "cuda" or keys.device != queries.device:
        raise ValueError(
            f"scan_tiles: queries on {queries.device} and keys on {keys.device}; "
            "both must be on one CUDA device (or both on the CPU)"
        )
    if queries.dtype != torch.float32 or keys.dtype != torch.float32:
        raise TypeError(
            f"scan_tiles kernel takes float32 queries and keys, got {queries.dtype} "
            f"and {keys.dtype} (compute_dtype='bfloat16' is not supported by the "
            "fused kernel; set use_pallas_kernels=False)"
        )
    b, d = queries.shape
    n = keys.shape[0]
    if keys.dim() != 2 or keys.shape[1] != d:
        raise ValueError(f"scan_tiles: keys {tuple(keys.shape)} do not match queries {tuple(queries.shape)}")
    if n % TILE_N or d % _DEPTH_MULTIPLE or b == 0:
        raise ValueError(
            f"scan_tiles kernel needs N % {TILE_N} == 0, D % {_DEPTH_MULTIPLE} == 0 "
            f"and B > 0; got B={b}, N={n}, D={d}"
        )
    if not (queries.is_contiguous() and keys.is_contiguous()):
        raise ValueError("scan_tiles kernel needs contiguous queries and keys")
    if queries.data_ptr() % 16 or keys.data_ptr() % 16:
        raise ValueError("scan_tiles kernel needs 16-byte aligned queries and keys")
    fn = _scan_fn()
    tmax = torch.empty(b, n // TILE_N, dtype=torch.float32, device=queries.device)
    tmin = torch.empty_like(tmax)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = fn(
        queries.data_ptr(), keys.data_ptr(), tmax.data_ptr(), tmin.data_ptr(),
        b, n, d, int(valid_n), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_topk_scan kernel launch failed: CUDA error {err}")
    SCAN_LAUNCHES.add()
    return tmax, tmin


def _scan_fn():
    lib = load("fused_topk_scan")
    fn = lib.fused_topk_scan_f32
    if fn.argtypes is None:
        if lib.fused_topk_scan_tile_n() != TILE_N:
            raise RuntimeError("fused_topk_scan.cu TILE_N differs from ops/fused_topk.TILE_N")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x.contiguous()
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _fused_topk(scan, queries, keys, valid_n, k: int):
    b, d = queries.shape
    n = keys.shape[0]
    k = min(k, n)
    valid_n = int(valid_n)

    d_pad = -(-d // _DEPTH_MULTIPLE) * _DEPTH_MULTIPLE
    n_pad = -(-n // TILE_N) * TILE_N
    n_tiles = n_pad // TILE_N
    keys = _pad_to(keys, n_pad, d_pad)
    queries = _pad_to(queries, b, d_pad)

    tmax, tmin = scan(queries, keys, valid_n)

    keys3 = keys.view(n_tiles, TILE_N, d_pad)
    q = queries.float()[:, :, None]
    col = torch.arange(TILE_N, device=queries.device)

    def redot(tiles):
        """Scores [B, TILE_N] of each row against one selected tile, and their key ids."""
        return torch.bmm(keys3[tiles].float(), q)[:, :, 0], tiles[:, None] * TILE_N + col

    # select each row's top-kt tiles by max (invalid tiles carry -inf) and
    # re-dot them, one rank at a time to bound the gather
    kt = min(k, n_tiles)
    _tile_vals, tile_sel = topk_lower_index(tmax, kt)  # [B, kt]
    cand = torch.empty(b, kt, TILE_N, dtype=torch.float32, device=queries.device)
    cidx = torch.empty(b, kt, TILE_N, dtype=torch.int64, device=queries.device)
    for r in range(kt):
        cand[:, r], cidx[:, r] = redot(tile_sel[:, r])
    cand = cand.view(b, kt * TILE_N)
    cidx = cidx.view(b, kt * TILE_N)
    cand = torch.where(cidx < valid_n, cand, -torch.inf)

    vals, pos = topk_lower_index(cand, k)  # [B, k]
    idx = torch.gather(cidx, 1, pos)

    # Row extrema in the refinement's arithmetic: the max is the top
    # candidate, the min comes from re-dotting the tile with the smallest
    # pass-A min. Pass A sums in another order, so its extrema can differ
    # from a re-dotted score by an ulp, which would move a score equal to
    # the row min off 0 after normalization.
    low, low_idx = redot(tmin.argmin(1))
    mn = torch.where(low_idx < valid_n, low, torch.inf).amin(1, keepdim=True)
    mx = vals[:, :1]
    rng = mx - mn
    finite = vals > -torch.inf
    norm = torch.where(rng == 0, torch.ones_like(vals), (vals - mn) / torch.where(rng == 0, 1.0, rng))
    norm = torch.where(finite, norm, 0.0)
    idx = torch.where(finite, idx, 0).to(torch.int32)
    return norm, vals, idx


def fused_score_topk(queries: torch.Tensor, keys: torch.Tensor, valid_n, k: int):
    """Exact normalized top-k without forming the [B, N] scores.

    Args:
      queries: [B, D] query embeddings.
      keys: [N, D] key embeddings (rows >= valid_n are padding).
      valid_n: number of real key rows.
      k: top-k (k * TILE_N candidates are refined; keep k modest).

    Returns:
      (norm_vals [B, k], raw_vals [B, k], idx [B, k] int32). Rows with fewer
      than k valid keys carry -inf raw values, norm 0 and index 0.
    """
    return _fused_topk(scan_tiles, queries, keys, valid_n, k)


def fused_score_topk_reference(queries: torch.Tensor, keys: torch.Tensor, valid_n, k: int):
    """:func:`fused_score_topk` with the plain PyTorch pass A on any device."""
    return _fused_topk(scan_tiles_reference, queries, keys, valid_n, k)
