"""Fused dense scoring + exact normalized top-k (port of ``hipporag_tpu/ops/fused_topk.py``).

The [B, N] query-by-key score matrix is never formed. Two passes:

  Pass A (``scan_tiles``, the hand-written CUDA kernel
  ``csrc/fused_topk_scan.cu``): per [TILE_N, D] key tile, each row's max
  and min of S = Q K_tile^T over the valid columns (col < valid_n), into
  [B, n_tiles] buffers. Queries are float32; keys float32 or bfloat16,
  accumulated in float32, as the Pallas kernel takes them. The kernel
  reaches f32 accuracy on the TF32 tensor cores with an error-compensated
  split, so its extrema may differ from exact f32 dots by a small delta
  (bounded in the kernel's source note). Under bf16 compute the default
  route of ``ops.scoring.fact_topk`` passes queries already rounded to
  bfloat16 (the reference's XLA numerics, ``scoring.rounds_bf16_queries``):
  such a query splits into hi = q and lo = 0, so against bfloat16 keys the
  kernel and the float64 rescoring below form the exact bf16 x bf16 dots.

  Refinement (torch ops): the true top-k values of a row live in its top-k
  tiles by max, so those tiles are gathered and re-dotted, one selected
  rank at a time to bound the gather at B * TILE_N * D floats, and a final
  top-k over the candidates gives the exact result. Because pass A is exact
  only to within delta, the refine takes ``EXTRA_TILES`` more tiles than k
  (a tile whose max lies within 2 delta of the k-th can swap ranks with
  it). The row extrema for min-max normalization come from the same re-dot:
  the max is the top candidate, the min is taken over the ``MIN_TILES``
  tiles with the smallest pass-A mins.

  The re-dot's float32 products round a dot product as the kernel cuBLAS
  picks for the batch does, so scores that agree to the last bits can come
  out in another order when a query runs in a batch of another size. The
  best ``k + TIE_SPARE`` candidates (and the ``TIE_SPARE + 1`` lowest) are
  therefore scored once more in float64 and rounded to float32: the
  correctly rounded score, the same in any batch. The top-k and the row
  extrema are taken over those scores, ties to the lower key index.

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
_DEPTH_MULTIPLE = 32  # the kernel stages D in 32-deep chunks
# query widths the kernel is built for: B is rounded up to one of them
# (and runs in chunks of the largest)
QUERY_WIDTHS = (8, 16, 32, 64, 128)
EXTRA_TILES = 2  # tiles refined beyond the top-k by pass-A max
MIN_TILES = 2  # tiles with the smallest pass-A min re-dotted for the row min
TIE_SPARE = 8  # candidates beyond k (and beside the row min) rescored in float64
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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo), both TF32 values: hi = rna(x), lo = rna(x - hi).

    x - hi - lo is at most 2^-22 |x|; the kernel applies the same split to
    the keys.
    """
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def query_width(b: int) -> int:
    """The kernel's query chunk width for a batch of ``b`` rows."""
    return next((w for w in QUERY_WIDTHS if w >= b), QUERY_WIDTHS[-1])


def arrange_queries(queries: torch.Tensor, width: int) -> torch.Tensor:
    """[B, D] float32 -> the kernel's query operand.

    Shape [chunks, D / 32, 2, 4, 2, width, 4]: for query chunk qc, depth
    stage s, split part (hi, lo), k-step j, half h, query n and column c,
    the value of part[qc * width + n, 32 s + 8 c + 2 j + h]. One (chunk,
    stage) is one contiguous bulk copy; in it each (part, j) is the K-major
    [width, 8] wgmma operand of logical depth c + 4 h. The kernel reads the
    keys' depth in the same permuted order. Rows past B are zero.
    """
    b, d = queries.shape
    chunks = -(-b // width)
    q = F.pad(queries.float(), (0, 0, 0, chunks * width - b))
    parts = [
        part.view(chunks, width, d // _DEPTH_MULTIPLE, 4, 4, 2).permute(0, 2, 4, 5, 1, 3)
        for part in split_tf32(q)
    ]
    return torch.stack(parts, dim=2).contiguous()


def check_scan_args(queries: torch.Tensor, keys: torch.Tensor) -> None:
    """Raise unless the kernel takes these operands (device aside)."""
    if queries.dtype != torch.float32 or keys.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"scan_tiles kernel takes float32 queries and float32 or bfloat16 keys, "
            f"got {queries.dtype} and {keys.dtype}"
        )
    if queries.dim() != 2 or keys.dim() != 2 or keys.shape[1] != queries.shape[1]:
        raise ValueError(f"scan_tiles: keys {tuple(keys.shape)} do not match queries {tuple(queries.shape)}")
    b, d = queries.shape
    n = keys.shape[0]
    if n % TILE_N or d % _DEPTH_MULTIPLE or b == 0 or n == 0:
        raise ValueError(
            f"scan_tiles kernel needs N % {TILE_N} == 0, D % {_DEPTH_MULTIPLE} == 0 "
            f"and B, N > 0; got B={b}, N={n}, D={d}"
        )
    if not keys.is_contiguous():
        raise ValueError("scan_tiles kernel needs contiguous keys")
    if keys.data_ptr() % 16:
        raise ValueError("scan_tiles kernel needs 16-byte aligned keys")


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
    check_scan_args(queries, keys)
    b, d = queries.shape
    n = keys.shape[0]
    fn = _scan_fn()
    width = query_width(b)
    qarr = arrange_queries(queries, width)
    tmax = torch.empty(b, n // TILE_N, dtype=torch.float32, device=queries.device)
    tmin = torch.empty_like(tmax)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = fn(
        qarr.data_ptr(), keys.data_ptr(), int(keys.dtype == torch.bfloat16),
        tmax.data_ptr(), tmin.data_ptr(), b, n, d, int(valid_n), width, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_topk_scan kernel launch failed: CUDA error {err}")
    SCAN_LAUNCHES.add()
    return tmax, tmin


def _scan_fn():
    lib = load("fused_topk_scan")
    fn = lib.fused_topk_scan
    if fn.argtypes is None:
        if lib.fused_topk_scan_tile_n() != TILE_N or lib.fused_topk_scan_depth() != _DEPTH_MULTIPLE:
            raise RuntimeError("fused_topk_scan.cu TILE_N/DEPTH differ from ops/fused_topk")
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x.contiguous()
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _fused_topk(scan, queries, keys, valid_n, k: int, extra_tiles: int = EXTRA_TILES,
                min_tiles: int = MIN_TILES):
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

    # select each row's top-(k + extra) tiles by max (invalid tiles carry
    # -inf) and re-dot them, one rank at a time to bound the gather
    kt = min(k + extra_tiles, n_tiles)
    _tile_vals, tile_sel = topk_lower_index(tmax, kt)  # [B, kt]
    cand = torch.empty(b, kt, TILE_N, dtype=torch.float32, device=queries.device)
    cidx = torch.empty(b, kt, TILE_N, dtype=torch.int64, device=queries.device)
    for r in range(kt):
        cand[:, r], cidx[:, r] = redot(tile_sel[:, r])
    cand = cand.view(b, kt * TILE_N)
    cidx = cidx.view(b, kt * TILE_N)
    cand = torch.where(cidx < valid_n, cand, -torch.inf)

    exact, ids = _rescore(cand, cidx, keys, queries, k + TIE_SPARE)
    vals, pos = topk_lower_index(exact, k)  # [B, k]; ids ascend, so ties go to the lower key
    idx = torch.gather(ids, 1, pos)

    # Row extrema in the refinement's arithmetic: the max is the top
    # candidate, the min comes from re-dotting the tiles with the smallest
    # pass-A mins. Pass A's extrema differ from a re-dotted score by up to
    # its delta, which would move a score equal to the row min off 0 after
    # normalization, and can swap the two lowest tiles.
    _low_vals, low_sel = topk_lower_index(-tmin, min(min_tiles, n_tiles))
    lows = [redot(low_sel[:, r]) for r in range(low_sel.shape[1])]
    low = torch.cat([v for v, _ in lows], 1)
    low_idx = torch.cat([i for _, i in lows], 1)
    low_exact, _ids = _rescore(-torch.where(low_idx < valid_n, low, torch.inf), low_idx, keys, queries,
                               TIE_SPARE + 1)
    mn = torch.where(low_exact > -torch.inf, low_exact, torch.inf).amin(1, keepdim=True)
    mx = vals[:, :1]
    rng = mx - mn
    finite = vals > -torch.inf
    norm = torch.where(rng == 0, torch.ones_like(vals), (vals - mn) / torch.where(rng == 0, 1.0, rng))
    norm = torch.where(finite, norm, 0.0)
    idx = torch.where(finite, idx, 0).to(torch.int32)
    return norm, vals, idx


def _rescore(cand, cidx, keys, queries, count):
    """The ``count`` largest candidates of each row, scored in float64 and
    rounded to float32, ordered by ascending key id: (scores [B, count],
    key ids [B, count]); candidates that were -inf stay -inf."""
    count = min(count, cand.shape[1])
    top, pos = topk_lower_index(cand, count)
    ids, order = torch.sort(torch.gather(cidx, 1, pos), dim=1)
    real = torch.gather(top, 1, order) > -torch.inf
    exact = torch.bmm(keys[ids].double(), queries.double()[:, :, None])[:, :, 0].float()
    return torch.where(real, exact, -torch.inf), ids


def fused_score_topk(queries: torch.Tensor, keys: torch.Tensor, valid_n, k: int):
    """Exact normalized top-k without forming the [B, N] scores.

    Args:
      queries: [B, D] query embeddings.
      keys: [N, D] key embeddings, float32 or bfloat16 (rows >= valid_n
        are padding).
      valid_n: number of real key rows.
      k: top-k ((k + EXTRA_TILES) * TILE_N candidates are refined; keep k
        modest).

    Returns:
      (norm_vals [B, k], raw_vals [B, k], idx [B, k] int32). Rows with fewer
      than k valid keys carry -inf raw values, norm 0 and index 0.
    """
    return _fused_topk(scan_tiles, queries, keys, valid_n, k)


def fused_score_topk_reference(queries: torch.Tensor, keys: torch.Tensor, valid_n, k: int):
    """:func:`fused_score_topk` with the plain PyTorch pass A on any device."""
    return _fused_topk(scan_tiles_reference, queries, keys, valid_n, k)
