// Pass A of the fused score/top-k: per key tile, the row max and row min
// of S = Q . K_tile^T over the valid columns, without forming [B, N].
//
// Replaces the Pallas TPU kernel hipporag_tpu/ops/fused_topk.py
// _make_scan_kernel (launched by _scan_call). Same result, other schedule:
// the TPU kernel walks key tiles in order on one core and carries the
// running row min/max in VMEM scratch; here every (query block, key tile)
// pair is an independent block that writes its tile's max AND min into
// [B, n_tiles] buffers (no cross-block state, so no atomics and a
// deterministic result); the caller picks the tiles to refine from them.
//
// What bounds it: the keys, N*D*4 bytes, are read from device memory once.
// At a small query batch the pass is bound by those bytes; its arithmetic
// is 2*B*N*D FLOP, so from about B = 40 (H100: 67 TFLOP/s f32 over
// 3.35 TB/s) the f32 FMA rate bounds it instead. The design streams each
// [128, D] key tile through shared memory in 16-wide depth chunks, lets the
// (at most two, at B <= 128) query blocks of one tile run as neighbouring
// blocks so the second read of a tile hits L2, and gives every thread a
// 4 x 8 register tile of plain f32 FMAs (no TF32, no tensor cores: the
// reference computes at Precision.HIGHEST).
//
// Plain C interface for ctypes (no PyTorch headers): pointers to
// contiguous float32 device buffers, the stream, and the sizes. Returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int TILE_N = 128;   // keys per tile (must match ops/fused_topk.TILE_N)
constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_K = 16;   // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 4;         // rows per thread
constexpr int TN = 8;         // columns per thread: two runs of 4, 64 apart

__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const float* __restrict__ keys,
            float* __restrict__ tmax, float* __restrict__ tmin, int64_t b,
            int64_t d, int64_t valid_n, int64_t n_tiles, int64_t q_blocks) {
  __shared__ __align__(16) float qs[BLOCK_K][BLOCK_M];
  __shared__ __align__(16) float ks[BLOCK_K][TILE_N];

  // query block fastest: the blocks that read one key tile are neighbours
  const int64_t tile = blockIdx.x / q_blocks;
  const int64_t row0 = (blockIdx.x % q_blocks) * BLOCK_M;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group; a warp holds two row groups
  const int ty = tid / 16;  // row group
  const float* ktile = keys + tile * TILE_N * d;
  // warp-uniform: both row groups of a warp past b skip the FMAs
  const bool active = row0 + ty * TM < b;

  // loader coordinates: one float4 of Q and two of K per thread per stage
  const int lrow = tid / 4;        // 0..63
  const int lcol = (tid % 4) * 4;  // 0, 4, 8, 12

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < d; k0 += BLOCK_K) {
    float4 qv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + lrow < b)
      qv = *reinterpret_cast<const float4*>(q + (row0 + lrow) * d + k0 + lcol);
    qs[lcol + 0][lrow] = qv.x;
    qs[lcol + 1][lrow] = qv.y;
    qs[lcol + 2][lrow] = qv.z;
    qs[lcol + 3][lrow] = qv.w;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = lrow + h * 64;
      const float4 kv =
          *reinterpret_cast<const float4*>(ktile + kr * d + k0 + lcol);
      ks[lcol + 0][kr] = kv.x;
      ks[lcol + 1][kr] = kv.y;
      ks[lcol + 2][kr] = kv.z;
      ks[lcol + 3][kr] = kv.w;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BLOCK_K; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * TM]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ks[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&ks[kk][64 + tx * 4]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int64_t col0 = tile * TILE_N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mx = -CUDART_INF_F;
    float mn = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      if (col0 + c < valid_n) {
        mx = fmaxf(mx, acc[i][j]);
        mn = fminf(mn, acc[i][j]);
      }
    }
    // the 16 lanes of one row group share tid / 16: reduce across them
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    const int64_t row = row0 + ty * TM + i;
    if (tx == 0 && row < b) {
      tmax[row * n_tiles + tile] = mx;
      tmin[row * n_tiles + tile] = mn;
    }
  }
}

}  // namespace

extern "C" int fused_topk_scan_f32(const float* q, const float* keys,
                                   float* tmax, float* tmin, int64_t b,
                                   int64_t n, int64_t d, int64_t valid_n,
                                   void* stream) {
  if (b <= 0 || n <= 0 || n % TILE_N != 0 || d <= 0 || d % BLOCK_K != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = n / TILE_N;
  const int64_t q_blocks = (b + BLOCK_M - 1) / BLOCK_M;
  const int64_t blocks = n_tiles * q_blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      q, keys, tmax, tmin, b, d, valid_n, n_tiles, q_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_topk_scan_tile_n() { return TILE_N; }
