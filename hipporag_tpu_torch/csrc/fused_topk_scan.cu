// Pass A of the fused score/top-k: per key tile, the row max and row min
// of S = Q . K_tile^T over the valid columns, without forming [B, N].
//
// Replaces the Pallas TPU kernel hipporag_tpu/ops/fused_topk.py
// _make_scan_kernel (launched by _scan_call). Same result, other schedule:
// the TPU kernel walks key tiles in order on one core and carries the
// running row min/max in VMEM scratch; here a persistent grid walks
// (key tile, query chunk) items and writes each tile's max AND min into
// [B, n_tiles] buffers (no cross-block state, no atomics, so the result is
// deterministic); the caller picks the tiles to refine from them.
//
// Arithmetic: f32 accuracy on the TF32 tensor cores by an error-compensated
// split ("3xTF32"), as Precision.HIGHEST is a multi-pass bf16 emulation on
// the TPU. x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi), and
//   q . k ~= k_hi q_hi + k_hi q_lo + k_lo q_hi     (f32 keys)
//   q . k ~= k q_hi + k q_lo                        (bf16 keys: exact in TF32)
// The wrapper splits the queries once; the kernel splits each key in
// registers (cvt.rna.tf32.f32), so no rounding is left to the tensor core.
// Error of one tile extremum against exact arithmetic: per product,
// |x - x_hi - x_lo| <= 2^-22 |x| and the dropped k_lo q_lo <= 2^-22 |q||k|,
// so the split loses at most ~3 * 2^-22 * sum_i |q_i||k_i| (2^-22 * sum for
// bf16 keys). The TF32 products are exact in f32. The tensor core sums them
// in f32 without rounding to nearest, so its error grows with the depth it
// accumulates: each 32-deep stage (96 products, 64 for bf16) goes into a
// fresh accumulator, which the CUDA cores add into a round-to-nearest f32
// sum. Worst case: delta <= (3 * 2^-22 + 96 * 2^-23 + D / 32 * 2^-24)
//   * max sum_i |q_i||k_i|; for unit vectors at D = 4096, 2.0e-5.
// Measured on an H100 at that shape against the plain f32 pass A: ~2e-6.
//
// What bounds it (H100 SXM): 2 * B * N * D FLOP per TF32 pass at
// 495 TFLOP/s dense (3 passes for f32 keys, 2 for bf16) against N * D * 4
// (or 2) key bytes at 3.35 TB/s. At B = 128, N = 262,144, D = 4096: 1.67 ms
// of TF32 vs 1.28 ms of keys for f32, 1.11 ms vs 0.64 ms for bf16; the
// query tile (hi and lo, 2 * N_q * 4 bytes per depth step) is re-read from
// L2 for every key tile, twice the key bytes at N_q = 128. Design:
//  - keys are wgmma's A operand (M = 64 keys per consumer warpgroup, two
//    warpgroups per 128-key tile), queries its B operand (N_q = B rounded
//    up to 8 .. 128, larger B in chunks of 128), so a small bucket wastes
//    no 64-row padding and the keys, the only large operand, stream from
//    device memory once;
//  - one producer warp feeds a ring of stages, each one [128, 32] key tile
//    by TMA (cp.async.bulk.tensor; f32 rows 128B-swizzled) and one 32-deep
//    query chunk by a bulk copy, both completing on the stage's mbarrier;
//  - the depth inside a stage is permuted (physical column 8c + 2j + h is
//    column c + 4h of k-step j), the same way in the wrapper's query layout,
//    so a thread reads its A fragments for the whole stage as 32 bytes of
//    a key row (16 for bf16) without bank conflicts or register shuffles;
//  - the epilogue reduces each query column over the valid key rows across
//    the 8 lanes that hold it, then across the 8 consumer warps through
//    shared memory, while the producer already loads the next item.
//
// Plain C interface for ctypes (no PyTorch headers). The tensor map for TMA
// is encoded with the driver's cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point (no -lcuda). Returns a cudaError_t code.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

constexpr int TILE_N = 128;                 // keys per tile (= ops/fused_topk.TILE_N)
constexpr int DEPTH = 32;                   // depth of one stage (= ops/fused_topk._DEPTH_MULTIPLE)
constexpr int CONSUMER_WARPS = 8;           // two warpgroups, 64 keys each
constexpr int THREADS = CONSUMER_WARPS * 32 + 32;  // + one producer warp
constexpr int SMEM_BUDGET = 200 * 1024;

template <int NQ, bool BF16>
struct Layout {
  static constexpr int KEY_BYTES = TILE_N * DEPTH * (BF16 ? 2 : 4);
  // [2 (hi, lo)][4 (k-step j)][2 (half h)][NQ][4] floats
  static constexpr int Q_BYTES = 2 * DEPTH * NQ * 4;
  static constexpr int STAGE_BYTES = KEY_BYTES + Q_BYTES;
  static constexpr int RED_BYTES = 2 * CONSUMER_WARPS * NQ * 4;
  static constexpr int FREE = SMEM_BUDGET - RED_BYTES;
  static constexpr int STAGES = FREE / STAGE_BYTES > 8 ? 8 : FREE / STAGE_BYTES;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + RED_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "at least two stages");
  static_assert(STAGE_BYTES % 1024 == 0, "stages keep the 128B swizzle's 1024-byte alignment");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int32_t c0, int32_t c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// wgmma descriptor of a K-major, unswizzled operand: core matrices of
// 8 rows x 16 bytes; lbo steps along K, sbo along the rows.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32);
}

// Pin registers at this point of the program: the compiler may not move
// their definitions past (or their uses before) it.
template <int K>
__device__ __forceinline__ void fence_operands(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// The 8 depth values of one key row a thread needs for a stage, as TF32
// bit patterns: physical columns 8c .. 8c + 7 of the row. An f32 tile
// arrives 128B-swizzled (16-byte chunk q of row r at chunk q ^ (r % 8)),
// so the 8 lanes of one 16-byte phase (two rows) hit 32 distinct banks; a
// bf16 row is 64 bytes and those lanes read 128 contiguous bytes.
template <bool BF16>
__device__ __forceinline__ void load_row(const uint8_t* tile, int row, int c, float (&v)[8]) {
  if constexpr (BF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(tile + row * (DEPTH * 2) + c * 16);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float4* r = reinterpret_cast<const float4*>(tile + row * (DEPTH * 4));
    const float4 a = r[(2 * c) ^ (row % 8)];
    const float4 b = r[(2 * c + 1) ^ (row % 8)];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

template <int NQ, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const __grid_constant__ CUtensorMap key_map, const float* __restrict__ qarr,
            float* __restrict__ tmax, float* __restrict__ tmin, int64_t b, int64_t valid_n,
            int64_t n_tiles, int64_t q_chunks, int depth_steps) {
  using L = Layout<NQ, BF16>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* red_max = reinterpret_cast<float*>(base + L::STAGES * L::STAGE_BYTES);
  float* red_min = red_max + CONSUMER_WARPS * NQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(red_min + CONSUMER_WARPS * NQ);
  uint64_t* empty = full + L::STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int64_t items = n_tiles * q_chunks;
  if (warp == CONSUMER_WARPS) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t tile = item / q_chunks;
        const int64_t qc = item % q_chunks;
        const uint8_t* qsrc =
            reinterpret_cast<const uint8_t*>(qarr) + qc * depth_steps * int64_t(L::Q_BYTES);
        for (int s = 0; s < depth_steps; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], L::STAGE_BYTES);
          uint8_t* buf = base + stage * L::STAGE_BYTES;
          tma_load_2d(buf, &key_map, &full[stage], s * DEPTH, static_cast<int32_t>(tile * TILE_N));
          bulk_load(buf + L::KEY_BYTES, qsrc + s * int64_t(L::Q_BYTES), L::Q_BYTES, &full[stage]);
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns key rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4;
  const int row0 = wg * 64 + (warp % 4) * 16 + lane / 4;  // and row0 + 8
  const int c = lane % 4;
  constexpr int ND = NQ / 2;
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t tile = item / q_chunks;
    const int64_t qc = item % q_chunks;
    float acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = 0.0f;

    for (int s = 0; s < depth_steps; ++s) {
      mbar_wait(&full[stage], phase);
      __syncwarp();  // wgmma is .aligned: the warp issues it converged
      const uint8_t* buf = base + stage * L::STAGE_BYTES;
      float v0[8], v1[8];
      load_row<BF16>(buf, row0, c, v0);
      load_row<BF16>(buf, row0 + 8, c, v1);
      const uint32_t qaddr = smem_addr(buf + L::KEY_BYTES);
      // B operand of k-step j, split part h (0 = q_hi, 1 = q_lo)
      const auto q_desc = [&](int h, int j) {
        return make_desc(qaddr + (4 * h + j) * (8 * NQ * 4), NQ * 16, 128);
      };
      // A fragment of k-step j: (row0, c), (row0 + 8, c), (row0, c + 4),
      // (row0 + 8, c + 4) = physical columns 2j, 2j, 2j + 1, 2j + 1
      float part[ND];  // this stage's 32-deep partial dots, overwritten by its first wgmma
      if constexpr (BF16) {
        // keys go in as loaded; their loads overlap the first wgmmas
        fence_operands(part);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t k[4] = {__float_as_uint(v0[2 * j]), __float_as_uint(v1[2 * j]),
                                 __float_as_uint(v0[2 * j + 1]), __float_as_uint(v1[2 * j + 1])};
          WgmmaTf32<NQ>::mma(part, k, q_desc(1, j), j > 0);
          WgmmaTf32<NQ>::mma(part, k, q_desc(0, j), 1);
        }
      } else {
        // split every fragment before the fence: a register written between
        // wgmma.fence and a wgmma makes ptxas serialize the wgmmas
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x[4] = {v0[2 * j], v1[2 * j], v0[2 * j + 1], v1[2 * j + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[j][e] = rna_tf32(x[e]);
            lo[j][e] = rna_tf32(x[e] - __uint_as_float(hi[j][e]));
          }
        }
        fence_operands(hi);
        fence_operands(lo);
        fence_operands(part);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          WgmmaTf32<NQ>::mma(part, lo[j], q_desc(0, j), j > 0);
          WgmmaTf32<NQ>::mma(part, hi[j], q_desc(1, j), 1);
          WgmmaTf32<NQ>::mma(part, hi[j], q_desc(0, j), 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
      // the tensor core sums in f32 without rounding to nearest (its error
      // grows with the depth it accumulates); promote every 32-deep partial
      // into a round-to-nearest f32 sum on the CUDA cores
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] += part[i];
    }

    // epilogue: accumulator i of n8 block blk is key row row0 (+8 for the
    // upper pair), query column 8 blk + 2c (+1)
    const int64_t key0 = tile * TILE_N;
    const bool valid0 = key0 + row0 < valid_n;
    const bool valid1 = key0 + row0 + 8 < valid_n;
#pragma unroll
    for (int blk = 0; blk < NQ / 8; ++blk) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x0 = acc[4 * blk + e];
        const float x1 = acc[4 * blk + 2 + e];
        float mx = fmaxf(valid0 ? x0 : -CUDART_INF_F, valid1 ? x1 : -CUDART_INF_F);
        float mn = fminf(valid0 ? x0 : CUDART_INF_F, valid1 ? x1 : CUDART_INF_F);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        }
        if (lane < 4) {
          red_max[warp * NQ + 8 * blk + 2 * c + e] = mx;
          red_min[warp * NQ + 8 * blk + 2 * c + e] = mn;
        }
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_WARPS * 32) : "memory");
    for (int col = threadIdx.x; col < NQ; col += CONSUMER_WARPS * 32) {
      float mx = red_max[col];
      float mn = red_min[col];
#pragma unroll
      for (int w = 1; w < CONSUMER_WARPS; ++w) {
        mx = fmaxf(mx, red_max[w * NQ + col]);
        mn = fminf(mn, red_min[w * NQ + col]);
      }
      const int64_t row = qc * NQ + col;
      if (row < b) {
        tmax[row * n_tiles + tile] = mx;
        tmin[row * n_tiles + tile] = mn;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_WARPS * 32) : "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int NQ, bool BF16>
int launch(const void* keys, const float* qarr, float* tmax, float* tmin, int64_t b, int64_t n,
           int64_t d, int64_t valid_n, cudaStream_t stream) {
  using L = Layout<NQ, BF16>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * (BF16 ? 2 : 4)};
  const cuuint32_t box[2] = {DEPTH, TILE_N};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&map, BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(keys), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             BF16 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scan_kernel<NQ, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = n / TILE_N;
  const int64_t q_chunks = (b + NQ - 1) / NQ;
  const int64_t items = n_tiles * q_chunks;
  const int grid = static_cast<int>(items < sms ? items : sms);
  scan_kernel<NQ, BF16><<<grid, THREADS, L::SMEM_BYTES, stream>>>(
      map, qarr, tmax, tmin, b, valid_n, n_tiles, q_chunks, static_cast<int>(d / DEPTH));
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch(int64_t width, const void* keys, const float* qarr, float* tmax, float* tmin,
             int64_t b, int64_t n, int64_t d, int64_t valid_n, cudaStream_t stream) {
  switch (width) {
    case 8: return launch<8, BF16>(keys, qarr, tmax, tmin, b, n, d, valid_n, stream);
    case 16: return launch<16, BF16>(keys, qarr, tmax, tmin, b, n, d, valid_n, stream);
    case 32: return launch<32, BF16>(keys, qarr, tmax, tmin, b, n, d, valid_n, stream);
    case 64: return launch<64, BF16>(keys, qarr, tmax, tmin, b, n, d, valid_n, stream);
    case 128: return launch<128, BF16>(keys, qarr, tmax, tmin, b, n, d, valid_n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NQ, bool BF16>
int layout_of(int* smem_bytes, int* stages) {
  *smem_bytes = Layout<NQ, BF16>::SMEM_BYTES;
  *stages = Layout<NQ, BF16>::STAGES;
  return 0;
}

template <bool BF16>
int layout(int64_t width, int* smem_bytes, int* stages) {
  switch (width) {
    case 8: return layout_of<8, BF16>(smem_bytes, stages);
    case 16: return layout_of<16, BF16>(smem_bytes, stages);
    case 32: return layout_of<32, BF16>(smem_bytes, stages);
    case 64: return layout_of<64, BF16>(smem_bytes, stages);
    case 128: return layout_of<128, BF16>(smem_bytes, stages);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qarr: the split queries in the layout of ops/fused_topk.arrange_queries,
// [ceil(b / width), d / 32, 2, 4, 2, width, 4] float32. keys: [n, d] float32
// (keys_bf16 = 0) or bfloat16 (keys_bf16 = 1), 16-byte aligned.
extern "C" int fused_topk_scan(const float* qarr, const void* keys, int keys_bf16, float* tmax,
                               float* tmin, int64_t b, int64_t n, int64_t d, int64_t valid_n,
                               int64_t width, void* stream) {
  if (b <= 0 || n <= 0 || n % TILE_N != 0 || d <= 0 || d % DEPTH != 0 || d / DEPTH > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return keys_bf16 ? dispatch<true>(width, keys, qarr, tmax, tmin, b, n, d, valid_n, s)
                   : dispatch<false>(width, keys, qarr, tmax, tmin, b, n, d, valid_n, s);
}

extern "C" int fused_topk_scan_tile_n() { return TILE_N; }

extern "C" int fused_topk_scan_depth() { return DEPTH; }

// Dynamic shared memory per block and ring stages of one instance (ptxas -v
// reports neither).
extern "C" int fused_topk_scan_layout(int64_t width, int keys_bf16, int* smem_bytes,
                                      int* stages) {
  return keys_bf16 ? layout<true>(width, smem_bytes, stages)
                   : layout<false>(width, smem_bytes, stages);
}
