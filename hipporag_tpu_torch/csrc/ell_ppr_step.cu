// One power step of the bucketed-ELL Personalized PageRank, in slot space,
// for one column tile of b <= 128 queries (K2):
//
//   y      = T p                      every bucket row and every hub slot
//   p_next = (1 - d) r + d (y + dm r)  dm = c * R_d per column, all S slot rows
//   c_next = (1 - d) + d dm
//   resid  = max(max |p_next - p|, max |c_next - c|)   over the b real columns
//
// It replaces no Pallas kernel: the JAX package's step is XLA
// (hipporag_tpu/ops/pagerank.py: _spmv_ell and _bucket_reduce inside
// batched_ppr_ell's step), which the port ran as torch ops: one gather and
// one einsum per in-degree bucket and hub chunk block, a cat, the affine
// update and the residual, about a hundred launches per iteration, each
// bucket's [rows, W, b] gather written to device memory and read back.
//
// Operator: the wrapper's plan (ops/pagerank.build_ell_plan), built once per
// graph, is the ELL operator with its zero-weight padding dropped: ent[E] =
// (source slot, float32 weight bits) of every entry, rows in slot order and
// a hub's chunk rows in hub_seg order, and a list of work items of at most
// 32 entries (ops/pagerank._ELL_SEGMENT), each (slot, first entry, entries,
// partial row or -1). A row of at most 32 entries is one item, which
// finishes its slot; a wider row (wide buckets and every hub) is cut into
// items that write partial sums,
// and the combine kernel sums a slot's partial rows in item order. Items are
// ordered heaviest first, so no slot's work trails the launch: the largest
// hub is as many 32-entry items as it takes, spread over the card.
//
// Schedule: a group of L lanes takes one item (L = the smallest power of two
// with 4 L >= ld; a lane holds 4 adjacent columns, so one gathered row is
// one coalesced L x 16-byte load, or L x 8 bytes from a bfloat16 state);
// 32 / L groups per warp, UNROLL gathers in flight per group. Columns past b
// are masked: they are neither summed into the residual nor left unwritten
// (zeros), and c is read only below b.
//
// Determinism: every sum runs in one fixed order. An item sums its entries
// in entry order (fmaf from 0); the combine sums a slot's partial rows in
// item order, so a hub's chunk rows add in hub_seg order. The residual is a
// max, reduced per block and folded with atomicMax on the float's bit
// pattern (the values are non-negative, or NaN, which then wins as in
// torch's amax); no atomic takes part in any sum. Two runs on the same
// inputs give bitwise equal results.
//
// Arithmetic against the torch step: the affine update and c_next are the
// torch ops' roundings, op for op (__fmul_rn / __fadd_rn, never contracted),
// so they differ from torch only through y, whose sum order differs from
// the einsum's. With a bfloat16 state the gathered values and the weights
// are rounded to bfloat16 and multiplied and summed in float32, as
// _bucket_reduce does; the kernel also writes the bfloat16 copy of p_next
// for the next step's gathers.
//
// What bounds it (H100 SXM, 50 MB L2, 3.35 TB/s): at the benchmark's shape
// (about 103k slots, 670k entries, b = 128) an iteration must read the
// entries (5.4 MB), r and p (53 MB each) and write p_next (53 MB); the
// roofline's 110 MB per iteration counts p once. But every entry gathers a
// 512-byte row of p: 343 MB of gathered rows per iteration, from a state
// (53 MB) larger than the L2, so most gathers miss it and the kernel is
// bound by device-memory traffic well above the roofline's bytes. The
// design keeps the gathers coalesced and many in flight (UNROLL per group,
// all resident warps) and adds no traffic beyond them: no [rows, W, b]
// intermediate, one write of each p_next row, partial rows only for slots
// wider than one item. Measured on an H100 80GB HBM3 (700 W) at that shape:
// 0.107 ms per step, 31% of the roofline's 33 us; its 343 MB of gathered
// rows in that time are 3.2 TB/s, the speed of device memory.
//
// Plain C interface for ctypes (no PyTorch headers); returns a cudaError_t
// code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 8;   // gathers in flight per lane group
constexpr int MAX_LD = 128; // columns of one tile

struct Step {
  const int2* ent;         // [E] (source slot, weight bits)
  const int4* items;       // [n_items] (slot, first entry, entries, partial row or -1)
  const int4* multi;       // [n_multi] (slot, first partial row, partial rows, 0)
  const void* pg;          // [S, ld] the state the gathers read: float32, or its bfloat16 copy
  const float* p;          // [S, ld]
  const float* r;          // [S, ld]
  const float* c;          // [b]
  const float* rdm;        // [b]
  float* p_next;           // [S, ld]
  __nv_bfloat16* pg_next;  // [S, ld] bfloat16 copy of p_next, or null
  float* c_next;           // [b]
  float* partials;         // [n_parts, ld]
  unsigned int* resid;     // the residual's float bits
  int n_items, n_multi, b, ld;
  float d, omd;
};

__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float4 load_row(const void* pg, int64_t off) {
  if constexpr (BF16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(pg) + off));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(pg) + off));
  }
}

// sum_j w_j pg[src_j, col4 .. col4 + 3] over the item's entries, in entry order
template <bool BF16>
__device__ __forceinline__ float4 gather_sum(const Step& s, int beg, int len, int col4, bool active) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < len; j += UNROLL) {
    int2 e[UNROLL];
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) e[u] = j + u < len ? __ldg(s.ent + beg + j + u) : make_int2(0, 0);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = active && j + u < len ? load_row<BF16>(s.pg, static_cast<int64_t>(e[u].x) * s.ld + col4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j + u < len) {
        const float w = BF16 ? bf16_round(__int_as_float(e[u].y)) : __int_as_float(e[u].y);
        acc.x = fmaf(w, v[u].x, acc.x);
        acc.y = fmaf(w, v[u].y, acc.y);
        acc.z = fmaf(w, v[u].z, acc.z);
        acc.w = fmaf(w, v[u].w, acc.w);
      }
    }
  }
  return acc;
}

// (1 - d) r + d (y + dm r), rounded as the torch ops round it
__device__ __forceinline__ float affine(const Step& s, float r, float y, float dm) {
  return __fadd_rn(__fmul_rn(s.omd, r), __fmul_rn(s.d, __fadd_rn(y, __fmul_rn(dm, r))));
}

// p_next of one slot row's 4 columns from its y; returns the running residual
template <bool BF16>
__device__ __forceinline__ float finish(const Step& s, int slot, float4 y, int col4, float4 dm,
                                        float resid) {
  const int64_t off = static_cast<int64_t>(slot) * s.ld + col4;
  const float4 r = __ldcs(reinterpret_cast<const float4*>(s.r + off));
  const float4 p = *reinterpret_cast<const float4*>(s.p + off);
  const float yv[4] = {y.x, y.y, y.z, y.w}, rv[4] = {r.x, r.y, r.z, r.w}, pv[4] = {p.x, p.y, p.z, p.w};
  const float dv[4] = {dm.x, dm.y, dm.z, dm.w};
  float out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (col4 + k < s.b) {
      out[k] = affine(s, rv[k], yv[k], dv[k]);
      resid = nanmax(resid, fabsf(__fsub_rn(out[k], pv[k])));
    } else {
      out[k] = 0.f;
    }
  }
  *reinterpret_cast<float4*>(s.p_next + off) = make_float4(out[0], out[1], out[2], out[3]);
  if constexpr (BF16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(out[0], out[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(out[2], out[3]);
    *reinterpret_cast<uint2*>(s.pg_next + off) =
        make_uint2(*reinterpret_cast<const unsigned int*>(&lo), *reinterpret_cast<const unsigned int*>(&hi));
  }
  return resid;
}

__device__ __forceinline__ float4 column_dm(const Step& s, int col4, bool active) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (col4 + k < s.b) v[k] = __fmul_rn(s.c[col4 + k], s.rdm[col4 + k]);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the block's max into *s.resid (one atomic per block; a max, not a sum)
__device__ __forceinline__ void block_max(const Step& s, float v) {
  __shared__ float red[WARPS];
  for (int off = 16; off > 0; off >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < WARPS; ++w) m = nanmax(m, red[w]);
    if (m != 0.f) atomicMax(s.resid, __float_as_uint(m));
  }
}

template <int L, bool BF16>
__global__ void __launch_bounds__(THREADS) items_kernel(const Step s) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col4 = 4 * (lane % L);
  const bool active = col4 < s.ld;
  const float4 dm = column_dm(s, col4, active);
  float resid = 0.f;
  if (blockIdx.x == 0) {
    for (int col = threadIdx.x; col < s.b; col += THREADS) {
      const float c = s.c[col];
      const float cn = __fadd_rn(s.omd, __fmul_rn(s.d, __fmul_rn(c, s.rdm[col])));
      s.c_next[col] = cn;
      resid = nanmax(resid, fabsf(__fsub_rn(cn, c)));
    }
  }
  const int stride = gridDim.x * WARPS * G;
  for (int i = (blockIdx.x * WARPS + warp) * G + lane / L; i < s.n_items; i += stride) {
    const int4 it = __ldg(s.items + i);
    const float4 y = gather_sum<BF16>(s, it.y, it.z, col4, active);
    if (!active) continue;
    if (it.w < 0)
      resid = finish<BF16>(s, it.x, y, col4, dm, resid);
    else
      *reinterpret_cast<float4*>(s.partials + static_cast<int64_t>(it.w) * s.ld + col4) = y;
  }
  block_max(s, resid);
}

// slots wider than one item: their partial rows summed in item order
template <int L, bool BF16>
__global__ void __launch_bounds__(THREADS) combine_kernel(const Step s) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col4 = 4 * (lane % L);
  const bool active = col4 < s.ld;
  const float4 dm = column_dm(s, col4, active);
  float resid = 0.f;
  const int stride = gridDim.x * WARPS * G;
  for (int m = (blockIdx.x * WARPS + warp) * G + lane / L; m < s.n_multi; m += stride) {
    const int4 mu = __ldg(s.multi + m);
    if (!active) continue;
    const float* part = s.partials + static_cast<int64_t>(mu.y) * s.ld + col4;
    float4 y = *reinterpret_cast<const float4*>(part);
#pragma unroll 8
    for (int k = 1; k < mu.z; ++k) {
      const float4 q = *reinterpret_cast<const float4*>(part + static_cast<int64_t>(k) * s.ld);
      y = make_float4(__fadd_rn(y.x, q.x), __fadd_rn(y.y, q.y), __fadd_rn(y.z, q.z), __fadd_rn(y.w, q.w));
    }
    resid = finish<BF16>(s, mu.x, y, col4, dm, resid);
  }
  block_max(s, resid);
}

template <typename K>
int blocks_per_sm(K kernel) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, 0) == cudaSuccess && n > 0 ? n : 1;
}

// enough blocks for the work, at most what is resident at once (the rest
// of the work strides through them)
int grid_for(int64_t work, int per_block, int resident) {
  const int64_t need = (work + per_block - 1) / per_block;
  return static_cast<int>(need < resident ? need : resident);
}

template <int L, bool BF16>
int launch(const Step& s, cudaStream_t stream) {
  constexpr int G = 32 / L;
  static const int items_per_sm = blocks_per_sm(items_kernel<L, BF16>);
  static const int combine_per_sm = blocks_per_sm(combine_kernel<L, BF16>);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(s.resid, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g1 = grid_for(s.n_items, WARPS * G, sms * items_per_sm);
  if (g1 > 0) {
    items_kernel<L, BF16><<<g1, THREADS, 0, stream>>>(s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int g2 = grid_for(s.n_multi, WARPS * G, sms * combine_per_sm);
  if (g2 > 0) {
    combine_kernel<L, BF16><<<g2, THREADS, 0, stream>>>(s);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <bool BF16>
int dispatch(const Step& s, cudaStream_t stream) {
  const int quads = s.ld / 4;
  if (quads <= 1) return launch<1, BF16>(s, stream);
  if (quads <= 2) return launch<2, BF16>(s, stream);
  if (quads <= 4) return launch<4, BF16>(s, stream);
  if (quads <= 8) return launch<8, BF16>(s, stream);
  if (quads <= 16) return launch<16, BF16>(s, stream);
  return launch<32, BF16>(s, stream);
}

}  // namespace

// ent: [E, 2] int32; items: [n_items, 4] int32; multi: [n_multi, 4] int32;
// pg: [S, ld] float32 (pg_bf16 = 0) or bfloat16 (pg_bf16 = 1); p, r, p_next:
// [S, ld] float32; pg_next: [S, ld] bfloat16 when pg_bf16, else unused; c,
// rdm, c_next: [b] float32; partials: [n_parts, ld] float32; resid: one
// float32, overwritten. ld % 4 == 0, 0 < b <= ld <= 128; every row pointer
// 16-byte aligned.
extern "C" int ell_ppr_step(const int32_t* ent, const int32_t* items, const int32_t* multi,
                            const void* pg, int pg_bf16, const float* p, const float* r,
                            const float* c, const float* rdm, float* p_next, void* pg_next,
                            float* c_next, float* partials, float* resid, int64_t n_items,
                            int64_t n_multi, int64_t b, int64_t ld, float d, float omd,
                            void* stream) {
  if (b <= 0 || ld < b || ld > MAX_LD || ld % 4 != 0 || n_items < 0 || n_multi < 0 ||
      n_items > 0x7fffffff || n_multi > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Step s;
  s.ent = reinterpret_cast<const int2*>(ent);
  s.items = reinterpret_cast<const int4*>(items);
  s.multi = reinterpret_cast<const int4*>(multi);
  s.pg = pg;
  s.p = p;
  s.r = r;
  s.c = c;
  s.rdm = rdm;
  s.p_next = p_next;
  s.pg_next = static_cast<__nv_bfloat16*>(pg_next);
  s.c_next = c_next;
  s.partials = partials;
  s.resid = reinterpret_cast<unsigned int*>(resid);
  s.n_items = static_cast<int>(n_items);
  s.n_multi = static_cast<int>(n_multi);
  s.b = static_cast<int>(b);
  s.ld = static_cast<int>(ld);
  s.d = d;
  s.omd = omd;
  auto st = static_cast<cudaStream_t>(stream);
  return pg_bf16 ? dispatch<true>(s, st) : dispatch<false>(s, st);
}
