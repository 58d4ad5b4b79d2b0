// The element-wise chain between the six products of one NV-Embed-v2
// decoder layer (embedding/nvembed_encoder.py), in five kernels launched six
// times per layer:
//
//   add_rms_norm     x += delta (float32, in place); y = rms_norm(x) * scale,
//                    the next product's operand (before qkv and gate_up)
//   rope_qkv         the qkv product's output -> q in the grouped layout
//                    [B * kv, rep * L, hd], k and v [B * kv, L, hd]; RoPE on
//                    q and k
//   masked_softmax   QK^T logits -> probabilities: logits * scale, keys at
//                    positions >= length set to -1e30, softmax over keys
//   ungroup_operand  the PV output [B * kv, rep * L, hd] -> the o product's
//                    operand [B * L, heads * hd]
//   swiglu           gate_up [M, 2F] -> silu(gate) * up [M, F]
//
// Every output a product reads is written in the product's operand type
// (bfloat16, or float32 when the encoder computes in float32). The math is
// float32 and rounds as the torch ops it replaces round: products and sums
// that torch computes as separate ops are __fmul_rn / __fadd_rn here (never
// contracted into an FMA), exp is expf, and a float32 value becomes
// bfloat16 once, round to nearest even, as `x.to(torch.bfloat16)`. So
// rope_qkv, ungroup_operand and swiglu repeat torch's values, and
// masked_softmax sums a row in the order of torch's warp softmax for
// rows of up to 1,024 keys; add_rms_norm's sum of squares runs in its own
// order, so its rsqrt may differ from torch's in the last place.
//
// It replaces no TPU kernel: the JAX package has no NV-Embed-v2. Before it,
// the chain was some 30 torch ops per layer (the residual adds, F.rms_norm,
// RoPE's roll, multiplies and add, the strided layout copies, the mask, the
// softmax, SiLU and every cast to bfloat16), each a launch that read and
// wrote device memory.
//
// What bounds it (H100 SXM, 3.35 TB/s): bytes. At the benchmark's forward
// of 16 texts of 22 tokens (M = 352, D = 4096, F = 14,336, 32 query heads
// sharing 8 key/value heads of 128) a layer's six launches must move 114
// MB: add_rms_norm 20.2 MB twice (x and delta read, x and y written),
// rope_qkv 13.0, masked_softmax 1.5, ungroup_operand 8.7, swiglu 50.5
// (gate_up read, its product written): 34 us a layer, 1.1 ms a forward.
// Each kernel reads every input byte once and writes every output byte
// once, with 16-byte loads and 8-byte bfloat16 stores where the widths
// allow (add_rms_norm and swiglu: width % 4 == 0; rope_qkv: hd % 8 == 0;
// ungroup_operand: hd % 4 == 0), coalesced across a warp everywhere.
// add_rms_norm reads its row a second time for the normalised pass, from
// the L1 or L2 (16 KB a row at D = 4096); masked_softmax keeps a row of up
// to 32 keys in registers.
//
// Plain C interface for ctypes (no PyTorch headers); each entry returns a
// cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NORM_THREADS = 512;  // add_rms_norm: a row of 4096 in two 16-byte loads a thread per tensor
constexpr float MASKED = -1e30f;  // the masked keys' logit, as masked_fill_ writes it

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// VEC consecutive floats at p (VEC = 4: one 16-byte load)
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p[k];
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) store(p + k, v[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the sum of v over the block (N threads), in a fixed order, to every thread
template <int N>
__device__ __forceinline__ float block_sum(float v) {
  constexpr int W = N / 32;
  __shared__ float part[W];
  __shared__ float total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < W ? part[lane] : 0.f);
    if (lane == 0) total = v;
  }
  __syncthreads();
  return total;
}

// One block per row of x [rows, d]: x += delta (when delta is not null),
// then y = x * rsqrt(mean(x^2) + eps) * scale.
template <int VEC, typename OutT>
__global__ void __launch_bounds__(NORM_THREADS) add_rms_norm_kernel(float* __restrict__ x, const float* __restrict__ delta,
                                                               const float* __restrict__ scale, OutT* __restrict__ y,
                                                               int d, float eps) {
  const int64_t off = static_cast<int64_t>(blockIdx.x) * d;
  float* xr = x + off;
  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < d; i += NORM_THREADS * VEC) {
    float v[VEC];
    load_vec<VEC>(xr + i, v);
    if (delta != nullptr) {
      float dv[VEC];
      load_vec<VEC>(delta + off + i, dv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = __fadd_rn(v[k], dv[k]);
      store_vec<VEC>(xr + i, v);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) ss = fmaf(v[k], v[k], ss);
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(block_sum<NORM_THREADS>(ss), static_cast<float>(d)), eps));
  for (int i = threadIdx.x * VEC; i < d; i += NORM_THREADS * VEC) {
    float v[VEC], s[VEC];
    load_vec<VEC>(xr + i, v);  // this thread's own writes above
    load_vec<VEC>(scale + i, s);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(__fmul_rn(v[k], rstd), s[k]);
    store_vec<VEC>(y + off + i, v);
  }
}

// One block per token (b, t) of qkv [B, L, (heads + 2 kv) * hd]. A thread
// takes VEC adjacent i of one head and their rotate-half partners i + hd / 2
// (VEC = 4 when hd % 8 == 0: 16-byte loads, 8-byte bfloat16 stores).
template <int VEC, typename OutT>
__global__ void __launch_bounds__(THREADS) rope_qkv_kernel(const float* __restrict__ qkv, const float* __restrict__ cos_t,
                                                           const float* __restrict__ sin_t, OutT* __restrict__ q,
                                                           OutT* __restrict__ k, OutT* __restrict__ v, int l,
                                                           int heads, int kv_heads, int hd) {
  const int token = blockIdx.x, b = token / l, t = token % l;
  const int half = hd / 2, rep = heads / kv_heads, slots = heads + 2 * kv_heads;
  const float* src = qkv + static_cast<int64_t>(token) * slots * hd;
  const float* c = cos_t + static_cast<int64_t>(t) * hd;
  const float* s = sin_t + static_cast<int64_t>(t) * hd;
  for (int j = threadIdx.x * VEC; j < slots * half; j += THREADS * VEC) {
    const int head = j / half, i = j % half;
    float lo[VEC], hi[VEC];
    load_vec<VEC>(src + head * hd + i, lo);
    load_vec<VEC>(src + head * hd + i + half, hi);
    OutT* dst;
    if (head < heads) {  // query head g * rep + r: row g of text b, positions r * L + t
      const int g = head / rep, r = head % rep;
      dst = q + ((static_cast<int64_t>(b * kv_heads + g) * rep + r) * l + t) * hd;
    } else if (head < heads + kv_heads) {
      dst = k + (static_cast<int64_t>(b * kv_heads + head - heads) * l + t) * hd;
    } else {
      dst = v + (static_cast<int64_t>(b * kv_heads + head - heads - kv_heads) * l + t) * hd;
      store_vec<VEC>(dst + i, lo);
      store_vec<VEC>(dst + i + half, hi);
      continue;
    }
    // x * cos + roll(x, hd / 2) * signed_sin, each product rounded, then the sum
    float c_lo[VEC], c_hi[VEC], s_lo[VEC], s_hi[VEC], out_lo[VEC], out_hi[VEC];
    load_vec<VEC>(c + i, c_lo);
    load_vec<VEC>(c + i + half, c_hi);
    load_vec<VEC>(s + i, s_lo);
    load_vec<VEC>(s + i + half, s_hi);
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      out_lo[u] = __fadd_rn(__fmul_rn(lo[u], c_lo[u]), __fmul_rn(hi[u], s_lo[u]));
      out_hi[u] = __fadd_rn(__fmul_rn(hi[u], c_hi[u]), __fmul_rn(lo[u], s_hi[u]));
    }
    store_vec<VEC>(dst + i, out_lo);
    store_vec<VEC>(dst + i + half, out_hi);
  }
}

// logits * scale, or MASKED at a key past the text's length
__device__ __forceinline__ float scaled(const float* src, int j, int64_t len, float scale) {
  return j < len ? __fmul_rn(src[j], scale) : MASKED;
}

// One warp per row of logits [rows, l]; a row of text b = row / rows_per_text
// has lengths[b] real keys. Lane u takes keys u, u + 32, ..., sums its own
// in order, and the warp folds the lanes' sums by halves, as torch's warp
// softmax does. With SHORT (l <= 32) a lane's one key stays in a register;
// otherwise each of the three passes reads the row again.
template <bool SHORT, typename OutT>
__global__ void __launch_bounds__(THREADS) masked_softmax_kernel(const float* __restrict__ logits,
                                                                 const int64_t* __restrict__ lengths,
                                                                 OutT* __restrict__ probs, int64_t rows,
                                                                 int64_t rows_per_text, int l, float scale) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t len = lengths[row / rows_per_text];
  const float* src = logits + row * l;
  OutT* dst = probs + row * l;
  const float neg_inf = __int_as_float(0xff800000);
  if constexpr (SHORT) {
    const bool key = lane < l;
    float x = key ? scaled(src, lane, len, scale) : neg_inf;
    const float m = warp_max(x);
    x = key ? expf(__fsub_rn(x, m)) : 0.f;
    const float sum = warp_sum(x);
    if (key) store(dst + lane, __fdiv_rn(x, sum));
  } else {
    float m = neg_inf, sum = 0.f;
    for (int j = lane; j < l; j += 32) m = fmaxf(m, scaled(src, j, len, scale));
    m = warp_max(m);
    for (int j = lane; j < l; j += 32) sum = __fadd_rn(sum, expf(__fsub_rn(scaled(src, j, len, scale), m)));
    sum = warp_sum(sum);
    for (int j = lane; j < l; j += 32) store(dst + j, __fdiv_rn(expf(__fsub_rn(scaled(src, j, len, scale), m)), sum));
  }
}

// One block per token (b, t) of the output [B * L, heads * hd]; VEC columns
// a thread (4 when hd % 4 == 0, else 2).
template <int VEC, typename OutT>
__global__ void __launch_bounds__(THREADS) ungroup_kernel(const float* __restrict__ ctx, OutT* __restrict__ out,
                                                          int l, int heads, int kv_heads, int hd) {
  const int token = blockIdx.x, b = token / l, t = token % l;
  const int rep = heads / kv_heads, width = heads * hd;
  OutT* dst = out + static_cast<int64_t>(token) * width;
  for (int j = threadIdx.x * VEC; j < width; j += THREADS * VEC) {
    const int head = j / hd, i = j % hd, g = head / rep, r = head % rep;
    const float* from = ctx + ((static_cast<int64_t>(b * kv_heads + g) * rep + r) * l + t) * hd + i;
    if constexpr (VEC == 4) {
      float v[4];
      load_vec<4>(from, v);
      store_vec<4>(dst + j, v);
    } else {
      const float2 v = *reinterpret_cast<const float2*>(from);
      store2(dst + j, v.x, v.y);
    }
  }
}

// out[m, j] = silu(gu[m, j]) * gu[m, f + j], VEC columns a thread
template <int VEC, typename OutT>
__global__ void __launch_bounds__(THREADS) swiglu_kernel(const float* __restrict__ gu, OutT* __restrict__ out,
                                                         int64_t n, int f) {
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
  if (e >= n) return;
  const int64_t row = e / f;
  const int col = static_cast<int>(e % f);
  float g[VEC], u[VEC];
  load_vec<VEC>(gu + row * 2 * f + col, g);
  load_vec<VEC>(gu + row * 2 * f + f + col, u);
#pragma unroll
  for (int k = 0; k < VEC; ++k) g[k] = __fmul_rn(__fdiv_rn(g[k], __fadd_rn(1.f, expf(-g[k]))), u[k]);
  store_vec<VEC>(out + e, g);
}

int64_t blocks(int64_t n, int64_t per) { return (n + per - 1) / per; }

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Every pointer below is 16-byte aligned (the wrapper checks it).
//
// x: [rows, d] float32, updated in place when delta ([rows, d] float32) is
// not null; scale: [d] float32; y: [rows, d] bfloat16 (out_bf16 = 1) or
// float32. 16-byte loads when d % 4 == 0.
extern "C" int nvembed_add_rms_norm(float* x, const float* delta, const float* scale, void* y, int out_bf16,
                                    int64_t rows, int64_t d, float eps, void* stream) {
  if (rows < 0 || rows > 0x7fffffff || d <= 0 || d > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0;
  const int di = static_cast<int>(d);
  if (out_bf16) {
    auto out = static_cast<__nv_bfloat16*>(y);
    if (vec) add_rms_norm_kernel<4><<<static_cast<unsigned>(rows), NORM_THREADS, 0, st>>>(x, delta, scale, out, di, eps);
    else add_rms_norm_kernel<1><<<static_cast<unsigned>(rows), NORM_THREADS, 0, st>>>(x, delta, scale, out, di, eps);
  } else {
    auto out = static_cast<float*>(y);
    if (vec) add_rms_norm_kernel<4><<<static_cast<unsigned>(rows), NORM_THREADS, 0, st>>>(x, delta, scale, out, di, eps);
    else add_rms_norm_kernel<1><<<static_cast<unsigned>(rows), NORM_THREADS, 0, st>>>(x, delta, scale, out, di, eps);
  }
  return last_error();
}

// qkv: [b, l, (heads + 2 kv_heads) * hd] float32; cos_t, sin_t: [l, hd]
// float32; q: [b * kv_heads, (heads / kv_heads) * l, hd]; k, v: [b * kv_heads,
// l, hd], all three bfloat16 (out_bf16 = 1) or float32. hd even.
extern "C" int nvembed_rope_qkv(const float* qkv, const float* cos_t, const float* sin_t, void* q, void* k, void* v,
                                int out_bf16, int64_t b, int64_t l, int64_t heads, int64_t kv_heads, int64_t hd,
                                void* stream) {
  if (b < 0 || l < 0 || b * l > 0x7fffffff || hd <= 0 || hd % 2 || kv_heads <= 0 || heads % kv_heads ||
      (heads + 2 * kv_heads) * hd > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b * l == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int li = static_cast<int>(l), h = static_cast<int>(heads), kv = static_cast<int>(kv_heads),
            hdi = static_cast<int>(hd);
  const auto grid = static_cast<unsigned>(b * l);
  if (hd % 8 == 0) {
    if (out_bf16)
      rope_qkv_kernel<4><<<grid, THREADS, 0, st>>>(qkv, cos_t, sin_t, static_cast<__nv_bfloat16*>(q),
                                                  static_cast<__nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(v), li,
                                                  h, kv, hdi);
    else
      rope_qkv_kernel<4><<<grid, THREADS, 0, st>>>(qkv, cos_t, sin_t, static_cast<float*>(q), static_cast<float*>(k),
                                                  static_cast<float*>(v), li, h, kv, hdi);
  } else {
    if (out_bf16)
      rope_qkv_kernel<1><<<grid, THREADS, 0, st>>>(qkv, cos_t, sin_t, static_cast<__nv_bfloat16*>(q),
                                                  static_cast<__nv_bfloat16*>(k), static_cast<__nv_bfloat16*>(v), li,
                                                  h, kv, hdi);
    else
      rope_qkv_kernel<1><<<grid, THREADS, 0, st>>>(qkv, cos_t, sin_t, static_cast<float*>(q), static_cast<float*>(k),
                                                  static_cast<float*>(v), li, h, kv, hdi);
  }
  return last_error();
}

// logits: [rows, l] float32, rows_per_text consecutive rows per text;
// lengths: [rows / rows_per_text] int64; probs: [rows, l] bfloat16
// (out_bf16 = 1) or float32.
extern "C" int nvembed_masked_softmax(const float* logits, const int64_t* lengths, void* probs, int out_bf16,
                                      int64_t rows, int64_t rows_per_text, int64_t l, float scale, void* stream) {
  if (rows < 0 || rows_per_text <= 0 || l <= 0 || l > 0x7fffffff || blocks(rows, WARPS) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t grid = blocks(rows, WARPS);
  const int li = static_cast<int>(l);
  const auto g = static_cast<unsigned>(grid);
  if (out_bf16) {
    auto out = static_cast<__nv_bfloat16*>(probs);
    if (l <= 32) masked_softmax_kernel<true><<<g, THREADS, 0, st>>>(logits, lengths, out, rows, rows_per_text, li, scale);
    else masked_softmax_kernel<false><<<g, THREADS, 0, st>>>(logits, lengths, out, rows, rows_per_text, li, scale);
  } else {
    auto out = static_cast<float*>(probs);
    if (l <= 32) masked_softmax_kernel<true><<<g, THREADS, 0, st>>>(logits, lengths, out, rows, rows_per_text, li, scale);
    else masked_softmax_kernel<false><<<g, THREADS, 0, st>>>(logits, lengths, out, rows, rows_per_text, li, scale);
  }
  return last_error();
}

// ctx: [b * kv_heads, (heads / kv_heads) * l, hd] float32; out: [b * l,
// heads * hd] bfloat16 (out_bf16 = 1) or float32. hd even.
extern "C" int nvembed_ungroup_operand(const float* ctx, void* out, int out_bf16, int64_t b, int64_t l, int64_t heads,
                                       int64_t kv_heads, int64_t hd, void* stream) {
  if (b < 0 || l < 0 || b * l > 0x7fffffff || hd <= 0 || hd % 2 || kv_heads <= 0 || heads % kv_heads ||
      heads * hd > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b * l == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int li = static_cast<int>(l), h = static_cast<int>(heads), kv = static_cast<int>(kv_heads),
            hdi = static_cast<int>(hd);
  const auto grid = static_cast<unsigned>(b * l);
  if (hd % 4 == 0) {
    if (out_bf16)
      ungroup_kernel<4><<<grid, THREADS, 0, st>>>(ctx, static_cast<__nv_bfloat16*>(out), li, h, kv, hdi);
    else
      ungroup_kernel<4><<<grid, THREADS, 0, st>>>(ctx, static_cast<float*>(out), li, h, kv, hdi);
  } else {
    if (out_bf16)
      ungroup_kernel<2><<<grid, THREADS, 0, st>>>(ctx, static_cast<__nv_bfloat16*>(out), li, h, kv, hdi);
    else
      ungroup_kernel<2><<<grid, THREADS, 0, st>>>(ctx, static_cast<float*>(out), li, h, kv, hdi);
  }
  return last_error();
}

// gu: [rows, 2 f] float32; out: [rows, f] bfloat16 (out_bf16 = 1) or
// float32. 16-byte loads when f % 4 == 0.
extern "C" int nvembed_swiglu(const float* gu, void* out, int out_bf16, int64_t rows, int64_t f, void* stream) {
  if (rows < 0 || f <= 0 || f > 0x3fffffff || blocks(rows * f, THREADS) > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t n = rows * f;
  const int fi = static_cast<int>(f);
  const bool vec = f % 4 == 0;
  if (out_bf16) {
    auto o = static_cast<__nv_bfloat16*>(out);
    if (vec) swiglu_kernel<4><<<static_cast<unsigned>(blocks(n / 4, THREADS)), THREADS, 0, st>>>(gu, o, n, fi);
    else swiglu_kernel<1><<<static_cast<unsigned>(blocks(n, THREADS)), THREADS, 0, st>>>(gu, o, n, fi);
  } else {
    auto o = static_cast<float*>(out);
    if (vec) swiglu_kernel<4><<<static_cast<unsigned>(blocks(n / 4, THREADS)), THREADS, 0, st>>>(gu, o, n, fi);
    else swiglu_kernel<1><<<static_cast<unsigned>(blocks(n, THREADS)), THREADS, 0, st>>>(gu, o, n, fi);
  }
  return last_error();
}
