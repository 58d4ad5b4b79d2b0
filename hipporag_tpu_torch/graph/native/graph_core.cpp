// graph_core: native graph-compilation kernel for hipporag_tpu_torch (a
// copy of the JAX package's hipporag_tpu/graph/native/graph_core.cpp).
//
// Replaces the igraph C core's role in the reference framework (graph
// object maintenance + prpack PPR solver, reference HippoRAG.py:13-14,
// 1736-1743) with the two host-side hot paths this framework needs:
//
//  1. coo_compile: symmetrize + dedup-accumulate + dst-major sort +
//     src-strength normalization of the edge dictionary, producing the
//     padded COO arrays consumed by the device PPR kernel. This is the
//     host bottleneck when (re)compiling multi-million-edge graphs during
//     incremental indexing.
//  2. ppr_serial: an exact-semantics serial power-iteration PPR used as
//     a host-side verifier / CPU fallback (the prpack equivalent).
//
// Exposed as a C ABI for ctypes; no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Accumulate directed entries (a, b, w) into a symmetric multimap:
// A[a,b] += w and A[b,a] += w, dropping self loops. Returns the number of
// unique directed (src, dst) pairs written to the output arrays when
// out_* are non-null; call once with out_* = nullptr to size the output.
//
// Output entries are sorted by (dst, src) and weights are normalized by
// source strength when normalize != 0 (w_out = w / strength[src]).
// strength_out (size num_nodes, optional) receives raw strengths.
int64_t coo_compile(const int32_t* src, const int32_t* dst, const float* w,
                    int64_t num_entries, int32_t num_nodes, int normalize,
                    int32_t* src_out, int32_t* dst_out, float* w_out,
                    double* strength_out) {
  // Key packs (dst, src) so the natural sort order of the map keys after
  // extraction matches the required dst-major order.
  std::unordered_map<uint64_t, double> acc;
  acc.reserve(static_cast<size_t>(num_entries) * 2 + 16);
  for (int64_t i = 0; i < num_entries; ++i) {
    int32_t a = src[i], b = dst[i];
    if (a == b || a < 0 || b < 0 || a >= num_nodes || b >= num_nodes) continue;
    double wi = static_cast<double>(w[i]);
    acc[(static_cast<uint64_t>(b) << 32) | static_cast<uint32_t>(a)] += wi;
    acc[(static_cast<uint64_t>(a) << 32) | static_cast<uint32_t>(b)] += wi;
  }
  int64_t n = static_cast<int64_t>(acc.size());
  if (src_out == nullptr) return n;

  std::vector<std::pair<uint64_t, double>> items(acc.begin(), acc.end());
  std::sort(items.begin(), items.end(),
            [](const auto& x, const auto& y) { return x.first < y.first; });

  std::vector<double> strength(num_nodes, 0.0);
  for (const auto& kv : items) {
    int32_t s = static_cast<int32_t>(kv.first & 0xffffffffu);
    strength[s] += kv.second;
  }
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = items[i].first;
    int32_t s = static_cast<int32_t>(key & 0xffffffffu);
    int32_t d = static_cast<int32_t>(key >> 32);
    src_out[i] = s;
    dst_out[i] = d;
    double wi = items[i].second;
    w_out[i] = static_cast<float>(normalize ? wi / strength[s] : wi);
  }
  if (strength_out != nullptr) {
    std::memcpy(strength_out, strength.data(), sizeof(double) * num_nodes);
  }
  return n;
}

// Serial personalized PageRank with igraph/prpack-equivalent semantics:
// weighted undirected walk (edges given as normalized dst-major COO),
// teleport (1-d) + dangling mass to the L1-normalized reset vector.
// Returns the number of iterations performed.
int32_t ppr_serial(const int32_t* src, const int32_t* dst, const float* w_norm,
                   int64_t num_edges, const double* dangling, int32_t num_nodes,
                   const double* reset, double damping, int32_t max_iters,
                   double tol, double* out) {
  std::vector<double> r(num_nodes), p(num_nodes), next(num_nodes);
  double rsum = 0.0;
  for (int32_t i = 0; i < num_nodes; ++i) {
    double v = reset[i];
    if (!(v > 0)) v = 0.0;  // drop negatives and NaN
    r[i] = v;
    rsum += v;
  }
  if (rsum > 0) {
    for (int32_t i = 0; i < num_nodes; ++i) r[i] /= rsum;
  } else {
    for (int32_t i = 0; i < num_nodes; ++i) r[i] = 1.0 / num_nodes;
  }
  p = r;

  int32_t it = 0;
  for (; it < max_iters; ++it) {
    std::fill(next.begin(), next.end(), 0.0);
    for (int64_t e = 0; e < num_edges; ++e) {
      next[dst[e]] += static_cast<double>(w_norm[e]) * p[src[e]];
    }
    double dm = 0.0;
    for (int32_t i = 0; i < num_nodes; ++i) dm += dangling[i] * p[i];
    double err = 0.0;
    for (int32_t i = 0; i < num_nodes; ++i) {
      double v = (1.0 - damping) * r[i] + damping * (next[i] + dm * r[i]);
      err = std::max(err, std::abs(v - p[i]));
      p[i] = v;
    }
    if (err < tol) {
      ++it;
      break;
    }
  }
  std::memcpy(out, p.data(), sizeof(double) * num_nodes);
  return it;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// Bucketed-ELL packing (host hot path of ops/pagerank.ell_from_coo).
//
// Input edges must be the real (weight != 0) entries sorted by dst.
// Two-call protocol like coo_compile:
//   pass 1 (out pointers null): writes per-bucket real row counts into
//     bucket_rows[n_widths], hub chunk rows into hub_rows[0] and hub
//     node count into hub_count[0]; returns 0.
//   pass 2: caller passes zero-initialized concatenated idx/wgt buffers
//     laid out bucket-by-bucket with row capacities bucket_caps[i]
//     (rows padded to capacity), hub buffers with capacity hub_row_cap,
//     hub_seg (prefilled with n_hub_cap), and local_inv (length
//     node_cap) which receives the node -> concat(parts) row map
//     using the layout [bucket blocks by cap..., n_hub_cap hub slots,
//     zero row]. Returns 0 on success.
// ---------------------------------------------------------------------
int32_t ell_pack(const int32_t* src, const int32_t* dst, const float* w,
                 int64_t num_edges, int32_t node_cap,
                 const int32_t* widths, int32_t n_widths, int32_t hub_width,
                 int64_t* bucket_rows, int64_t* hub_rows, int64_t* hub_count,
                 const int64_t* bucket_caps, int64_t hub_row_cap,
                 int64_t n_hub_cap, int32_t* idx_out, float* wgt_out,
                 int32_t* hub_idx_out, float* hub_wgt_out,
                 int32_t* hub_seg_out, int32_t* local_inv_out) {
  // validate ids up front (sibling coo_compile drops bad entries; here the
  // layout depends on them, so reject and let the caller fall back)
  for (int64_t e = 0; e < num_edges; ++e) {
    if (src[e] < 0 || src[e] >= node_cap || dst[e] < 0 || dst[e] >= node_cap)
      return -1;
  }
  std::vector<int64_t> indeg(node_cap, 0);
  for (int64_t e = 0; e < num_edges; ++e) indeg[dst[e]] += 1;
  std::vector<int64_t> starts(node_cap + 1, 0);
  for (int32_t v = 0; v < node_cap; ++v) starts[v + 1] = starts[v] + indeg[v];

  auto bucket_of = [&](int64_t d) -> int32_t {
    // d > 0; returns bucket index or n_widths for hubs
    for (int32_t b = 0; b < n_widths; ++b) {
      if (d <= widths[b]) return b;
    }
    return n_widths;
  };

  if (idx_out == nullptr) {  // sizing pass
    std::vector<int64_t> rows(n_widths, 0);
    int64_t hrows = 0, hcount = 0;
    for (int32_t v = 0; v < node_cap; ++v) {
      int64_t d = indeg[v];
      if (d == 0) continue;
      int32_t b = bucket_of(d);
      if (b < n_widths) {
        rows[b] += 1;
      } else {
        hcount += 1;
        hrows += (d + hub_width - 1) / hub_width;
      }
    }
    for (int32_t b = 0; b < n_widths; ++b) bucket_rows[b] = rows[b];
    hub_rows[0] = hrows;
    hub_count[0] = hcount;
    return 0;
  }

  // fill pass
  std::vector<int64_t> bucket_base(n_widths, 0);  // element offsets
  std::vector<int64_t> row_base(n_widths, 0);     // concat row offsets
  int64_t elem_off = 0, row_off = 0;
  for (int32_t b = 0; b < n_widths; ++b) {
    bucket_base[b] = elem_off;
    row_base[b] = row_off;
    elem_off += bucket_caps[b] * widths[b];
    row_off += bucket_caps[b];
  }
  const int64_t hub_slot_base = row_off;
  const int32_t zero_row = static_cast<int32_t>(hub_slot_base + n_hub_cap);

  std::vector<int64_t> rows_used(n_widths, 0);
  int64_t hub_row = 0, hub_idx_n = 0;
  for (int32_t v = 0; v < node_cap; ++v) {
    local_inv_out[v] = zero_row;
    int64_t d = indeg[v];
    if (d == 0) continue;
    int64_t s = starts[v];
    int32_t b = bucket_of(d);
    if (b < n_widths) {
      int64_t row = rows_used[b]++;
      int64_t base = bucket_base[b] + row * widths[b];
      std::memcpy(idx_out + base, src + s, sizeof(int32_t) * d);
      std::memcpy(wgt_out + base, w + s, sizeof(float) * d);
      local_inv_out[v] = static_cast<int32_t>(row_base[b] + row);
    } else {
      int64_t chunks = (d + hub_width - 1) / hub_width;
      for (int64_t c = 0; c < chunks; ++c) {
        int64_t len = std::min<int64_t>(hub_width, d - c * hub_width);
        int64_t base = (hub_row + c) * hub_width;
        std::memcpy(hub_idx_out + base, src + s + c * hub_width,
                    sizeof(int32_t) * len);
        std::memcpy(hub_wgt_out + base, w + s + c * hub_width,
                    sizeof(float) * len);
        hub_seg_out[hub_row + c] = static_cast<int32_t>(hub_idx_n);
      }
      local_inv_out[v] = static_cast<int32_t>(hub_slot_base + hub_idx_n);
      hub_row += chunks;
      hub_idx_n += 1;
    }
  }
  (void)hub_row_cap;
  return 0;
}

}  // extern "C"
