// CWBVH traversal core shared by the traversal kernel (traverse.cu) and
// the standalone step_core launch (step_core.cu).
//
// Replaces the per-iteration work of truetrace_tpu/kernels/step_pallas.py
// step_core (the Pallas kernel at :120) and of cwbvh_wavefront._step
// (:622-754): the Moller-Trumbore tests of one packed leaf row, and the
// 8-slot conservative-bf16 slab decode of one expanded node row.
//
// Rows are read as row[k * stride]: stride 1 for a row of the unified
// table (or a copy of it in registers), stride R for the lane-major
// [32, R] block of step_core. The traversal loads whole rows into
// registers with 16- or 8-byte loads (load_row) and runs the same
// arithmetic on the copy.
//
// Rounding contract: the file is compiled with --fmad=false, so every
// mul and add rounds on its own, exactly as the plain PyTorch version
// does. XLA:CPU (the JAX reference the tests run) contracts the Moller
// mul-adds into FMAs; those, and only those, are written as __fmaf_rn in
// the order XLA's LLVM backend forms them:
//   a*b - c*d         -> fma(a, b, -(c*d))
//   a*b + c*d + e*g   -> fma(e, g, fma(a, b, c*d))
// so t/tri/u/v are bitwise those of the JAX package and of the plain
// version (kernels/cwbvh_wavefront.py _moller). Reciprocals are
// __frcp_rn, the correctly rounded 1/x, which gives the bits of the IEEE
// division 1.0f / x in fewer instructions.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace tt {

struct Ray {
  float o[3], d[3], inv[3];
};

__device__ __forceinline__ float bits_f(uint32_t u) { return __uint_as_float(u); }

// NaN-propagating min/max, the semantics of jnp/torch maximum/minimum,
// in one instruction each (PTX min.NaN / max.NaN, sm_80 and later). A NaN
// result only ever feeds the slab compares, which it fails whatever its
// payload.
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// a*b - c*d as XLA:CPU contracts it
__device__ __forceinline__ float msub(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}
// a*b + c*d + e*g as XLA:CPU contracts it
__device__ __forceinline__ float dot3(float a, float b, float c, float d,
                                      float e, float g) {
  return __fmaf_rn(e, g, __fmaf_rn(a, b, c * d));
}

// One Moller-Trumbore test: b holds p0, e1, e2 (9 words at `stride`).
// True where the triangle is hit in (1e-4, t_best); th, u, v are set
// either way.
__device__ __forceinline__ bool moller(const uint32_t* b, int stride,
                                       const Ray& r, float t_best,
                                       float& th, float& u, float& v) {
  const float p0x = bits_f(b[0]), p0y = bits_f(b[stride]),
              p0z = bits_f(b[2 * stride]);
  const float e1x = bits_f(b[3 * stride]), e1y = bits_f(b[4 * stride]),
              e1z = bits_f(b[5 * stride]);
  const float e2x = bits_f(b[6 * stride]), e2y = bits_f(b[7 * stride]),
              e2z = bits_f(b[8 * stride]);
  const float rdx = r.d[0], rdy = r.d[1], rdz = r.d[2];
  const float pvx = msub(rdy, e2z, rdz, e2y);
  const float pvy = msub(rdz, e2x, rdx, e2z);
  const float pvz = msub(rdx, e2y, rdy, e2x);
  const float det = dot3(e1x, pvx, e1y, pvy, e1z, pvz);
  const float inv_det = __frcp_rn(fabsf(det) < 1e-12f ? 1e-12f : det);
  const float tvx = r.o[0] - p0x, tvy = r.o[1] - p0y, tvz = r.o[2] - p0z;
  u = dot3(tvx, pvx, tvy, pvy, tvz, pvz) * inv_det;
  const float qvx = msub(tvy, e1z, tvz, e1y);
  const float qvy = msub(tvz, e1x, tvx, e1z);
  const float qvz = msub(tvx, e1y, tvy, e1x);
  v = dot3(rdx, qvx, rdy, qvy, rdz, qvz) * inv_det;
  th = dot3(e2x, qvx, e2y, qvy, e2z, qvz) * inv_det;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > 1e-4f &&
         th < t_best && fabsf(det) > 1e-12f;
}

// One test that updates the running closest hit.
__device__ __forceinline__ void tri_test(const uint32_t* b, int stride,
                                         int tri_id, const Ray& r,
                                         bool leaf_lane, bool write_uv,
                                         float& t_best, int& tri_best,
                                         float& u_best, float& v_best) {
  float th, u, v;
  const bool ok = moller(b, stride, r, t_best, th, u, v);
  if (ok && leaf_lane && tri_id >= 0) {
    t_best = th;
    tri_best = tri_id;
    if (write_uv) {
      u_best = u;
      v_best = v;
    }
  }
}

// <= K Moller-Trumbore tests against one leaf row: 9K triangle words
// (p0, e1, e2 per triangle) then K triangle ids (-1 = padding).
__device__ __forceinline__ void moller_row(const uint32_t* row, int stride,
                                           int K, const Ray& r,
                                           bool leaf_lane, bool write_uv,
                                           float& t_best, int& tri_best,
                                           float& u_best, float& v_best) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    tri_test(row + (size_t)(9 * j) * stride, stride,
             (int)row[(size_t)(9 * K + j) * stride], r, leaf_lane, write_uv,
             t_best, tri_best, u_best, v_best);
}

// Slab-test the 8 children of one expanded node row (26 words: per axis
// 4 lo words + 4 hi words of two bf16 bounds each, then chim, bleaf)
// against t_best. Returns the hits group: bit j = leaf slot j, bit 24+j =
// internal slot j.
__device__ __forceinline__ void decode_row(const uint32_t* row, int stride,
                                           const Ray& r, float t_best,
                                           uint32_t& hits, uint32_t& chim,
                                           uint32_t& bleaf) {
  chim = row[(size_t)24 * stride];
  bleaf = row[(size_t)25 * stride];
  const uint32_t imask = chim >> 24;
  const uint32_t occ = imask | (bleaf >> 24);
  uint32_t h = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int wi = j >> 1;
    const int lo_sh = 16 * (j & 1);
    float tn = -INFINITY, tf = INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const uint32_t lo_w = row[(size_t)(8 * a + wi) * stride];
      const uint32_t hi_w = row[(size_t)(8 * a + 4 + wi) * stride];
      const float lo = bits_f(((lo_w >> lo_sh) & 0xFFFFu) << 16);
      const float hi = bits_f(((hi_w >> lo_sh) & 0xFFFFu) << 16);
      const float t0 = (lo - r.o[a]) * r.inv[a];
      const float t1 = (hi - r.o[a]) * r.inv[a];
      tn = nmax(tn, nmin(t0, t1));
      tf = nmin(tf, nmax(t0, t1));
    }
    const bool hit = (tf >= nmax(tn, 0.0f)) && (tn < t_best) &&
                     ((occ >> j) & 1u);
    if (hit) h |= ((imask >> j) & 1u) ? (1u << (24 + j)) : (1u << j);
  }
  hits = h;
}

// The full step core (step_pallas.step_core): Moller block, then the
// decode against the post-Moller t_best.
__device__ __forceinline__ void step_core_dev(const uint32_t* row, int stride,
                                              int K, const Ray& r,
                                              bool leaf_lane, bool write_uv,
                                              float& t, int& tri, float& u,
                                              float& v, uint32_t& hits,
                                              uint32_t& chim,
                                              uint32_t& bleaf) {
  moller_row(row, stride, K, r, leaf_lane, write_uv, t, tri, u, v);
  decode_row(row, stride, r, t, hits, chim, bleaf);
}

// Ray setup of cwbvh_wavefront._init_state: the 1e-12 floors keep inv_rd
// finite.
__device__ __forceinline__ Ray make_ray(const float* o, const float* d) {
  Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = o[a];
    r.d[a] = d[a];
    const float dd = fabsf(d[a]) < 1e-12f ? (d[a] >= 0.0f ? 1e-12f : -1e-12f)
                                          : d[a];
    r.inv[a] = __frcp_rn(dd);
  }
  return r;
}

// ---------------------------------------------------------------------------
// Whole-row loads for the traversal: V words (16 bytes for V = 4, 8 bytes
// for V = 2) per load through the read-only data path. A row of the
// unified table is 10K words, so V = 4 needs K even (rows start 16-byte
// aligned) and an odd K takes V = 2; the launcher picks V from K and
// the wrapper checks the table pointer's alignment.
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void ldg_vec(const uint32_t* p, uint32_t* w) {
  if constexpr (V == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
    static_assert(V == 2, "rows are read 16 or 8 bytes at a time");
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = q.x;
    w[1] = q.y;
  }
}

// Words [0, N) of a row into registers (N a multiple of V).
template <int V, int N>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ row,
                                         uint32_t (&w)[N]) {
  static_assert(N % V == 0, "a row load is a whole number of vectors");
#pragma unroll
  for (int c = 0; c < N; c += V) ldg_vec<V>(row + c, w + c);
}

// Node row: its 26 words in 7 16-byte loads (the 2 words past them are
// the row's zero padding) or 13 8-byte loads.
template <int V>
__device__ __forceinline__ void decode_node(const uint32_t* __restrict__ row,
                                            const Ray& r, float t_best,
                                            uint32_t& hits, uint32_t& chim,
                                            uint32_t& bleaf) {
  uint32_t w[(26 + V - 1) / V * V];
  load_row<V>(row, w);
  decode_row(w, 1, r, t_best, hits, chim, bleaf);
}

// Leaf row of K triangles: all 10K words in 10K/V loads, then the tests
// of the triangles whose id is not padding (a padding id never passes
// the test, so skipping it changes no bit).
template <int K, int V>
__device__ __forceinline__ void test_leaf(const uint32_t* __restrict__ row,
                                          const Ray& r, bool write_uv,
                                          float& t_best, int& tri_best,
                                          float& u_best, float& v_best) {
  uint32_t w[10 * K];
  load_row<V>(row, w);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int id = (int)w[9 * K + j];
    if (id >= 0)
      tri_test(w + 9 * j, 1, id, r, true, write_uv, t_best, tri_best,
               u_best, v_best);
  }
}

// Leaf row of K triangles for the transmittance query: every triangle
// hit in (1e-4, t_max) multiplies the throughput tp by its shadow tint
// tint[id] (T rows of 3), in slot order, channel by channel; t_max is
// not shortened.
template <int K, int V>
__device__ __forceinline__ void transmit_leaf(
    const uint32_t* __restrict__ row, const Ray& r, float t_max,
    const float* __restrict__ tint, int T, float (&tp)[3]) {
  uint32_t w[10 * K];
  load_row<V>(row, w);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int id = (int)w[9 * K + j];
    float th, u, v;
    if (id >= 0 && moller(w + 9 * j, 1, r, t_max, th, u, v)) {
      const float* c = tint + 3 * (size_t)min(id, T - 1);
      tp[0] = tp[0] * __ldg(c);
      tp[1] = tp[1] * __ldg(c + 1);
      tp[2] = tp[2] * __ldg(c + 2);
    }
  }
}

}  // namespace tt
