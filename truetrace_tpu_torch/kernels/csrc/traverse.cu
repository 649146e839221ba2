// CWBVH traversal, one thread per ray: closest hit and any hit.
//
// Replaces truetrace_tpu/kernels/cwbvh_wavefront.py closest_hit_wavefront
// (:861) and any_hit_wavefront (:927), whose per-ray while_loop (:755)
// torch cannot express on the device, and carries the work of the Pallas
// step_core (step_pallas.py:120) through the shared core in
// cwbvh_core.cuh. The design is the reference renderer's own GPU one
// (SURVEY.md 3.2, IntersectionKernels.compute:155-252): each thread walks
// the unified table (expanded 26-word node rows zero-padded to 10K words,
// then leaf rows) with a private stack of (hits, chim, bleaf) groups.
// The TPU's lock-step machinery (shift-register stack planes, occupancy
// cascade, chunking) is not needed: a thread retires when its ray does.
//
// Per iteration, exactly as cwbvh_wavefront._step: pop a saved group when
// the current one is empty; pending leaf slots go first (row = base leaf
// row + rank of the slot among the leaf slots); otherwise descend into the
// next node slot (closest hit: near-to-far by the ray's octant; any hit:
// lowest set bit), saving the rest of the group. Any hit stops at its
// first accepted triangle.
//
// The stack is a ring of max_stack entries that reproduces the JAX shift
// register exactly, including its drop-the-deepest push on a full stack
// (unreachable while max_stack = tree depth + 1, as compile_scene sets).
//
// What bounds it on the H100: dependent row loads (one 40- or 240-byte
// row per iteration per ray, L2-resident for the 293k-triangle atrium) and
// divergence between rays of a warp. This first version has no shared-
// memory caching of the top levels and no persistent work queue.
#include "cwbvh_core.cuh"

namespace {

constexpr int kMaxStack = 32;
constexpr int kIterCap = 65536;   // cwbvh_wavefront._ITER_CAP

__device__ __forceinline__ uint32_t xor_permute8(uint32_t m, uint32_t v) {
  if (v & 1u) m = ((m & 0xAAu) >> 1) | ((m & 0x55u) << 1);
  if (v & 2u) m = ((m & 0xCCu) >> 2) | ((m & 0x33u) << 2);
  if (v & 4u) m = ((m & 0xF0u) >> 4) | ((m & 0x0Fu) << 4);
  return m;
}

template <bool kAnyHit>
__global__ void traverse_kernel(const uint32_t* __restrict__ table, int W,
                                int K, int C, int L, int S,
                                const float* __restrict__ ro,
                                const float* __restrict__ rd,
                                const float* __restrict__ t_max, int R,
                                float* __restrict__ out_t,
                                int* __restrict__ out_tri,
                                float* __restrict__ out_u,
                                float* __restrict__ out_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const tt::Ray r = tt::make_ray(ro + 3 * i, rd + 3 * i);
  const uint32_t oct = (r.d[0] < 0.0f ? 1u : 0u) | (r.d[1] < 0.0f ? 2u : 0u) |
                       (r.d[2] < 0.0f ? 4u : 0u);
  float t = t_max[i], u = 0.0f, v = 0.0f;
  int tri = -1;
  if (!(t > 1e-4f)) {
    // no triangle can pass th > 1e-4 && th < t: the result is a miss
    // (the dead lanes of the integrator, t_max = 0), so skip the walk
    out_t[i] = t;
    out_tri[i] = tri;
    out_u[i] = u;
    out_v[i] = v;
    return;
  }

  uint32_t hits, chim, bleaf;
  tt::decode_row(table, 1, r, t, hits, chim, bleaf);   // enter the root

  uint32_t st_h[kMaxStack], st_c[kMaxStack], st_b[kMaxStack];
  for (int k = 0; k < S; ++k) st_h[k] = st_c[k] = st_b[k] = 0u;
  int head = 0, sp = 0;

  for (int it = 0; it < kIterCap && (hits != 0u || sp > 0); ++it) {
    if (hits == 0u) {           // pop; the vacated slot becomes the bottom
      hits = st_h[head];
      chim = st_c[head];
      bleaf = st_b[head];
      st_h[head] = st_c[head] = st_b[head] = 0u;
      head = head + 1 == S ? 0 : head + 1;
      --sp;
      if (hits == 0u) continue;
    }
    const uint32_t leaf_bits = hits & 0xFFu;
    if (leaf_bits != 0u) {
      const uint32_t lsb = leaf_bits & (~leaf_bits + 1u);
      const int lrank = __popc((bleaf >> 24) & (lsb - 1u));
      int lrow = (int)(bleaf & 0x00FFFFFFu) + lrank;
      lrow = min(max(lrow, 0), L - 1);
      tt::moller_row(table + (size_t)(C + lrow) * W, 1, K, r, true,
                     !kAnyHit, t, tri, u, v);
      hits &= ~lsb;
    } else {
      const uint32_t node_bits = hits >> 24;
      int slot;
      uint32_t node_rest;
      if (kAnyHit) {
        const uint32_t lsb_n = node_bits & (~node_bits + 1u);
        slot = __popc(lsb_n - 1u);
        node_rest = node_bits & ~lsb_n;
      } else {
        const uint32_t pm = xor_permute8(node_bits, oct);
        const uint32_t lsb = pm & (~pm + 1u);
        slot = (__popc(lsb - 1u) ^ (int)oct) & 7;
        node_rest = node_bits & ~(1u << slot);
      }
      const uint32_t below = (chim >> 24) & ((1u << slot) - 1u);
      int child = (int)(chim & 0x00FFFFFFu) + __popc(below);
      child = min(max(child, 0), C - 1);
      uint32_t c_hits, c_chim, c_bleaf;
      tt::decode_row(table + (size_t)child * W, 1, r, t, c_hits, c_chim,
                     c_bleaf);
      if (node_rest != 0u) {    // push; a full stack drops its deepest entry
        head = head == 0 ? S - 1 : head - 1;
        st_h[head] = node_rest << 24;
        st_c[head] = chim;
        st_b[head] = bleaf;
        ++sp;
      }
      hits = c_hits;
      chim = c_chim;
      bleaf = c_bleaf;
    }
    if (kAnyHit && tri >= 0) {
      hits = 0u;
      sp = 0;
    }
  }
  out_t[i] = t;
  out_tri[i] = tri;
  out_u[i] = u;
  out_v[i] = v;
}

}  // namespace

extern "C" int tt_traverse(const void* table, int W, int K, int C, int L,
                           int S, const void* ro, const void* rd,
                           const void* t_max, int R, int any_hit, void* out_t,
                           void* out_tri, void* out_u, void* out_v,
                           void* stream) {
  if (S < 1 || S > kMaxStack) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int block = 128;
  const int grid = (R + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* tb = static_cast<const uint32_t*>(table);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tm = static_cast<const float*>(t_max);
  if (any_hit) {
    traverse_kernel<true><<<grid, block, 0, s>>>(
        tb, W, K, C, L, S, o, d, tm, R, static_cast<float*>(out_t),
        static_cast<int*>(out_tri), static_cast<float*>(out_u),
        static_cast<float*>(out_v));
  } else {
    traverse_kernel<false><<<grid, block, 0, s>>>(
        tb, W, K, C, L, S, o, d, tm, R, static_cast<float*>(out_t),
        static_cast<int*>(out_tri), static_cast<float*>(out_u),
        static_cast<float*>(out_v));
  }
  return (int)cudaGetLastError();
}
