// BVH2 traversal on the H100: closest hit and any hit, one ray a thread,
// its stack in local memory.
//
// Replaces truetrace_tpu/kernels/traverse_ref.py closest_hit_bvh2 (:119)
// and any_hit_bvh2 (:130), whose per-ray while_loop (`_traverse`,
// :39-115) torch cannot express on the device: the traversal of the JAX
// package's default build (compile_scene without the CWBVH) and of
// RenderConfig()'s default traversal="bvh2". Each thread walks one ray
// in exactly the order of `_traverse`: the root pre-pushed; pop the top
// node; a leaf (count > 0) tests triangles j = 0..max_leaf-1 with j <
// count, ids clamped to T - 1, each against the closest t so far (t <
// t_best strictly, so the first triangle tested wins a tie); an internal
// node slab-tests its children left and left + 1 (ids clamped to N - 1)
// against that t and pushes the far child first, then the near one (the
// first child is near on equal entry distances, d0 <= d1), or the one
// child hit. The any hit, after a leaf in which it found a triangle,
// empties its stack. A push writes slot min(sp, max_stack - 1) and sp
// counts on; a pop reads slot sp - 1 clamped to max_stack - 1 (XLA's
// gather clamps an index out of range), so an overflowing stack behaves
// as the JAX one. Dead lanes (t_max = 0) walk too: the root is popped
// without a slab test and a child whose box holds the origin has t_near
// < 0 < t_max, so they descend as in the JAX loop and hit nothing.
//
// What bounds it on the H100. chip_smoke.py counts each ray's work on the
// plain version (kernels/traverse_ref.py `_traverse_plain`): pops, slab
// tests (OPS_BOX = 25 f32 operations each) and triangle tests
// (OPS_TRI_BVH2 = 58, an FMA counting 2), and
// the distinct nodes (left and count, 16 bytes), child boxes (24 bytes)
// and triangles (36 bytes) the live rays touch, read once, besides 28
// bytes a live ray in and 16 (closest) or 4 (any) out. A dead lane
// (t_max <= 1e-4) can only miss: it is charged its t_max in and its miss
// out, and none of its walk. At the atrium's depth a ray
// pops tens of nodes, each two slab tests, so operations bound it, as
// they bound the CWBVH traversal.
//
// The design is the simple one: one thread a ray, blocks of 128, every
// node, box and triangle word through the read-only path (__ldg), the
// stack an array of kMaxStack ints in local memory of which max_stack are
// used. A warp lasts as long as its longest ray and runs a leaf and an
// internal step whenever its lanes disagree; the persistent warps, ray
// pull and wide row loads of traverse.cu are later work.
//
// Rounding contract: built with --fmad=false, so every mul and add
// rounds on its own, as in the plain PyTorch version. XLA:CPU contracts
// this loop's mul-adds (read from its optimised IR and machine code):
// each cross-product component a*b - c*d as fma(a, b, -(c*d)), and each
// dot product, a reduce from 0, as fma(a2, b2, fma(a1, b1, fma(a0, b0,
// 0))); those, and only those, are __fmaf_rn here (core/math.py
// `ray_tri_fma`). The slab test has no mul-add; its minima and maxima
// propagate NaN, as XLA's do. Reciprocals are IEEE (__frcp_rn). t, tri, u
// and v are bitwise the plain version's.
#include <cstdint>

#include "cwbvh_core.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStack = 64;   // traverse_ref.MAX_STACK

struct Bvh {
  const float* __restrict__ box;         // [N, 2, 3]: min, max
  const int64_t* __restrict__ left;      // [N]
  const int64_t* __restrict__ count;     // [N]
  int N;
  const float* __restrict__ p0;          // [T, 3], leaf order
  const float* __restrict__ e1;
  const float* __restrict__ e2;
  int T;
};

__device__ __forceinline__ void load3(const float* __restrict__ p, int i,
                                      float* v) {
  v[0] = __ldg(p + 3 * i);
  v[1] = __ldg(p + 3 * i + 1);
  v[2] = __ldg(p + 3 * i + 2);
}

// a*b - c*d as XLA:CPU contracts a cross-product component
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

// the dot product as XLA:CPU contracts jnp.sum(a * b, -1)
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fmaf_rn(a[2], b[2],
                   __fmaf_rn(a[1], b[1], __fmaf_rn(a[0], b[0], 0.0f)));
}

// the slab test of box `c` against the ray: hit, and t_near in *tn
__device__ __forceinline__ bool slab(const Bvh& b, int c, const float* o,
                                     const float* inv, float t_best,
                                     float* tn_out) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(b.box + 6 * c + a);
    const float hi = __ldg(b.box + 6 * c + 3 + a);
    const float t0 = (lo - o[a]) * inv[a];
    const float t1 = (hi - o[a]) * inv[a];
    const float smin = tt::nmin(t0, t1), smax = tt::nmax(t0, t1);
    tn = a == 0 ? smin : tt::nmax(tn, smin);
    tf = a == 0 ? smax : tt::nmin(tf, smax);
  }
  *tn_out = tn;
  return (tf >= tt::nmax(tn, 0.0f)) && (tn < t_best);
}

template <bool Any>
__global__ void __launch_bounds__(kBlock)
bvh2_kernel(Bvh b, const float* __restrict__ ro,
            const float* __restrict__ rd, const float* __restrict__ t_max,
            int R, int max_leaf, int S, float* __restrict__ out_t,
            int* __restrict__ out_tri, float* __restrict__ out_u,
            float* __restrict__ out_v) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= R) return;
  float o[3], d[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = ro[3 * i + a];
    d[a] = rd[3 * i + a];
    const float dd =
        fabsf(d[a]) < 1e-12f ? (d[a] >= 0.0f ? 1e-12f : -1e-12f) : d[a];
    inv[a] = __frcp_rn(dd);
  }
  float t_best = t_max[i], u_best = 0.0f, v_best = 0.0f;
  int tri_best = -1;
  int stack[kMaxStack];
  stack[0] = 0;
  int sp = 1;
  while (sp > 0) {
    --sp;
    const int node = stack[min(sp, S - 1)];
    const int nleft = (int)__ldg(b.left + node);
    const int ncount = (int)__ldg(b.count + node);
    if (ncount > 0) {
      for (int j = 0; j < max_leaf && j < ncount; ++j) {
        const int tid = min(max(nleft + j, 0), b.T - 1);
        float p[3], e1[3], e2[3];
        load3(b.p0, tid, p);
        load3(b.e1, tid, e1);
        load3(b.e2, tid, e2);
        const float pv[3] = {cross1(d[1], e2[2], d[2], e2[1]),
                             cross1(d[2], e2[0], d[0], e2[2]),
                             cross1(d[0], e2[1], d[1], e2[0])};
        const float det = dot3(e1, pv);
        const float inv_det = __frcp_rn(fabsf(det) < 1e-12f ? 1e-12f : det);
        const float tv[3] = {o[0] - p[0], o[1] - p[1], o[2] - p[2]};
        const float u = dot3(tv, pv) * inv_det;
        const float qv[3] = {cross1(tv[1], e1[2], tv[2], e1[1]),
                             cross1(tv[2], e1[0], tv[0], e1[2]),
                             cross1(tv[0], e1[1], tv[1], e1[0])};
        const float v = dot3(d, qv) * inv_det;
        const float t = dot3(e2, qv) * inv_det;
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-4f &&
            t < t_best && fabsf(det) > 1e-12f) {
          t_best = t;
          tri_best = tid;
          u_best = u;
          v_best = v;
        }
      }
      if (Any && tri_best >= 0) break;
    } else {
      const int c0 = min(max(nleft, 0), b.N - 1);
      const int c1 = min(max(nleft + 1, 0), b.N - 1);
      float d0, d1;
      const bool h0 = slab(b, c0, o, inv, t_best, &d0);
      const bool h1 = slab(b, c1, o, inv, t_best, &d1);
      const bool near0 = d0 <= d1;
      if (h0 && h1) {
        stack[min(sp, S - 1)] = near0 ? c1 : c0;
        ++sp;
        stack[min(sp, S - 1)] = near0 ? c0 : c1;
        ++sp;
      } else if (h0 || h1) {
        stack[min(sp, S - 1)] = h0 ? c0 : c1;
        ++sp;
      }
    }
  }
  out_tri[i] = tri_best;
  if (Any) return;
  out_t[i] = t_best;
  out_u[i] = u_best;
  out_v[i] = v_best;
}

}  // namespace

// The closest (any = 0) or any hit (any = 1) of R rays ro/rd [R,3] before
// t_max [R] over the BVH2 box [N,2,3], left / count [N] (int64) and the
// triangles p0/e1/e2 [T,3], leaves of at most max_leaf triangles, stacks
// of max_stack (1..64) entries. Closest: t, tri, u, v [R]; any: tri [R]
// (>= 0 where blocked), the others may be null.
extern "C" int tt_bvh2(const void* box, const void* left, const void* count,
                       int N, const void* p0, const void* e1, const void* e2,
                       int T, const void* ro, const void* rd,
                       const void* t_max, int R, int max_leaf, int max_stack,
                       int any, void* t, void* tri, void* u, void* v,
                       void* stream) {
  if (N < 1 || T < 1 || max_leaf < 1 || max_stack < 1 ||
      max_stack > kMaxStack)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  Bvh b{static_cast<const float*>(box), static_cast<const int64_t*>(left),
        static_cast<const int64_t*>(count), N,
        static_cast<const float*>(p0), static_cast<const float*>(e1),
        static_cast<const float*>(e2), T};
  const int grid = (R + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tm = static_cast<const float*>(t_max);
  if (any)
    bvh2_kernel<true><<<grid, kBlock, 0, s>>>(
        b, o, d, tm, R, max_leaf, max_stack, nullptr,
        static_cast<int*>(tri), nullptr, nullptr);
  else
    bvh2_kernel<false><<<grid, kBlock, 0, s>>>(
        b, o, d, tm, R, max_leaf, max_stack, static_cast<float*>(t),
        static_cast<int*>(tri), static_cast<float*>(u),
        static_cast<float*>(v));
  return (int)cudaGetLastError();
}
