// BVH2 traversal on the H100: closest hit and any hit, one ray per lane
// at a time, in persistent warps that pull rays from a shared counter.
//
// Replaces truetrace_tpu/kernels/traverse_ref.py closest_hit_bvh2 (:119)
// and any_hit_bvh2 (:130), whose per-ray while_loop (`_traverse`,
// :39-115) torch cannot express on the device: the traversal of the JAX
// package's default build (compile_scene without the CWBVH) and of
// RenderConfig()'s default traversal="bvh2". Each ray walks in exactly
// the order of `_traverse`: the root pre-pushed; pop the top node; a leaf
// (count > 0) tests triangles j = 0..max_leaf-1 with j < count, ids
// clamped to T - 1, each against the closest t so far (t < t_best
// strictly, so the first triangle tested wins a tie); an internal node
// slab-tests its children left and left + 1 (ids clamped to N - 1)
// against that t and pushes the far child first, then the near one (the
// first child is near on equal entry distances, d0 <= d1), or the one
// child hit. The any hit, after a leaf in which it found a triangle,
// empties its stack. A push writes slot min(sp, max_stack - 1) and sp
// counts on; a pop reads slot sp - 1 clamped to max_stack - 1 (XLA's
// gather clamps an index out of range), so an overflowing stack behaves
// as the JAX one.
//
// The table (kernels/traverse_ref.py pack_bvh2_table, cached on the
// scene): N + 1 pair rows of 16 words, then T triangle rows of 12. Pair
// row r holds the boxes of nodes c0 = min(r, N - 1) and c1 = min(r + 1,
// N - 1) (min, max; 6 words each), then each one's stack entry (left,
// count); row N is the pair (0, 0) that a negative `left` clamps to. A
// node's entry is (left, count) for a leaf and (its children's pair row,
// 0) for an internal node, so a popped entry names the row to read. A
// triangle row is p0, e1, e2 and three words of padding.
//
// What bounds it on the H100. chip_smoke.py counts each ray's work on the
// plain version (kernels/traverse_ref.py `_traverse_plain`): pops, slab
// tests (OPS_BOX = 25 f32 operations each) and triangle tests
// (OPS_TRI_BVH2 = 58, an FMA counting 2), and the distinct nodes (left
// and count, 16 bytes), child boxes (24 bytes) and triangles (36 bytes)
// the live rays touch, read once, besides 28 bytes a live ray in and 16
// (closest) or 4 (any) out. A dead lane (t_max <= 1e-4) can only miss:
// it is charged its t_max in and its miss out. At the atrium's depth a
// ray pops tens of nodes, each two slab tests, so operations bound it.
// The kernel is far from that bound, and not for the chain of dependent
// reads a pop makes: on the default-build frame's bounce 0
// (scripts/torch_bvh2_ab.py, H100 80GB HBM3 at 700 W) a warp trip of the
// first version took about 3,700 cycles, against 290 for one dependent
// read through L2, and reading rows ahead, or both children's rows at
// once, shortened the chain, cost resident warps and was slower.
//
// The design, element by element (PERF.md has what each bought in the
// A/B's turns):
//
// * Packed rows, one dependent read a pop. A stack entry carries the
//   child's (left, count), read with its box from its parent's pair row,
//   so a pop reads the next pair row straight away, in four 16-byte
//   loads; the first version read the stack slot, then left and count,
//   then twelve box words. A triangle is three 16-byte loads.
// * The stack's top in a register, and its slot stored only where a
//   later pop reads it. The pop right after a push takes the pushed
//   entry from a register. A slot below S - 1 is read only by the pop
//   that takes the entry pushed into it, and that pop is this one, so
//   the near (or only) child's store is needed only when a later pop can
//   read slot S - 1 again without a push in between: when sp >= S after
//   the far child's push. Then it is stored, and under overflow it
//   overwrites the far child there, as in the JAX loop. The stores to
//   local memory cost more than any other part of the loop.
// * Dead lanes retire at fetch. A lane with !(t_max > 1e-4) (NaN
//   included) can accept no triangle (th > 1e-4 && th < t_max): it
//   writes t_max (its own bits), tri -1, u = v = 0 and never walks.
// * Persistent warps and a ray pull, as traverse.cu has them: the grid is
//   the resident blocks per SM times the SM count, and a warp refills
//   its idle lanes, once tt::kRefillMin of them are idle, with one
//   atomicAdd on a ray counter.
// * One body a trip. Each trip of a warp's loop runs the leaf body, once
//   a quarter of its busy lanes want it, or else the internal body; the
//   others wait. A one-thread-a-ray loop runs both whenever its lanes
//   disagree; under a majority rule the leaf lanes waited longer.
//
// Measured and not kept: the next row's loads issued at the end of the
// trip that learns it (64 registers, 8 blocks an SM); both children's
// rows read during the slab tests (96 registers, 5 blocks); at most 40
// or 32 registers (spills); the stack's first 4 to 16 slots in shared
// memory; both bodies once the pool is dry; a refill at 16 or 32 idle
// lanes; the leaf loop unrolled at the path's width; one ballot fewer a
// trip.
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
#include "traverse_common.cuh"

namespace {

using tt::kAll;
using tt::kBlock;
using tt::kRefillMin;

constexpr int kMaxStack = 64;   // traverse_ref.MAX_STACK

#ifdef TT_BVH2_COUNT
// The counting build (scripts/torch_bvh2_ab.py alone defines the macro):
// warp trips, lanes busy in them (holding a ray), lanes that ran the
// trip's body (each a pop), trips that ran both bodies (none here: the
// slot is the first version's), trips after the pool ran dry and their
// busy lanes.
__device__ unsigned long long tt_bvh2_counts[6];
#define TT_COUNT(busy, ran)                                             \
  if (lane == 0) {                                                      \
    atomicAdd(&tt_bvh2_counts[0], 1ull);                                \
    atomicAdd(&tt_bvh2_counts[1], (unsigned long long)__popc(busy));    \
    atomicAdd(&tt_bvh2_counts[2], (unsigned long long)(ran));           \
    if (!pool_open) {                                                   \
      atomicAdd(&tt_bvh2_counts[4], 1ull);                              \
      atomicAdd(&tt_bvh2_counts[5], (unsigned long long)__popc(busy));  \
    }                                                                   \
  }
#else
#define TT_COUNT(busy, ran)
#endif

// a*b - c*d as XLA:CPU contracts a cross-product component
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

// the dot product as XLA:CPU contracts jnp.sum(a * b, -1)
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fmaf_rn(a[2], b[2],
                   __fmaf_rn(a[1], b[1], __fmaf_rn(a[0], b[0], 0.0f)));
}

// the slab test of the box lo/hi against the ray: hit, and t_near in tn
__device__ __forceinline__ bool slab(const float* lo, const float* hi,
                                     const tt::Ray& r, float t_best,
                                     float& tn) {
  float tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - r.o[a]) * r.inv[a];
    const float t1 = (hi[a] - r.o[a]) * r.inv[a];
    const float smin = tt::nmin(t0, t1), smax = tt::nmax(t0, t1);
    tn = a == 0 ? smin : tt::nmax(tn, smin);
    tf = a == 0 ? smax : tt::nmin(tf, smax);
  }
  return (tf >= tt::nmax(tn, 0.0f)) && (tn < t_best);
}

// one triangle row (p0, e1, e2, pad) against the ray: accepted, and t, u,
// v in th, u, v
__device__ __forceinline__ bool ray_tri(const float4* __restrict__ row,
                                        const tt::Ray& r, float t_best,
                                        float& th, float& u, float& v) {
  const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
  const float p[3] = {a.x, a.y, a.z}, e1[3] = {a.w, b.x, b.y},
              e2[3] = {b.z, b.w, c.x};
  const float* d = r.d;
  const float pv[3] = {cross1(d[1], e2[2], d[2], e2[1]),
                       cross1(d[2], e2[0], d[0], e2[2]),
                       cross1(d[0], e2[1], d[1], e2[0])};
  const float det = dot3(e1, pv);
  const float inv_det = __frcp_rn(fabsf(det) < 1e-12f ? 1e-12f : det);
  const float tv[3] = {r.o[0] - p[0], r.o[1] - p[1], r.o[2] - p[2]};
  u = dot3(tv, pv) * inv_det;
  const float qv[3] = {cross1(tv[1], e1[2], tv[2], e1[1]),
                       cross1(tv[2], e1[0], tv[0], e1[2]),
                       cross1(tv[0], e1[1], tv[1], e1[0])};
  v = dot3(d, qv) * inv_det;
  th = dot3(e2, qv) * inv_det;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > 1e-4f &&
         th < t_best && fabsf(det) > 1e-12f;
}

template <bool Any>
__global__ void __launch_bounds__(kBlock)
bvh2_kernel(const float4* __restrict__ pairs,
            const float4* __restrict__ tris, int T,
            const float* __restrict__ ro, const float* __restrict__ rd,
            const float* __restrict__ t_max, int R, int max_leaf, int S,
            int* __restrict__ next_ray, float* __restrict__ out_t,
            int* __restrict__ out_tri, float* __restrict__ out_u,
            float* __restrict__ out_v) {
  const int lane = threadIdx.x & 31;
  int2 stack[kMaxStack];
  int ray = -1;              // this lane's ray, -1 while idle
  bool pool_open = true;     // the same on every lane of the warp
  tt::Ray r;
  float t = 0.0f, u = 0.0f, v = 0.0f;
  int tri = -1, sp = 0;
  int2 e = make_int2(0, 0);  // the popped entry: (left, count)

  while (true) {
    // refill the idle lanes with the next rays of the pool
    const uint32_t idle = __ballot_sync(kAll, ray < 0);
    if (pool_open && (idle == kAll || __popc(idle) >= kRefillMin)) {
      const int n = __popc(idle);
      int base = 0;
      if (lane == 0) base = atomicAdd(next_ray, n);
      base = __shfl_sync(kAll, base, 0);
      if (base + n >= R) pool_open = false;
      if (ray < 0) {
        const int i = base + __popc(idle & ((1u << lane) - 1u));
        if (i < R) {
          t = t_max[i];
          if (t > 1e-4f) {
            r = tt::make_ray(ro + 3 * i, rd + 3 * i);
            u = v = 0.0f;
            tri = -1;
            // the root, pre-pushed and popped: node 0's entry, the first
            // of pair row 0
            const float4 q = __ldg(pairs + 3);
            e = make_int2(__float_as_int(q.x), __float_as_int(q.y));
            sp = 0;
            ray = i;
          } else {
            // no triangle can pass th > 1e-4 && th < t: a miss, with no
            // walk (the dead lanes of the integrator, t_max = 0)
            out_tri[i] = -1;
            if (!Any) {
              out_t[i] = t;
              out_u[i] = 0.0f;
              out_v[i] = 0.0f;
            }
          }
        }
      }
    }
    const uint32_t busy = __ballot_sync(kAll, ray >= 0);
    if (busy == 0u) {
      if (!pool_open) break;
      continue;
    }

    // one body a trip: the leaf body once a quarter of the busy lanes
    // want it, else the internal body
    const bool want_leaf = ray >= 0 && e.y > 0;
    const int n_leaf = __popc(__ballot_sync(kAll, want_leaf));
    const bool run_leaf = 4 * n_leaf > __popc(busy);
    TT_COUNT(busy, run_leaf ? n_leaf : __popc(busy) - n_leaf);
    if (ray < 0 || want_leaf != run_leaf) continue;

    bool pop = true;           // take the next entry off the stack
    if (want_leaf) {
      const int n = min(max_leaf, e.y);
      for (int j = 0; j < n; ++j) {
        const int id = min(max(e.x + j, 0), T - 1);
        float th, uu, vv;
        if (ray_tri(tris + 3 * id, r, t, th, uu, vv)) {
          t = th;
          tri = id;
          u = uu;
          v = vv;
        }
      }
      if (Any && tri >= 0) sp = 0;
    } else {
      const float4* row = pairs + 4 * e.x;
      const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2),
                   q = __ldg(row + 3);
      const float lo0[3] = {a.x, a.y, a.z}, hi0[3] = {a.w, b.x, b.y},
                  lo1[3] = {b.z, b.w, c.x}, hi1[3] = {c.y, c.z, c.w};
      const int2 k0 = make_int2(__float_as_int(q.x), __float_as_int(q.y));
      const int2 k1 = make_int2(__float_as_int(q.z), __float_as_int(q.w));
      float d0, d1;
      const bool h0 = slab(lo0, hi0, r, t, d0);
      const bool h1 = slab(lo1, hi1, r, t, d1);
      if (h0 || h1) {
        // push the far child (both hit), then the near or only one, which
        // the pop right after takes back from the register; its slot is
        // stored only where a later pop reads it (see the header)
        if (h0 && h1) {
          const bool near0 = d0 <= d1;
          stack[min(sp, S - 1)] = near0 ? k1 : k0;
          ++sp;
          e = near0 ? k0 : k1;
        } else {
          e = h0 ? k0 : k1;
        }
        if (sp >= S) stack[S - 1] = e;
        pop = false;
      }
    }
    if (pop) {
      if (sp == 0) {
        out_tri[ray] = tri;
        if (!Any) {
          out_t[ray] = t;
          out_u[ray] = u;
          out_v[ray] = v;
        }
        ray = -1;
      } else {
        --sp;
        e = stack[min(sp, S - 1)];
      }
    }
  }
}

// The persistent grid of bvh2_kernel<Any> for R rays: its resident blocks
// per SM (no shared memory: one memo slot) times the SM count.
template <bool Any>
int launch(const float4* pairs, const float4* tris, int T, const float* ro,
           const float* rd, const float* tm, int R, int max_leaf, int S,
           int* next_ray, float* t, int* tri, float* u, float* v,
           cudaStream_t s) {
  const int grid = tt::persistent_grid<bvh2_kernel<Any>>(0, 0, R);
  if (grid < 1) return tt::no_grid();
  bvh2_kernel<Any><<<grid, kBlock, 0, s>>>(pairs, tris, T, ro, rd, tm, R,
                                           max_leaf, S, next_ray, t, tri, u,
                                           v);
  return (int)cudaGetLastError();
}

}  // namespace

// The closest (any = 0) or any hit (any = 1) of R rays ro/rd [R,3] before
// t_max [R] over the packed table (pair rows [N + 1, 16], then triangle
// rows [T, 12]; 16-byte aligned), leaves of at most max_leaf triangles,
// stacks of max_stack (1..64) entries; next_ray an int zeroed before the
// launch. Closest: t, tri, u, v [R]; any: tri [R] (>= 0 where blocked),
// the others may be null.
extern "C" int tt_bvh2(const void* table, int N, int T, const void* ro,
                       const void* rd, const void* t_max, int R,
                       int max_leaf, int max_stack, int any, void* next_ray,
                       void* t, void* tri, void* u, void* v, void* stream) {
  if (N < 1 || T < 1 || max_leaf < 1 || max_stack < 1 ||
      max_stack > kMaxStack)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const float4* pairs = static_cast<const float4*>(table);
  const float4* tris = pairs + 4 * ((size_t)N + 1);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tm = static_cast<const float*>(t_max);
  int* nr = static_cast<int*>(next_ray);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any)
    return launch<true>(pairs, tris, T, o, d, tm, R, max_leaf, max_stack,
                        nr, nullptr, static_cast<int*>(tri), nullptr,
                        nullptr, s);
  return launch<false>(pairs, tris, T, o, d, tm, R, max_leaf, max_stack, nr,
                       static_cast<float*>(t), static_cast<int*>(tri),
                       static_cast<float*>(u), static_cast<float*>(v), s);
}

#ifdef TT_BVH2_COUNT
namespace {
// One thread follows `steps` links of the chain `next` (next[i] is the
// index of the following link) through L2 (l1 = 0: ld.global.cg) or the
// L1 (l1 = 1: the read-only path the traversal reads through) and
// writes the cycles they took and the last index.
__global__ void chase_kernel(const int* __restrict__ next, int steps, int l1,
                             long long* __restrict__ out) {
  int i = 0;
  const long long c0 = clock64();
  for (int k = 0; k < steps; ++k) i = l1 ? __ldg(next + i) : __ldcg(next + i);
  out[0] = clock64() - c0;
  out[1] = i;
}
}  // namespace

// The latency of one dependent load (scripts/torch_bvh2_ab.py): out [2]
// int64 on the device, the cycles of `steps` loads and the last index.
extern "C" int tt_bvh2_chase(const void* next, int steps, int l1, void* out,
                             void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), steps, l1, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

// Copies the counts [6] to host memory `out` and clears them.
extern "C" int tt_bvh2_counts_read(void* out) {
  unsigned long long zero[6] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, tt_bvh2_counts, sizeof zero);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tt_bvh2_counts, zero, sizeof zero);
  return (int)e;
}
#endif
