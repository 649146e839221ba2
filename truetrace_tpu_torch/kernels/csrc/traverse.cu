// CWBVH traversal on the H100: closest hit, any hit and shadow
// transmittance, one ray per lane at a time, in persistent warps that
// pull rays from a shared counter.
//
// Replaces truetrace_tpu/kernels/cwbvh_wavefront.py closest_hit_wavefront
// (:861), any_hit_wavefront (:927) and transmit_wavefront (:1039, step
// _step_transmit :940), whose per-ray while_loops (:755, :1068) torch
// cannot express on the device, and carries the work of the Pallas
// step_core (step_pallas.py:120) through the shared core in
// cwbvh_core.cuh. Each ray walks the unified table (expanded 26-word node
// rows zero-padded to 10K words, then leaf rows) in exactly the order of
// cwbvh_wavefront._step: pop a saved group when the current one is empty;
// pending leaf slots first (row = base leaf row + rank of the slot among
// the leaf slots); otherwise descend into the next node slot (closest
// hit: near to far by the ray's octant; any hit: lowest set bit), saving
// the rest of the group. Any hit stops at its first accepted triangle.
// Transmittance (the third query type) walks as any hit does but never
// shortens t_max and never stops at a hit: every accepted triangle
// multiplies the lane's RGB throughput by its shadow tint, in slot order
// (the order _step_transmit multiplies in, so the products are bitwise
// the plain version's), and the lane retires once its largest channel
// falls below 1e-3 (its result is 0 then). Its bound is the any hit's
// operations on the same rays plus three products per accepted
// triangle, against the touched table rows and tint rows (12 bytes
// each) read once and 40 bytes per walked ray (origin, direction, t_max
// in; RGB out), 16 per dead one (t_max in, RGB out); chip_smoke.py
// counts it on the plain version.
// The stack is a ring of max_stack entries that reproduces the JAX shift
// register, including its drop-the-deepest push on a full stack.
//
// What bounds it on the H100. chip_smoke.py counts the work on the plain
// traversal: on the 293k-triangle atrium at K = 6, bench.py's mix at
// 262144 rays per class, a primary ray decodes 11.3 node rows and tests
// 2.1 leaf rows (9.4 triangles), a cosine bounce 11.3 and 3.1 (14.2), a
// shadow ray 8.0 and 1.9 (8.7). At 216 f32 operations a decode and 53 a
// triangle that is 8.6-12.5 us of work at 67 TFLOP/s, above the 5.5-7.4
// us the touched rows and the rays need at 3.35 TB/s: operations bound it.
// The kernel takes 17-23 times that (H100 80GB HBM3, 700 W): a warp's
// trip runs only the lanes whose next step is the body it chose, and once
// the ray pool is empty the longest rays still in flight keep their warps
// alive on their own.
//
// The design, element by element:
//
// * Row loads. Every lane reads its own row, so each load instruction of
//   a warp touches up to 32 cache lines; scalar loads paid that once per
//   4-byte word (26 for a node, 60 for a K = 6 leaf row). Rows are read
//   whole into registers through the read-only path, in 16-byte loads (7
//   for a node, 10K/4 for a leaf row) where K is even and in 8-byte loads
//   where K is odd (a 10K-word row then starts only 8-byte aligned):
//   tt::decode_node / tt::test_leaf. Padding triangles are skipped.
// * The stack. An entry is 8 bytes, (chim, node mask), in a ring of
//   max_stack entries in dynamic shared memory, entry-major so a warp's
//   accesses are conflict free; three dynamically indexed arrays of 32
//   words per thread in local memory before. The leaf-row base (bleaf) of
//   a pushed group is dead state: a group is pushed only when its leaf
//   bits are drained, so a popped group descends before bleaf is read,
//   and the child's decode replaces it.
// * Persistent warps. The grid is the resident blocks per SM (occupancy
//   calculator) times the SM count, and a warp refills its idle lanes,
//   once at least kRefillMin of them are idle, with one atomicAdd on a
//   ray counter: the reference renderer's work pull
//   (IntersectionKernels.compute:79-82). A warp no longer lives as long
//   as its slowest ray, and a dead ray (t_max = 0, most lanes of the late
//   bounces) writes its miss at fetch time and never holds a lane.
// * One body per trip. A lane's next step is a leaf row or a node row;
//   each trip of the warp's loop runs the body more of its lanes want,
//   and the others wait, where a one-thread-per-ray loop runs both bodies
//   whenever its lanes disagree. A fresh ray's root decode is a node step.
// * Arithmetic. min.NaN / max.NaN in one instruction each where the
//   NaN-propagating min/max took two compares and a select, and __frcp_rn
//   for the reciprocals: the same bits, fewer instructions.
//
// Variants built and timed on the card and not kept, none faster:
// prefetching the next rows into L1, fewer resident blocks, more with a
// register cap (it spills), blocks of 64 or 256 threads, a warp-local
// queue of 32 claimed rays, other refill thresholds, and other trip
// schedules (both bodies per trip; while-while phases; nodes first).
#include "traverse_common.cuh"

namespace {

using tt::kAll;
using tt::kAny;
using tt::kBlock;
using tt::kClosest;
using tt::kIterCap;
using tt::kMaxStack;
using tt::kOpaque;
using tt::kRefillMin;
using tt::kTransmit;
using tt::max3;
using tt::xor_permute8;

template <int K, int Q>
__global__ void __launch_bounds__(kBlock)
traverse_kernel(const uint32_t* __restrict__ table, int C, int L, int S,
                const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ t_max, int R,
                int* __restrict__ next_ray, float* __restrict__ out_t,
                int* __restrict__ out_tri, float* __restrict__ out_u,
                float* __restrict__ out_v, const float* __restrict__ tint,
                int T, float* __restrict__ out_tp) {
  constexpr int W = 10 * K;
  constexpr int V = K % 2 == 0 ? 4 : 2;   // words per row load
  extern __shared__ uint2 stack_mem[];
  uint2* const stk = stack_mem + threadIdx.x;   // entry e: stk[e * kBlock]
  const int lane = threadIdx.x & 31;

  int ray = -1;              // this lane's ray, -1 while idle
  bool pool_open = true;     // the same on every lane of the warp
  bool root = false;         // the ray's root row is still to decode
  tt::Ray r;
  uint32_t oct = 0u, hits = 0u, chim = 0u, bleaf = 0u;
  float t = 0.0f, u = 0.0f, v = 0.0f;
  float tp[3] = {1.0f, 1.0f, 1.0f};   // transmittance (Q == kTransmit)
  int tri = -1, head = 0, sp = 0, it = 0;

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
          tri = -1;
          u = v = 0.0f;
          tp[0] = tp[1] = tp[2] = 1.0f;
          if (t > 1e-4f) {
            r = tt::make_ray(ro + 3 * i, rd + 3 * i);
            oct = (r.d[0] < 0.0f ? 1u : 0u) | (r.d[1] < 0.0f ? 2u : 0u) |
                  (r.d[2] < 0.0f ? 4u : 0u);
            ray = i;
            root = true;
            head = sp = it = 0;
          } else {
            // no triangle can pass th > 1e-4 && th < t: a miss (a
            // transmittance of 1), with no walk (the dead lanes of the
            // integrator, t_max = 0)
            if (Q == kTransmit) {
              out_tp[3 * i] = out_tp[3 * i + 1] = out_tp[3 * i + 2] = 1.0f;
            } else {
              out_t[i] = t;
              out_tri[i] = -1;
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

    // one body per trip: the one more of the warp's lanes want next (a
    // leaf row while a lane's group has leaf bits, else a node row: a
    // pop, the root); the other lanes wait for the next trip
    const bool want_leaf = ray >= 0 && !root && (hits & 0xFFu) != 0u;
    const uint32_t leaf_mask = __ballot_sync(kAll, want_leaf);
    const bool run_leaf = __popc(leaf_mask) > __popc(busy & ~leaf_mask);
    if (ray < 0 || want_leaf != run_leaf) continue;

    // one iteration of cwbvh_wavefront._step for this lane's ray
    if (want_leaf) {           // the group's next leaf slot
      ++it;
      const uint32_t leaf_bits = hits & 0xFFu;
      const uint32_t lsb = leaf_bits & (~leaf_bits + 1u);
      const int lrank = __popc((bleaf >> 24) & (lsb - 1u));
      const int row =
          C + min(max((int)(bleaf & 0x00FFFFFFu) + lrank, 0), L - 1);
      hits &= ~lsb;
      if (Q == kTransmit)
        tt::transmit_leaf<K, V>(table + (size_t)row * W, r, t, tint, T, tp);
      else
        tt::test_leaf<K, V>(table + (size_t)row * W, r, Q == kClosest, t,
                            tri, u, v);
    } else {                   // the root, or the next node slot
      bool work = true;
      int row = 0;             // the root's row unless set below
      uint32_t rest = 0u;      // node slots to push
      if (root) {
        root = false;          // entering the root is no iteration
      } else {
        ++it;
        if (hits == 0u) {      // pop; the vacated slot becomes the bottom
          const uint2 e = stk[head * kBlock];
          stk[head * kBlock] = make_uint2(0u, 0u);
          head = head + 1 == S ? 0 : head + 1;
          --sp;
          hits = e.y << 24;
          chim = e.x;
          work = hits != 0u;
        }
        if (work) {
          const uint32_t node_bits = hits >> 24;
          int slot;
          if (Q != kClosest) {
            const uint32_t lsb_n = node_bits & (~node_bits + 1u);
            slot = __popc(lsb_n - 1u);
            rest = node_bits & ~lsb_n;
          } else {
            const uint32_t pm = xor_permute8(node_bits, oct);
            const uint32_t lsb = pm & (~pm + 1u);
            slot = (__popc(lsb - 1u) ^ (int)oct) & 7;
            rest = node_bits & ~(1u << slot);
          }
          const uint32_t below = (chim >> 24) & ((1u << slot) - 1u);
          row = min(max((int)(chim & 0x00FFFFFFu) + __popc(below), 0),
                    C - 1);
        }
      }
      if (work) {
        uint32_t c_hits, c_chim, c_bleaf;
        tt::decode_node<V>(table + (size_t)row * W, r, t, c_hits, c_chim,
                           c_bleaf);
        if (rest != 0u) {      // push; a full ring drops its deepest entry
          head = head == 0 ? S - 1 : head - 1;
          stk[head * kBlock] = make_uint2(chim, rest);
          ++sp;
        }
        hits = c_hits;
        chim = c_chim;
        bleaf = c_bleaf;
      }
    }
    if ((Q == kAny && tri >= 0) ||
        (Q == kTransmit && max3(tp[0], tp[1], tp[2]) < kOpaque)) {
      hits = 0u;
      sp = 0;
    }
    if ((hits == 0u && sp == 0) || it >= kIterCap) {
      if (Q == kTransmit) {
        const bool dark = max3(tp[0], tp[1], tp[2]) < kOpaque;
#pragma unroll
        for (int c = 0; c < 3; ++c) out_tp[3 * ray + c] = dark ? 0.0f : tp[c];
      } else {
        out_t[ray] = t;
        out_tri[ray] = tri;
        out_u[ray] = u;
        out_v[ray] = v;
      }
      ray = -1;
    }
  }
}

size_t stack_bytes(int S) { return (size_t)S * kBlock * sizeof(uint2); }

template <int K, int Q>
int launch(const uint32_t* table, int C, int L, int S, const float* ro,
           const float* rd, const float* tm, int R, int* next_ray,
           const tt::Out& o, cudaStream_t s) {
  const int grid =
      tt::persistent_grid<traverse_kernel<K, Q>>(S, stack_bytes(S), R);
  if (grid < 1) return tt::no_grid();
  traverse_kernel<K, Q><<<grid, kBlock, stack_bytes(S), s>>>(
      table, C, L, S, ro, rd, tm, R, next_ray, o.t, o.tri, o.u, o.v, o.tint,
      o.T, o.tp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tt_traverse(const void* table, int W, int C, int L, int S,
                           const void* ro, const void* rd, const void* t_max,
                           int R, int any_hit, void* next_ray, void* out_t,
                           void* out_tri, void* out_u, void* out_v,
                           void* stream) {
  if (S < 1 || S > kMaxStack) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const uint32_t* tb = static_cast<const uint32_t*>(table);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tm = static_cast<const float*>(t_max);
  int* nr = static_cast<int*>(next_ray);
  const tt::Out out{static_cast<float*>(out_t), static_cast<int*>(out_tri),
                    static_cast<float*>(out_u), static_cast<float*>(out_v),
                    nullptr, nullptr, 0, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TT_CASE(k)                                                         \
  case 10 * k:                                                             \
    return any_hit ? launch<k, kAny>(tb, C, L, S, o, d, tm, R, nr, out, s) \
                   : launch<k, kClosest>(tb, C, L, S, o, d, tm, R, nr, out, \
                                         s);
  switch (W) {
    TT_FOR_EACH_K(TT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TT_CASE
}

// Shadow transmittance [R,3] of each segment against the tint table
// tint [T,3]; the other arguments as tt_traverse's.
extern "C" int tt_transmit(const void* table, int W, int C, int L, int S,
                           const void* tint, int T, const void* ro,
                           const void* rd, const void* t_max, int R,
                           void* next_ray, void* out_tp, void* stream) {
  if (S < 1 || S > kMaxStack || T < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const uint32_t* tb = static_cast<const uint32_t*>(table);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tm = static_cast<const float*>(t_max);
  int* nr = static_cast<int*>(next_ray);
  const tt::Out out{nullptr, nullptr, nullptr, nullptr, nullptr,
                    static_cast<const float*>(tint), T,
                    static_cast<float*>(out_tp)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TT_CASE(k) \
  case 10 * k:     \
    return launch<k, kTransmit>(tb, C, L, S, o, d, tm, R, nr, out, s);
  switch (W) {
    TT_FOR_EACH_K(TT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TT_CASE
}

// Dynamic shared memory of a launch with S stack entries, in bytes (-1
// for an S tt_traverse refuses).
extern "C" int tt_traverse_smem(int S) {
  if (S < 1 || S > kMaxStack) return -1;
  return (int)stack_bytes(S);
}
