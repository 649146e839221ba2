// Two-level (TLAS -> BLAS) CWBVH traversal on the H100: closest hit, any
// hit and shadow transmittance over instanced scenes, one ray per lane at
// a time, in persistent warps that pull rays from a shared counter.
//
// Replaces truetrace_tpu/kernels/cwbvh_tlas.py closest_hit_tlas (:483),
// any_hit_tlas (:492) and transmit_tlas (:422), whose per-ray
// while_loops over _step (:113) and _step_transmit (:277) torch cannot
// express on the device. The table is the unified one of
// kernels/cwbvh_tlas.py: C expanded node rows (the TLAS first), L BLAS
// leaf rows, I instance rows (W2L in words 0-11, the BLAS root node in
// word 12, the instance id in word 13), all 10K words wide.
//
// Each ray walks it in exactly the order of the JAX step. An iteration
// pops a saved group where the current one is empty, and a pop that
// brings the stack below the height of the instance's entry (ret_sp)
// leaves the instance: the world ray comes back with scale 1. Then one
// of three bodies runs:
//   * node: the next internal slot, near to far by the ray's octant (for
//     every query), its node row decoded against t * scale; the rest of
//     the group is pushed;
//   * triangles: a leaf slot inside a BLAS, <= K Moller tests in local
//     space against t_loc = t * scale. An accepted triangle sets t_loc =
//     th and t = th / max(scale, 1e-20): t is recomputed from th, never
//     carried, so the bits are the JAX package's;
//   * instance entry: a leaf slot outside a BLAS reads 14 words of its
//     instance row, moves the ray into local space by W2L with its
//     direction normalised by lscale = sqrt(max(|W2L rd|^2, 1e-20)) (the
//     local t per world t), pushes the TLAS remainder (its leaf bits
//     included), records ret_sp and takes the one-slot group whose slot 0
//     is the BLAS root.
// Any hit stops at its first accepted triangle; the transmittance never
// shortens t_max, multiplies the throughput by the shadow tint of every
// accepted triangle (tint rows indexed by global triangle id) and
// retires below 1e-3. A lane with t_max <= 0 can accept nothing (th >
// 1e-4 and th < t * scale with scale > 0): it writes its miss (t_max,
// tri -1, inst -1; a transmittance of 1) at fetch time and never walks.
//
// The stack. An entry is 12 bytes, (hits, chim, bleaf): unlike the
// single-level kernel (traverse.cu), a pushed group can still hold leaf
// bits (an instance entry pushes the TLAS remainder), which read bleaf
// after the pop. It is a ring of max_stack entries (16 on the main path:
// the JAX package's MAX_STACK; closest_hit_tlas never passes the scene's
// stack) in three planes of dynamic shared memory, entry-major so a
// warp's accesses are conflict free, and it reproduces the JAX shift
// register with its drop-the-deepest push, which here can drop TLAS
// entries under a deep BLAS: a popped slot is zeroed, so a dropped entry
// pops as an empty group.
//
// The pop of the next iteration is done at the end of the current one
// (with its iteration counted then), so each trip of a warp's loop knows
// which body each lane wants. Persistent warps pull rays from a shared
// counter, as in traverse.cu, and read whole rows in 16- or 8-byte loads.
//
// The design, element by element, with what each bought against the
// earlier kernel (three bodies a trip) in scripts/torch_tlas_ab.py's
// turns on the forest frame's bounce-0 rays (262144 lanes; NVIDIA H100
// 80GB HBM3, 700 W):
//
// * Two bodies a trip. A trip runs the triangle body when more than
//   half of the busy lanes want it, else the node body, which an
//   entering lane joins: it enters (its own iteration), then decodes its
//   BLAS root (the next iteration) in the same trip, unless the entry
//   used the last iteration below kIterCap. A fresh ray's TLAS root is
//   the same decode, counted as no iteration. Warp trips fell 27% on
//   the closest hit; time 1-2% (closest), 4% (any hit): an entering
//   lane no longer waits for a trip of entries, but the entries now run
//   in 78% of the node trips, 4.8 lanes at a time where an entry trip
//   ran 13.1.
// * The node decode (decode below) takes the first axis's entry and
//   exit as they are: 16 fewer min/max a row, 1-2% more.
// * The world ray stays in registers (113 of them, 4 blocks an SM, as
//   the earlier kernel's 111): reading it again on leaving an instance
//   (107 registers, still 4 blocks) cost 2% at the closest hit.
// Together: closest hit 3.7%, any hit 7.7%, transmittance 3.6% faster.
//
// Measured and not kept: the triangles' words loaded one triangle at a
// time (80 registers, 6 blocks; 14% slower at the any hit); a minimum of
// 5 to 8 blocks (spills from 5 on or slower from 6); other refill
// thresholds for the any hit; entries deferred until 4 or 8 lanes want
// one; a count of valid ring entries in place of zeroing popped slots;
// a block's rays repacked into its first warps every 8 to 64 trips once
// the pool is dry (trips down by half at the any hit, time not, its
// 15 KB of staging a block cutting the L1); one warp fetching its lanes'
// node rows together through shared memory (142 registers, 25% slower);
// a node lane's row read before the entering lanes enter (139
// registers, 3 blocks, 16% slower; capped at 128, it spills and is 6%
// slower). Neither trips nor load instructions bind (8-byte node loads
// cost 1%); the chain of trips of each ray, each a dependent row read,
// does.
//
// What bounds it on the H100: operations, as for the single-level
// kernel. chip_smoke.py counts each ray's node decodes (216 operations),
// triangle tests (53) and instance entries (about 40 and one 56-byte
// read) on the plain version, against the touched table rows read once
// and 48 bytes a walked ray (origin, direction, t_max in; t, tri, u, v,
// inst out).
//
// Rounding contract: built with --fmad=false; the Moller tests' contraction
// sites are those of cwbvh_core.cuh, the W2L transform contracts as
// fma(m2, z, fma(m0, x, m1 * y)) (+ m3 for a point) and the squared length
// as fma(z, z, fma(x, x, y * y)), as XLA:CPU forms them
// (kernels/cwbvh_tlas.py _xform).
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

constexpr uint32_t kPtr = 0x00FFFFFFu;
// the body a lane wants next
constexpr int kNone = 0, kNode = 1, kTri = 2, kEnter = 3;

#ifdef TT_TLAS_COUNT
// The counting build (scripts/torch_tlas_ab.py alone defines the macro):
// per body (node; triangles; instance entry, which runs in node trips),
// the warp trips that ran it, the lanes that ran it and the lanes busy in
// those trips; then the trips after the pool ran dry and their busy
// lanes.
__device__ unsigned long long tt_counts[4][3];
#define TT_COUNT(b, n, busy)                                           \
  if (lane == 0 && (n) > 0) {                                          \
    atomicAdd(&tt_counts[b][0], 1ull);                                 \
    atomicAdd(&tt_counts[b][1], (unsigned long long)(n));              \
    atomicAdd(&tt_counts[b][2], (unsigned long long)__popc(busy));     \
  }
#else
#define TT_COUNT(b, n, busy)
#endif

// A node row's decode: tt::decode_node's arithmetic, with the first
// axis's entry and exit taken as they are rather than against -inf and
// +inf (the same bits: max.NaN(-inf, x) is x, or NaN where x is one).
template <int V>
__device__ __forceinline__ void decode(const uint32_t* __restrict__ row,
                                       const tt::Ray& r, float t_best,
                                       uint32_t& hits, uint32_t& chim,
                                       uint32_t& bleaf) {
  uint32_t w[(26 + V - 1) / V * V];
  tt::load_row<V>(row, w);
  chim = w[24];
  bleaf = w[25];
  const uint32_t imask = chim >> 24;
  const uint32_t occ = imask | (bleaf >> 24);
  uint32_t h = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int wi = j >> 1;
    const int lo_sh = 16 * (j & 1);
    float tn = 0.0f, tf = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float lo = tt::bits_f(((w[8 * a + wi] >> lo_sh) & 0xFFFFu) << 16);
      const float hi =
          tt::bits_f(((w[8 * a + 4 + wi] >> lo_sh) & 0xFFFFu) << 16);
      const float t0 = (lo - r.o[a]) * r.inv[a];
      const float t1 = (hi - r.o[a]) * r.inv[a];
      tn = a == 0 ? tt::nmin(t0, t1) : tt::nmax(tn, tt::nmin(t0, t1));
      tf = a == 0 ? tt::nmax(t0, t1) : tt::nmin(tf, tt::nmax(t0, t1));
    }
    const bool hit = (tf >= tt::nmax(tn, 0.0f)) && (tn < t_best) &&
                     ((occ >> j) & 1u);
    if (hit) h |= ((imask >> j) & 1u) ? (1u << (24 + j)) : (1u << j);
  }
  hits = h;
}

__device__ __forceinline__ uint32_t octant(const float* d) {
  return (d[0] < 0.0f ? 1u : 0u) | (d[1] < 0.0f ? 2u : 0u) |
         (d[2] < 0.0f ? 4u : 0u);
}

// The stack's three planes: entry e of thread x at [e * kBlock + x].
struct Stack {
  uint32_t* h;
  uint32_t* c;
  uint32_t* b;
};

template <int K, int Q>
__global__ void __launch_bounds__(kBlock)
tlas_kernel(const uint32_t* __restrict__ table, int C, int L, int I, int S,
            const float* __restrict__ ro, const float* __restrict__ rd,
            const float* __restrict__ t_max, int R, int* __restrict__ next_ray,
            float* __restrict__ out_t, int* __restrict__ out_tri,
            float* __restrict__ out_u, float* __restrict__ out_v,
            int* __restrict__ out_inst, const float* __restrict__ tint, int T,
            float* __restrict__ out_tp) {
  constexpr int W = 10 * K;
  constexpr int V = K % 2 == 0 ? 4 : 2;   // words per row load
  extern __shared__ uint32_t stack_mem[];
  const Stack stk{stack_mem + threadIdx.x,
                  stack_mem + S * kBlock + threadIdx.x,
                  stack_mem + 2 * S * kBlock + threadIdx.x};
  const int lane = threadIdx.x & 31;

  int ray = -1;              // this lane's ray, -1 while idle
  bool pool_open = true;
  bool root = false;         // the root row is still to decode
  bool popped = false;       // the next iteration's pop is done
  tt::Ray r;                 // the current (world or local) ray
  float ow[3], dw[3];        // the saved world ray
  uint32_t oct = 0u, hits = 0u, chim = 0u, bleaf = 0u;
  float t = 0.0f, u = 0.0f, v = 0.0f, scale = 1.0f;
  float tp[3] = {1.0f, 1.0f, 1.0f};
  int tri = -1, inst = -1, inst_cur = -1, ret_sp = -1;
  int head = 0, sp = 0, it = 0;

  while (true) {
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
          tri = inst = inst_cur = ret_sp = -1;
          u = v = 0.0f;
          tp[0] = tp[1] = tp[2] = 1.0f;
          if (t > 0.0f) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              ow[a] = ro[3 * i + a];
              dw[a] = rd[3 * i + a];
            }
            r = tt::make_ray(ow, dw);
            oct = octant(dw);
            scale = 1.0f;
            ray = i;
            root = true;
            popped = false;
            head = sp = it = 0;
          } else if (Q == kTransmit) {
            out_tp[3 * i] = out_tp[3 * i + 1] = out_tp[3 * i + 2] = 1.0f;
          } else {
            out_t[i] = t;
            out_tri[i] = -1;
            out_u[i] = 0.0f;
            out_v[i] = 0.0f;
            out_inst[i] = -1;
          }
        }
      }
    }
    const uint32_t busy = __ballot_sync(kAll, ray >= 0);
    if (busy == 0u) {
      if (!pool_open) break;
      continue;
    }

    // the body each lane wants; a trip runs the triangles or else the
    // nodes, an entering lane's entry included
    int want = kNone;
    if (ray >= 0) {
      if (root || (hits & 0xFFu) == 0u)
        want = kNode;
      else
        want = ret_sp >= 0 ? kTri : kEnter;
    }
    const int n_tri = __popc(__ballot_sync(kAll, want == kTri));
    const int n_ent = __popc(__ballot_sync(kAll, want == kEnter));
    const bool tri_trip = 2 * n_tri > __popc(busy);
    TT_COUNT(0, tri_trip ? 0 : __popc(busy) - n_tri, busy);
    TT_COUNT(1, tri_trip ? n_tri : 0, busy);
    TT_COUNT(2, tri_trip ? 0 : n_ent, busy);
    TT_COUNT(3, pool_open ? 0 : __popc(busy), busy);
    if (want == kNone || (want == kTri) != tri_trip) continue;

    if (!root) {               // entering the root is no iteration
      if (!popped) ++it;       // else the pop began this iteration
      popped = false;
    }
    if (want == kTri) {
      const uint32_t leaf_bits = hits & 0xFFu;
      const uint32_t lsb = leaf_bits & (~leaf_bits + 1u);
      const int lbase =
          (int)(bleaf & kPtr) + __popc((bleaf >> 24) & (lsb - 1u));
      const int row = C + min(max(lbase, 0), L - 1);
      hits &= ~lsb;
      uint32_t w[W];
      tt::load_row<V>(table + (size_t)row * W, w);
      float t_loc = t * scale;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int id = (int)w[9 * K + j];
        float th, uu, vv;
        if (id >= 0 && tt::moller(w + 9 * j, 1, r, t_loc, th, uu, vv)) {
          if (Q == kTransmit) {
            const float* c = tint + 3 * (size_t)min(id, T - 1);
            tp[0] = tp[0] * __ldg(c);
            tp[1] = tp[1] * __ldg(c + 1);
            tp[2] = tp[2] * __ldg(c + 2);
          } else {
            t_loc = th;
            t = __fdiv_rn(th, tt::nmax(scale, 1e-20f));
            tri = id;
            inst = inst_cur;
            u = uu;
            v = vv;
          }
        }
      }
    } else {
      if (want == kEnter) {    // enter the instance
        const uint32_t leaf_bits = hits & 0xFFu;
        const uint32_t lsb = leaf_bits & (~leaf_bits + 1u);
        const int lbase =
            (int)(bleaf & kPtr) + __popc((bleaf >> 24) & (lsb - 1u));
        const uint32_t rest = hits & ~lsb;
        const int row = C + L + min(max(lbase, 0), I - 1);
        uint32_t w[16];
        tt::load_row<V>(table + (size_t)row * W, w);
        float m[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) m[k] = tt::bits_f(w[k]);
        float lo[3], ld[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float* q = m + 4 * a;
          lo[a] = __fmaf_rn(q[2], r.o[2], __fmaf_rn(q[0], r.o[0],
                                                    q[1] * r.o[1])) +
                  q[3];
          ld[a] = __fmaf_rn(q[2], r.d[2], __fmaf_rn(q[0], r.d[0],
                                                    q[1] * r.d[1]));
        }
        const float lscale = __fsqrt_rn(tt::nmax(
            __fmaf_rn(ld[2], ld[2], __fmaf_rn(ld[0], ld[0], ld[1] * ld[1])),
            1e-20f));
#pragma unroll
        for (int a = 0; a < 3; ++a) ld[a] = __fdiv_rn(ld[a], lscale);
        if (rest != 0u) {      // push the TLAS remainder
          head = head == 0 ? S - 1 : head - 1;
          stk.h[head * kBlock] = rest;
          stk.c[head * kBlock] = chim;
          stk.b[head * kBlock] = bleaf;
          ++sp;
        }
        r = tt::make_ray(lo, ld);
        oct = octant(ld);
        scale = lscale;
        ret_sp = sp;
        inst_cur = (int)w[13];
        hits = 1u << 24;
        chim = (w[12] & kPtr) | (1u << 24);
        bleaf = 0u;
        // the BLAS root's decode is the next iteration: it runs in this
        // trip, unless the entry used the last one
        if (it < kIterCap) {
          ++it;
          want = kNode;
        }
      }
      if (want == kNode) {     // a node row: the next slot's, or a root
        int row = 0;
        uint32_t rest = 0u;
        if (!root) {
          const uint32_t node_bits = hits >> 24;
          const uint32_t pm = xor_permute8(node_bits, oct);
          const uint32_t lsb = pm & (~pm + 1u);
          const int slot = (__popc(lsb - 1u) ^ (int)oct) & 7;
          rest = node_bits & ~(1u << slot);
          const uint32_t below = (chim >> 24) & ((1u << slot) - 1u);
          row = min(max((int)(chim & kPtr) + __popc(below), 0), C - 1);
        }
        root = false;
        uint32_t c_hits, c_chim, c_bleaf;
        decode<V>(table + (size_t)row * W, r, t * scale, c_hits, c_chim,
                  c_bleaf);
        if (rest != 0u) {      // push; a full ring drops its deepest entry
          head = head == 0 ? S - 1 : head - 1;
          stk.h[head * kBlock] = rest << 24;
          stk.c[head * kBlock] = chim;
          stk.b[head * kBlock] = bleaf;
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
    // the next iterations' pops, done ahead; one that pops an empty
    // (dropped) group is an iteration of its own
    while (hits == 0u && sp > 0 && it < kIterCap) {
      ++it;
      const bool in_blas = ret_sp >= 0;
      hits = stk.h[head * kBlock];
      chim = stk.c[head * kBlock];
      bleaf = stk.b[head * kBlock];
      stk.h[head * kBlock] = stk.c[head * kBlock] = stk.b[head * kBlock] = 0u;
      head = head + 1 == S ? 0 : head + 1;
      --sp;
      if (in_blas && sp < ret_sp) {   // leave the instance
        r = tt::make_ray(ow, dw);
        oct = octant(dw);
        scale = 1.0f;
        ret_sp = -1;
        inst_cur = -1;
      }
      if (hits != 0u) popped = true;
    }
    if ((hits == 0u && sp == 0) || (it >= kIterCap && !popped)) {
      if (Q == kTransmit) {
        const bool dark = max3(tp[0], tp[1], tp[2]) < kOpaque;
#pragma unroll
        for (int c = 0; c < 3; ++c) out_tp[3 * ray + c] = dark ? 0.0f : tp[c];
      } else {
        out_t[ray] = t;
        out_tri[ray] = tri;
        out_u[ray] = u;
        out_v[ray] = v;
        out_inst[ray] = inst;
      }
      ray = -1;
    }
  }
}

size_t stack_bytes(int S) { return (size_t)3 * S * kBlock * sizeof(uint32_t); }

template <int K, int Q>
int launch(const uint32_t* table, int C, int L, int I, int S, const float* ro,
           const float* rd, const float* tm, int R, int* next_ray,
           const tt::Out& o, cudaStream_t s) {
  const int grid =
      tt::persistent_grid<tlas_kernel<K, Q>>(S, stack_bytes(S), R);
  if (grid < 1) return tt::no_grid();
  tlas_kernel<K, Q><<<grid, kBlock, stack_bytes(S), s>>>(
      table, C, L, I, S, ro, rd, tm, R, next_ray, o.t, o.tri, o.u, o.v,
      o.inst, o.tint, o.T, o.tp);
  return (int)cudaGetLastError();
}

}  // namespace

// Closest hit (any_hit = 0) or any hit of R rays against the unified
// table [C + L + I, W]: t, tri, u, v, inst [R].
extern "C" int tt_tlas_traverse(const void* table, int W, int C, int L, int I,
                                int S, const void* ro, const void* rd,
                                const void* t_max, int R, int any_hit,
                                void* next_ray, void* out_t, void* out_tri,
                                void* out_u, void* out_v, void* out_inst,
                                void* stream) {
  if (S < 1 || S > kMaxStack || C < 1 || L < 1 || I < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const uint32_t* tb = static_cast<const uint32_t*>(table);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tm = static_cast<const float*>(t_max);
  int* nr = static_cast<int*>(next_ray);
  const tt::Out out{static_cast<float*>(out_t), static_cast<int*>(out_tri),
                    static_cast<float*>(out_u), static_cast<float*>(out_v),
                    static_cast<int*>(out_inst), nullptr, 0, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TT_CASE(k)                                                          \
  case 10 * k:                                                              \
    return any_hit                                                          \
               ? launch<k, kAny>(tb, C, L, I, S, o, d, tm, R, nr, out, s)   \
               : launch<k, kClosest>(tb, C, L, I, S, o, d, tm, R, nr, out, \
                                     s);
  switch (W) {
    TT_FOR_EACH_K(TT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TT_CASE
}

// Shadow transmittance [R,3] against the tint table [T,3]; the other
// arguments as tt_tlas_traverse's.
extern "C" int tt_tlas_transmit(const void* table, int W, int C, int L, int I,
                                int S, const void* tint, int T,
                                const void* ro, const void* rd,
                                const void* t_max, int R, void* next_ray,
                                void* out_tp, void* stream) {
  if (S < 1 || S > kMaxStack || T < 1 || C < 1 || L < 1 || I < 1)
    return (int)cudaErrorInvalidValue;
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
    return launch<k, kTransmit>(tb, C, L, I, S, o, d, tm, R, nr, out, s);
  switch (W) {
    TT_FOR_EACH_K(TT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TT_CASE
}

#ifdef TT_TLAS_COUNT
// Copies the counts [4][3] to host memory `out` and clears them.
extern "C" int tt_tlas_counts(void* out) {
  unsigned long long zero[12] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, tt_counts, sizeof zero);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(tt_counts, zero, sizeof zero);
  return (int)e;
}
#endif

// Dynamic shared memory of a launch with S stack entries, in bytes.
extern "C" int tt_tlas_smem(int S) {
  if (S < 1 || S > kMaxStack) return -1;
  return (int)stack_bytes(S);
}
