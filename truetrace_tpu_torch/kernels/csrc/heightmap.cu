// Heightfield ray marching on the H100: closest hit and any hit, one ray
// per thread, with the march's steps that a table of the height grid's
// block maxima proves lie above the terrain skipped.
//
// Replaces truetrace_tpu/kernels/heightmap.py heightmap_closest (:87) and
// heightmap_any (:137): a fixed 96-step march over f(t) = ray_y(t) -
// h(x(t), z(t)) and a 10-step bisection, which in torch would be some
// 110 launches of plain ops over the whole ray batch per call. Each ray
// keeps the JAX step order: clip to the terrain's box (1e-12-floored
// reciprocals), dt = (tf - tn) * (1/96), t_j = fma(dt, j, tn) (j =
// 1..96), the first sign change of f wins (torch.sign semantics, 0 and
// NaN included); then 10 bisections from the sign of f(lo), the
// central-difference normal (four samples) and the clamped uv. A lane
// whose clip has no length (dt = 0: t_max = 0 among them) samples tn at
// every step, so its first sample decides (only a NaN crosses); a lane
// stops marching at its first crossing. The bisection and the normal run
// on every closest-hit lane, misses and empty clips included, as the
// plain version computes them. The any hit stops at the first crossing
// and writes only `valid`; a lane whose clip is empty takes no sample.
//
// What bounds it on the H100: operations. A bilinear sample is about 37
// f32 operations (two IEEE divisions among them) and four 4-byte fetches
// from the height grid, which at the forest's 257 x 257 (264 KB) stays in
// L2 and is read through the L1 (__ldg). chip_smoke.py counts the samples
// each ray takes on the plain version and bounds the kernel by them,
// against the grid read once and 28 bytes a ray in and 25 (1) out; the
// bound keeps that meaning whatever this kernel skips. The first version
// (one ray a thread, every step sampled) was issue-bound at full
// occupancy: ~90 instructions a march step, a warp trip ~1,930 cycles at
// 48 warps an SM. On the forest frame's first bounce this one takes a
// third of its samples in the closest hit and a tenth in the any hit; a
// warp's march then lasts as long as its slowest lane, so the chain of
// each trip's dependent loads (the table's level offset, its window, the
// four heights) sets much of the time.
//
// The design, element by element (PERF.md has what each bought in
// scripts/torch_heightmap_ab.py's turns):
//
// * Steps the ray cannot cross are skipped, by a table of the height
//   grid's block maxima (maximum mipmaps: Tevs, Ihrke and Seidel, I3D
//   2008; kernels/heightmap.py `height_top`, built once a terrain). The
//   march's result depends only on the signs of f at its steps, so a
//   span of steps where f is provably > 0, entered with f > 0 (or from
//   the start), changes no bit. The argument: over a span of steps j..k,
//   t_i = fma(dt, i, tn) is monotone in i, and x = fma(d, t, o), the
//   grid coordinate (x - ox) / sx * (Wm - 1) (sx > 0), its clamps and
//   its truncation to int are each monotone (correctly rounded or
//   monotone), so every sample's cell lies between the cells of the
//   span's two end samples, and its corners in that rectangle plus one;
//   y = fma(d_y, t, o_y) is monotone too, so it is smallest at an end.
//   The blend of four corners no larger than M, computed in float32
//   with weights in [0, 1], exceeds M by at most ~8 ulp of the largest
//   |corner| (two levels of a rounded product and one fma); the table
//   holds M + 2^-16 max |corner| + 2^-120, rounded up, and +inf for a
//   window with a NaN or infinite height. So when both end samples'
//   y exceed the table's entry for a window that holds the rectangle,
//   y > h at every sample, and f = y - h, an exact-sign subtraction, is
//   > 0. Level l of the table holds windows of 2^(l+1) x 2^(l+1) grid
//   points at stride 2^l, so the smallest l with 2^l >= the rectangle's
//   extent gives one window. A lane tests a span of `span` steps from its
//   next step while f > 0 (doubling it on success up to kSpanMax, halving
//   it on failure down to 2) and, where the test fails, takes the sample.
//   After a skipped span t_prev is the span's last t, recomputed by the
//   same fma. The end samples' coordinates must not be NaN; a terrain
//   whose extent is not positive and finite skips nothing.
// * The bisection's start sample is the march's. The bisection reads
//   f(lo) only for its sign (a step keeps the side whose sign equals
//   it, and replaces f(lo) by a value of the same sign), and lo is tn on
//   a miss or an empty clip and the march's t_prev on a crossing: the
//   signs of f(tn) and f(t_prev) are known from the march, where a
//   skipped span proved them positive.
// * The closest hit takes kBatch march samples a trip, their loads in
//   flight together, then reads them in step order; a lane samples at
//   most kBatch - 1 steps past its crossing, which change nothing.
//
// Measured and not kept: persistent warps pulling rays with one sample a
// lane a trip whatever its phase (a trip issued the union of the phases'
// paths and cost twice a sample of one thread a ray; with the outputs
// deferred to the refill, still 1.7 times); a bisection that collapses
// where f is provably > 0 between its midpoint and hi (its test on
// every step of every miss cost more than the samples it saved); the
// sample's loads issued with the test's; a pause of the tests after a
// failure at the shortest span; two samples a trip in the any hit; at
// most 40 registers (12 blocks an SM).
//
// Rounding contract: built with --fmad=false; the mul-adds XLA:CPU
// contracts are __fmaf_rn, at the product it fuses (the bilinear blend's
// last one at its first product alone and at its second inside f(t)),
// and the division by the step count is a product with its float32
// reciprocal, as XLA:CPU rewrites it. t, normal and uv are bitwise the
// plain version's (kernels/heightmap.py).
#include <cstdint>

#include "traverse_common.cuh"

namespace {

using tt::kBlock;

constexpr int kSpanInit = 8;   // a lane's first span of steps to skip
constexpr int kSpanMax = 64;
// march samples a trip: the closest hit's, the any hit's
constexpr int kBatchClosest = 2, kBatchAny = 1;

#ifdef TT_HM_COUNT
// The counting build (scripts/torch_heightmap_ab.py alone defines the
// macro): warp trips (one pass of a loop that takes a sample, counted by
// the converged lanes), lanes busy in them, samples taken, span tests,
// passed tests, steps skipped.
__device__ unsigned long long tt_hm_counts[6];
#define TT_COUNT_ADD(k, n) atomicAdd(&tt_hm_counts[k], (unsigned long long)(n))
#define TT_COUNT_TRIP()                                                 \
  {                                                                     \
    const unsigned m = __activemask();                                  \
    if ((threadIdx.x & 31) == __ffs(m) - 1) {                           \
      atomicAdd(&tt_hm_counts[0], 1ull);                                \
      atomicAdd(&tt_hm_counts[1], (unsigned long long)__popc(m));       \
    }                                                                   \
  }
#else
#define TT_COUNT_ADD(k, n)
#define TT_COUNT_TRIP()
#endif

struct Grid {
  const float* __restrict__ h;
  const float* __restrict__ top;  // height_top, null where nothing skips
  int Hm, Wm;
  float ox, oz, sx, sz;
  float fx_max, fz_max;   // float32(Wm - 1.001), float32(Hm - 1.001)
};

// A point's grid cell: its corner (ix, iz) and weights, and whether its
// grid coordinates are numbers (not NaN)
struct Cell {
  int ix, iz;
  float wx, wz;
  bool ok;
};

__device__ __forceinline__ Cell cell(const Grid& g, float x, float z) {
  float fx = __fmul_rn(__fdiv_rn(x - g.ox, g.sx), (float)(g.Wm - 1));
  float fz = __fmul_rn(__fdiv_rn(z - g.oz, g.sz), (float)(g.Hm - 1));
  Cell c;
  c.ok = fx == fx && fz == fz;
  fx = tt::nmin(tt::nmax(fx, 0.0f), g.fx_max);
  fz = tt::nmin(tt::nmax(fz, 0.0f), g.fz_max);
  c.ix = (int)fx;
  c.iz = (int)fz;
  c.wx = fx - (float)c.ix;
  c.wz = fz - (float)c.iz;
  return c;
}

// The bilinear height of a cell; XLA:CPU contracts the last mul-add at
// its second product inside f(t) (`last`), at its first elsewhere
__device__ __forceinline__ float blend(const Grid& g, const Cell& c,
                                       bool last) {
  const int base = c.iz * g.Wm + c.ix;
  const float h00 = __ldg(g.h + base), h01 = __ldg(g.h + base + 1);
  const float h10 = __ldg(g.h + base + g.Wm);
  const float h11 = __ldg(g.h + base + g.Wm + 1);
  const float h0 = __fmaf_rn(h01, c.wx, h00 * (1.0f - c.wx));
  const float h1 = __fmaf_rn(h11, c.wx, h10 * (1.0f - c.wx));
  return last ? __fmaf_rn(h1, c.wz, h0 * (1.0f - c.wz))
              : __fmaf_rn(h0, 1.0f - c.wz, h1 * c.wz);
}

// The table's bound over the heights of every sample whose cell lies
// between cells a and b (see the header): one window, or +inf where the
// cells' coordinates are not numbers
__device__ __forceinline__ float top_of(const Grid& g, const Cell& a,
                                        const Cell& b) {
  const int xl = min(a.ix, b.ix), zl = min(a.iz, b.iz);
  const int ext = max(max(a.ix, b.ix) + 1 - xl, max(a.iz, b.iz) + 1 - zl);
  const int lv = ext <= 1 ? 0 : 32 - __clz(ext - 1);
  const int off = __float_as_int(__ldg(g.top + lv));   // level lv's start
  const int nbx = ((g.Wm - 2) >> lv) + 1;
  const float m = __ldg(g.top + off + (zl >> lv) * nbx + (xl >> lv));
  return a.ok && b.ok ? m : __int_as_float(0x7f800000);
}

// torch.sign: -1, 0 or 1, NaN for NaN
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
}

template <bool Closest>
__global__ void __launch_bounds__(kBlock)
heightmap_kernel(Grid g, float lo_x, float lo_y, float lo_z, float hi_x,
                 float hi_y, float hi_z, float dx, float dz,
                 const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t_max, int R, int steps,
                 float inv_steps, int bisect, bool* __restrict__ out_valid,
                 float* __restrict__ out_t, float* __restrict__ out_n,
                 float* __restrict__ out_uv) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= R) return;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = ro[3 * i + a];
    d[a] = rd[3 * i + a];
  }
  const float tm = t_max[i];
  const float lo[3] = {lo_x, lo_y, lo_z}, hi[3] = {hi_x, hi_y, hi_z};
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dd =
        fabsf(d[a]) < 1e-12f ? (d[a] >= 0.0f ? 1e-12f : -1e-12f) : d[a];
    const float inv = __frcp_rn(dd);
    const float t0 = (lo[a] - o[a]) * inv, t1 = (hi[a] - o[a]) * inv;
    const float a0 = tt::nmin(t0, t1), a1 = tt::nmax(t0, t1);
    tn = a == 0 ? a0 : tt::nmax(tn, a0);
    tf = a == 0 ? a1 : tt::nmin(tf, a1);
  }
  tn = tt::nmax(tn, 0.0f);
  tf = tt::nmin(tf, tm);
  const bool inside = tf >= tn;
  if (!Closest && !inside) {
    out_valid[i] = false;
    return;
  }
  const float dt = inside ? (tf - tn) * inv_steps : 0.0f;
  // the march's last step: every step of a clip with no length (dt = 0)
  // samples tn again, so only the first decides
  const int last = inside && !(dt == 0.0f) ? steps : 0;
  auto at = [&](float t, int a) { return __fmaf_rn(d[a], t, o[a]); };
  auto t_of = [&](int j) {
    return j == 0 ? tn : __fmaf_rn(dt, (float)j, tn);
  };
  const bool can_skip = g.top != nullptr;

  // the march: sp is the sign of f at step j - 1, slo the sign of f(lo)
  constexpr int kBatch = Closest ? kBatchClosest : kBatchAny;
  float sp = 0.0f, slo = 0.0f, t_prev = tn, b_lo = tn, b_hi = tf;
  bool found = false;
  int span = kSpanInit;
  for (int j = 0; j <= last;) {
    TT_COUNT_TRIP();
    const float t = t_of(j);
    const float y = at(t, 1);
    const Cell c = cell(g, at(t, 0), at(t, 2));
    // a span of steps j..jb entered with f > 0 (or from the start): skip
    // it where the table proves f > 0 at each of its steps
    if (can_skip && (j == 0 || sp == 1.0f)) {
      const int jb = min(j + span - 1, last);
      const float tb = t_of(jb);
      TT_COUNT_ADD(3, 1);
      const float m = top_of(g, c, cell(g, at(tb, 0), at(tb, 2)));
      if (y > m && at(tb, 1) > m) {
        TT_COUNT_ADD(4, 1);
        TT_COUNT_ADD(5, jb + 1 - j);
        if (j == 0) slo = 1.0f;
        sp = 1.0f;
        t_prev = tb;
        j = jb + 1;
        span = min(2 * span, kSpanMax);
        continue;
      }
      span = max(span >> 1, 2);
    }
    // steps j..j + kBatch - 1, their loads in flight together
    float ys[kBatch], hs[kBatch], ts[kBatch];
    ys[0] = y;
    ts[0] = t;
    hs[0] = blend(g, c, true);
#pragma unroll
    for (int b = 1; b < kBatch; ++b) {
      ts[b] = t_of(min(j + b, last));
      ys[b] = at(ts[b], 1);
      hs[b] = blend(g, cell(g, at(ts[b], 0), at(ts[b], 2)), true);
    }
    TT_COUNT_ADD(2, min(kBatch, last + 1 - j));
    bool crossed = false;
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (!crossed && (b == 0 || j <= last)) {
        const float s = sgn(ys[b] - hs[b]);
        if (j > 0 && s != sp) {
          found = true;
          b_lo = t_prev;
          b_hi = ts[b];
          slo = sp;
          crossed = true;
        } else {
          if (j == 0) slo = s;
          sp = s;
          t_prev = ts[b];
          ++j;
        }
      }
    }
    if (crossed) break;
  }
  if (!found && inside && last == 0 && slo != slo) {
    // f(tn) is NaN: the first step crosses
    found = true;
    b_hi = __fmaf_rn(dt, 1.0f, tn);
  }
  if (!Closest) {
    out_valid[i] = found;
    return;
  }

  // the bisection from the sign of f(lo), then the normal at its middle
  for (int k = 0; k < bisect; ++k) {
    TT_COUNT_TRIP();
    TT_COUNT_ADD(2, 1);
    const float mid = 0.5f * (b_lo + b_hi);
    if (sgn(at(mid, 1) - blend(g, cell(g, at(mid, 0), at(mid, 2)), true)) ==
        slo) {
      b_lo = mid;
    } else {
      b_hi = mid;
    }
  }
  const float t_hit = 0.5f * (b_lo + b_hi);
  const float px = at(t_hit, 0), pz = at(t_hit, 2);
  for (int k = 0; k < 4; ++k) TT_COUNT_TRIP();
  TT_COUNT_ADD(2, 4);
  const float gx = __fdiv_rn(blend(g, cell(g, px + dx, pz), false) -
                                 blend(g, cell(g, px - dx, pz), false),
                             2.0f * dx);
  const float gz = __fdiv_rn(blend(g, cell(g, px, pz + dz), false) -
                                 blend(g, cell(g, px, pz - dz), false),
                             2.0f * dz);
  const float nx = -gx, nz = -gz;
  const float len = __fsqrt_rn((nx * nx + 1.0f) + nz * nz);
  out_valid[i] = found;
  out_t[i] = found ? t_hit : tm;
  out_n[3 * i] = __fdiv_rn(nx, len);
  out_n[3 * i + 1] = __fdiv_rn(1.0f, len);
  out_n[3 * i + 2] = __fdiv_rn(nz, len);
  const float u = __fdiv_rn(px - g.ox, g.sx), v = __fdiv_rn(pz - g.oz, g.sz);
  out_uv[2 * i] = tt::nmin(tt::nmax(u, 0.0f), 1.0f);
  out_uv[2 * i + 1] = tt::nmin(tt::nmax(v, 0.0f), 1.0f);
}

}  // namespace

// The march of R rays ro/rd [R,3] up to t_max [R] over the flat height
// grid [Hm*Wm]: its box [lo, hi], extent (sx, sz), sample spacing (dx,
// dz); `top` the grid's table of block maxima (kernels/heightmap.py
// height_top). Closest: valid, t, normal [R,3], uv [R,2]; any: valid
// only.
extern "C" int tt_heightmap(const void* height, const void* top, int Hm,
                            int Wm, float ox, float oy, float oz, float hx,
                            float hy, float hz, float sx, float sz, float dx,
                            float dz, const void* ro, const void* rd,
                            const void* t_max, int R, int steps, int bisect,
                            int closest, void* valid, void* t, void* n,
                            void* uv, void* stream) {
  if (Hm < 2 || Wm < 2 || steps < 1 || bisect < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  // a terrain whose extent is not positive and finite skips nothing (the
  // grid coordinate must grow with x and z)
  const bool skip = top != nullptr && sx > 0.0f && sz > 0.0f &&
                    sx <= 3.4e38f && sz <= 3.4e38f;
  const Grid g{static_cast<const float*>(height),
               skip ? static_cast<const float*>(top) : nullptr,
               Hm, Wm, ox, oz, sx, sz,
               (float)(Wm - 1.001), (float)(Hm - 1.001)};
  const float inv_steps = (float)(1.0 / steps);
  const int grid = (R + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(ro);
  const float* d = static_cast<const float*>(rd);
  const float* tm = static_cast<const float*>(t_max);
  bool* v = static_cast<bool*>(valid);
  if (closest)
    heightmap_kernel<true><<<grid, kBlock, 0, s>>>(
        g, ox, oy, oz, hx, hy, hz, dx, dz, o, d, tm, R, steps, inv_steps,
        bisect, v, static_cast<float*>(t), static_cast<float*>(n),
        static_cast<float*>(uv));
  else
    heightmap_kernel<false><<<grid, kBlock, 0, s>>>(
        g, ox, oy, oz, hx, hy, hz, dx, dz, o, d, tm, R, steps, inv_steps,
        bisect, v, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

#ifdef TT_HM_COUNT
// Copies the counts [6] to host memory `out` and clears them.
extern "C" int tt_hm_counts_read(void* out) {
  unsigned long long zero[6] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, tt_hm_counts, sizeof zero);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tt_hm_counts, zero, sizeof zero);
  return (int)e;
}
#endif
