// Heightfield ray marching on the H100: closest hit and any hit, one ray
// per thread, the march's bracket in registers.
//
// Replaces truetrace_tpu/kernels/heightmap.py heightmap_closest (:87) and
// heightmap_any (:137): a fixed 96-step march over f(t) = ray_y(t) -
// h(x(t), z(t)) and a 10-step bisection, which in torch would be some
// 110 launches of plain ops over the whole ray batch per call. Each
// thread walks one ray in the JAX step order: clip to the terrain's box
// (1e-12-floored reciprocals), dt = (tf - tn) * (1/96), t_i = tn + dt (i
// + 1), the first sign change of f wins (torch.sign semantics, NaN
// included); then 10 bisections from f(lo), the central-difference
// normal and the clamped uv. A lane whose clip is empty never crosses,
// so its march is skipped (the any hit returns at once), a lane whose
// clip has no length (dt = 0: t_max = 0 among them) samples tn at every
// step, so it takes none, and a lane stops marching at its first
// crossing (the later steps of the lock-step version cannot change its
// bracket); the bisection and the normal run on every lane, as the plain
// version computes them (their values on a miss are defined too). The
// any hit stops at the first crossing and writes only `valid`.
//
// What bounds it on the H100: operations. A bilinear sample is about 37
// f32 operations and four 4-byte fetches from the height grid, which at
// the forest's 257 x 257 (264 KB) stays in L2 and is read through the
// read-only path (__ldg); chip_smoke.py counts the samples each ray takes
// on the plain version and bounds the kernel by them, against the grid
// read once and 28 bytes a ray in and 28 out.
//
// Rounding contract: built with --fmad=false; the mul-adds XLA:CPU
// contracts are __fmaf_rn, at the product it fuses (the bilinear blend's
// last one at its first product alone and at its second inside f(t)),
// and the division by the step count is a product with its float32
// reciprocal, as XLA:CPU rewrites it. t, normal and uv are bitwise the
// plain version's (kernels/heightmap.py).
#include <cstdint>

#include "cwbvh_core.cuh"

namespace {

constexpr int kBlock = 128;

struct Grid {
  const float* __restrict__ h;
  int Hm, Wm;
  float ox, oz, sx, sz;
  float fx_max, fz_max;   // float32(Wm - 1.001), float32(Hm - 1.001)
};

__device__ __forceinline__ float sample(const Grid& g, float x, float z,
                                        bool last) {
  float fx = __fmul_rn(__fdiv_rn(x - g.ox, g.sx), (float)(g.Wm - 1));
  float fz = __fmul_rn(__fdiv_rn(z - g.oz, g.sz), (float)(g.Hm - 1));
  fx = tt::nmin(tt::nmax(fx, 0.0f), g.fx_max);
  fz = tt::nmin(tt::nmax(fz, 0.0f), g.fz_max);
  const int ix = (int)fx;
  const int iz = (int)fz;
  const float wx = fx - (float)ix;
  const float wz = fz - (float)iz;
  const int base = iz * g.Wm + ix;
  const float h00 = __ldg(g.h + base), h01 = __ldg(g.h + base + 1);
  const float h10 = __ldg(g.h + base + g.Wm);
  const float h11 = __ldg(g.h + base + g.Wm + 1);
  const float h0 = __fmaf_rn(h01, wx, h00 * (1.0f - wx));
  const float h1 = __fmaf_rn(h11, wx, h10 * (1.0f - wx));
  return last ? __fmaf_rn(h1, wz, h0 * (1.0f - wz))
              : __fmaf_rn(h0, 1.0f - wz, h1 * wz);
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
  const float o[3] = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  const float d[3] = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
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
  const float dt = inside ? (tf - tn) * inv_steps : 0.0f;
  auto f_at = [&](float t) {
    const float x = __fmaf_rn(d[0], t, o[0]);
    const float z = __fmaf_rn(d[2], t, o[2]);
    return __fmaf_rn(d[1], t, o[1]) - sample(g, x, z, true);
  };

  if (!Closest && !inside) {
    out_valid[i] = false;
    return;
  }
  float f_prev = f_at(tn), t_prev = tn, b_lo = tn, b_hi = tf;
  bool found = false;
  if (inside && dt == 0.0f) {
    // every step samples t = tn again (dead lanes, t_max = 0, among
    // them), so the first step decides, and f(tn) against itself
    // crosses only where it is NaN
    if (f_prev != f_prev) {
      b_hi = __fmaf_rn(dt, 1.0f, tn);
      found = true;
    }
  } else if (inside) {
    for (int s = 0; s < steps; ++s) {
      const float t = __fmaf_rn(dt, (float)(s + 1), tn);
      const float f = f_at(t);
      if (sgn(f) != sgn(f_prev)) {
        b_lo = t_prev;
        b_hi = t;
        found = true;
        break;
      }
      f_prev = f;
      t_prev = t;
    }
  }
  out_valid[i] = found;
  if (!Closest) return;

  float flo = f_at(b_lo);
  for (int k = 0; k < bisect; ++k) {
    const float mid = 0.5f * (b_lo + b_hi);
    const float fm = f_at(mid);
    if (sgn(fm) == sgn(flo)) {
      b_lo = mid;
      flo = fm;
    } else {
      b_hi = mid;
    }
  }
  const float t_hit = 0.5f * (b_lo + b_hi);
  const float px = __fmaf_rn(d[0], t_hit, o[0]);
  const float pz = __fmaf_rn(d[2], t_hit, o[2]);
  const float gx =
      __fdiv_rn(sample(g, px + dx, pz, false) - sample(g, px - dx, pz, false),
                2.0f * dx);
  const float gz =
      __fdiv_rn(sample(g, px, pz + dz, false) - sample(g, px, pz - dz, false),
                2.0f * dz);
  const float nx = -gx, nz = -gz;
  const float len = __fsqrt_rn((nx * nx + 1.0f) + nz * nz);
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
// dz). Closest: valid, t, normal [R,3], uv [R,2]; any: valid only.
extern "C" int tt_heightmap(const void* height, int Hm, int Wm, float ox,
                            float oy, float oz, float hx, float hy, float hz,
                            float sx, float sz, float dx, float dz,
                            const void* ro, const void* rd, const void* t_max,
                            int R, int steps, int bisect, int closest,
                            void* valid, void* t, void* n, void* uv,
                            void* stream) {
  if (Hm < 2 || Wm < 2 || steps < 1 || bisect < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  Grid g{static_cast<const float*>(height), Hm, Wm, ox, oz, sx, sz,
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
