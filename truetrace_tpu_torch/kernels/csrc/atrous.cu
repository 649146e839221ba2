// SVGF edge-aware a-trous pass (one of the 5 per frame) on packed float4
// planes: (colour.rgb, variance) in and out, (normal.xyz, depth) as guide.
//
// Replaces truetrace_tpu/kernels/atrous_pallas.py atrous_pass_pallas
// (:110), which needed the whole image in VMEM and so never ran at 512^2
// (atrous_fits_vmem is false there). It computes the plain
// post/svgf._atrous_pass: a 3x3 (1,2,1)^2 prefilter of the variance at
// the centre pixel gives sigma_l; 25 B3-spline taps at
// ((i-2)*step, (j-2)*step) are weighted by
// k * max(n.n_q,0)^128 * exp(-|dz|/sigma_z) * exp(-|dlum|/sigma_l)
// (centre tap: k); out colour = sum(w c)/sum(w), var = sum(w^2 var)/
// (sum w)^2. Borders wrap cyclically, as torch.roll does: tap (dy, dx) of
// pixel (y, x) reads ((y - dy) mod H, (x - dx) mod W). Its contract is a
// tolerance (rtol 1e-4, atol 1e-5 against the plain pass), not bits, so
// this source is built without --fmad=false (kernels/_cuda.py).
//
// What bounds it on the H100: the compulsory bytes are 12.6 MB a pass at
// 512^2 (colour, variance, normal, depth in; colour, variance out), 3.8 us
// at 3.35 TB/s, and the frame's 12 MB of packed planes stay in the 50 MB
// L2. In practice it is bound by instruction issue (24 weighted taps a
// pixel) and, at large steps, by the L2-to-SM traffic of taps that no
// neighbouring thread shares. What each element
// of the design does:
//
// - Arithmetic for the card: max(nd,0)^128 is seven squarings; each pixel
//   computes -log2(e)/sigma_z and -log2(e)/sigma_l once, so a tap's two
//   exponentials are one multiply-add and one ex2.approx, with no
//   division; the B3 weights are exact float constants of fully unrolled
//   tap loops (no stack frame, no double). Luminance, the normal dot
//   product, sigma_z and the prefilter round as the plain torch ops do
//   (__fmul_rn/__fadd_rn): the weights amplify their last ulp (128 times
//   for the dot product; 1/sigma_l at zero variance for luminance).
//   NaNs propagate where torch.clamp propagates them.
// - Loads as the card wants them: one 16-byte load a texel per plane
//   (float4 colour+variance, float4 normal+depth).
// - Staged path, the same dense stencil at every step: when step divides
//   H and W, pixel (y, x) reads only pixels of its own residue class
//   (y mod step, x mod step), and the cyclic wrap keeps the class. A
//   block takes a 32x8 tile of one class's sub-image, stages it with a
//   2-texel halo in shared memory (36x12 texels, 15.5 KB; luminance
//   computed once a texel) and runs the 5x5 stencil there: 1.7 texels
//   staged per output at every step. The 3x3 variance prefilter reads
//   immediate neighbours, which for step > 1 belong to other classes;
//   those nine reads go through L1/L2.
// - Direct path: one thread a pixel of a 32x8 or 128x2 tile of the image,
//   every tap through L1/L2, the five wrapped rows and columns of a
//   pixel's taps computed once. It takes every shape (the full modulo
//   wrap), and on the 512^2 frame it beats the staged path from step 2
//   on: at steps > 1 a staged float4 fills half a 32-byte sector and the
//   prefilter's reads share no sector with the block's other threads,
//   while the direct path's warps read whole rows that L1 keeps across
//   taps (128x2 blocks share each tap row between four warps, which wins
//   from step 8 on). The wrapper picks the path per step
//   (kernels/atrous_pallas._path, from PERF.md's measurements).
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32, kTY = 8;           // outputs a block
constexpr int kHalo = 2;                   // stencil radius in the class
constexpr int kSX = kTX + 2 * kHalo, kSY = kTY + 2 * kHalo;
constexpr int kThreads = kTX * kTY;
constexpr float kNegLog2e = -1.4426950408889634f;

// a mod n in [0, n), for any int a
__device__ __forceinline__ int wrap(int a, int n) {
  if ((unsigned)a < (unsigned)n) return a;
  a %= n;
  return a < 0 ? a + n : a;
}

// Rec.709 luminance, rounded as core/math.luminance's torch ops round it
__device__ __forceinline__ float lum(float4 c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c.x, 0.2126f), __fmul_rn(c.y, 0.7152f)),
                   __fmul_rn(c.z, 0.0722f));
}

// the 1-D B3-spline weights (1/16, 1/4, 3/8, 1/4, 1/16)
__device__ __forceinline__ constexpr float b3(int i) {
  return i == 2 ? 3.0f / 8 : (i == 1 || i == 3) ? 1.0f / 4 : 1.0f / 16;
}

// 2^x in one MUFU.EX2; results below 2^-126 flush to 0 (weights that
// small move no output by an ulp)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would drop it); one
// instruction
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(lo));
  return r;
}

// The weighted 5x5 sum at one pixel. c0/g0/l0: the centre texel (colour+
// variance, normal+depth, luminance); var_w: the prefiltered variance;
// tap(i, j, c, g, l) fetches tap (i, j), i.e. offset ((2-i)*step,
// (2-j)*step) from the centre. Returns (colour, variance).
template <class Tap>
__device__ __forceinline__ float4 filter(float4 c0, float4 g0, float l0,
                                         float var_w, int step, Tap tap) {
  const float sig_l = 4.0f * sqrtf(clamp_lo(var_w, 1e-10f)) + 1e-8f;
  const float sig_z = __fadd_rn(
      __fmul_rn((float)step, __fadd_rn(__fmul_rn(fabsf(g0.w), 0.02f), 1e-2f)),
      1e-8f);
  const float rz = kNegLog2e / sig_z, rl = kNegLog2e / sig_l;
  float ac0 = 0.0f, ac1 = 0.0f, ac2 = 0.0f, av = 0.0f, aw = 0.0f;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float k = b3(i) * b3(j);       // exact: 2^-n and 3/8 products
      float4 c;
      float w;
      if (i == 2 && j == 2) {
        c = c0;
        w = k;
      } else {
        float4 g;
        float l;
        tap(i, j, c, g, l);
        const float nd = __fadd_rn(__fadd_rn(__fmul_rn(g0.x, g.x),
                                             __fmul_rn(g0.y, g.y)),
                                   __fmul_rn(g0.z, g.z));
        float m = clamp_lo(nd, 0.0f);
#pragma unroll
        for (int r = 0; r < 7; ++r) m *= m;        // ^128
        const float e = ex2(fabsf(g0.w - g.w) * rz + fabsf(l0 - l) * rl);
        w = m * e * k;
      }
      ac0 += c.x * w;
      ac1 += c.y * w;
      ac2 += c.z * w;
      av += c.w * (w * w);
      aw += w;
    }
  }
  const float inv = 1.0f / clamp_lo(aw, 1e-8f);
  return make_float4(ac0 * inv, ac1 * inv, ac2 * inv, av * inv * inv);
}

// 3x3 (1,2,1)^2 prefilter of the variance, summed in the plain
// _var_prefilter3's order; v(oy, ox) is the variance at offset (oy, ox)
template <class V>
__device__ __forceinline__ float prefilter(V v) {
  float acc = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float k = (dy == 0 ? 2.0f : 1.0f) * (dx == 0 ? 2.0f : 1.0f);
      acc = __fadd_rn(acc, __fmul_rn(v(-dy, -dx), k));
    }
  return acc * (1.0f / 16.0f);
}

// The prefilter at (y, x) from the variance in cv, through L1/L2; the
// three wrapped rows and columns are computed once
__device__ __forceinline__ float prefilter_global(
    const float4* __restrict__ cv, int y, int x, int H, int W) {
  int row[3], col[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    row[o] = wrap(y + o - 1, H) * W;
    col[o] = wrap(x + o - 1, W);
  }
  return prefilter([&](int oy, int ox) {
    return __ldg(reinterpret_cast<const float*>(cv + row[oy + 1] +
                                                col[ox + 1]) + 3);
  });
}

// Staged path: grid (ceil(Ws/32), ceil(Hs/8), step^2), one block per tile
// of one residue class's (H/step) x (W/step) sub-image.
__global__ void __launch_bounds__(kThreads)
atrous_staged(const float4* __restrict__ cv, const float4* __restrict__ nz,
              float4* __restrict__ out, int H, int W, int step) {
  __shared__ float4 s_cv[kSY * kSX];
  __shared__ float4 s_nz[kSY * kSX];
  __shared__ float s_l[kSY * kSX];
  const int Hs = H / step, Ws = W / step;
  const int ry = blockIdx.z / step, rx = blockIdx.z - ry * step;
  const int ty0 = blockIdx.y * kTY, tx0 = blockIdx.x * kTX;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  for (int k = tid; k < kSY * kSX; k += kThreads) {
    const int ly = k / kSX, lx = k - ly * kSX;
    const int p = (ry + step * wrap(ty0 + ly - kHalo, Hs)) * W + rx +
                  step * wrap(tx0 + lx - kHalo, Ws);
    const float4 c = __ldg(cv + p);
    s_cv[k] = c;
    s_nz[k] = __ldg(nz + p);
    s_l[k] = lum(c);
  }
  __syncthreads();
  const int sy = ty0 + threadIdx.y, sx = tx0 + threadIdx.x;
  if (sy >= Hs || sx >= Ws) return;
  const int y = ry + step * sy, x = rx + step * sx;
  const int o = (threadIdx.y + kHalo) * kSX + threadIdx.x + kHalo;
  float var_w;
  if (step == 1) {
    var_w = prefilter(
        [&](int oy, int ox) { return s_cv[o + oy * kSX + ox].w; });
  } else {
    var_w = prefilter_global(cv, y, x, H, W);
  }
  out[y * W + x] = filter(
      s_cv[o], s_nz[o], s_l[o], var_w, step,
      [&](int i, int j, float4& c, float4& g, float& l) {
        const int q = o + (2 - i) * kSX + (2 - j);
        c = s_cv[q];
        g = s_nz[q];
        l = s_l[q];
      });
}

// Direct path: one thread a pixel of a tile of the image (blocks of 256
// threads, 32x8 or 128x2), every tap from L1/L2 with the full cyclic wrap.
__global__ void __launch_bounds__(kThreads)
atrous_direct(const float4* __restrict__ cv, const float4* __restrict__ nz,
              float4* __restrict__ out, int H, int W, int step) {
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= H || x >= W) return;
  // tap (i, j) reads row[i] + col[j]: ten wraps a pixel, not 48
  int row[5], col[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    row[i] = wrap(y + (2 - i) * step, H) * W;
    col[i] = wrap(x + (2 - i) * step, W);
  }
  const float4 c0 = __ldg(cv + y * W + x);
  out[y * W + x] = filter(
      c0, __ldg(nz + y * W + x), lum(c0), prefilter_global(cv, y, x, H, W),
      step, [&](int i, int j, float4& c, float4& g, float& l) {
        c = __ldg(cv + row[i] + col[j]);
        g = __ldg(nz + row[i] + col[j]);
        l = lum(c);
      });
}

}  // namespace

// Whether the staged path takes (H, W, step): step divides both, and the
// step^2 residue classes fit the grid's z dimension (65535).
extern "C" int tt_atrous_staged_ok(int H, int W, int step) {
  return step >= 1 && step < 256 && H % step == 0 && W % step == 0;
}

// cv, out: [H,W] float4 (colour.rgb, variance); nz: [H,W] float4
// (normal.xyz, depth); all 16-byte aligned, out not aliasing cv. path:
// 0 staged (needs tt_atrous_staged_ok), 1 direct in 32x8 blocks, 2 direct
// in 128x2 blocks (wider rows share more of each tap row in L1).
extern "C" int tt_atrous_pass(const void* cv, const void* nz, void* out,
                              int H, int W, int step, int path,
                              void* stream) {
  if (H <= 0 || W <= 0 || step < 1 || path < 0 || path > 2 ||
      (path == 0 && !tt_atrous_staged_ok(H, W, step)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* c = static_cast<const float4*>(cv);
  const float4* g = static_cast<const float4*>(nz);
  float4* o = static_cast<float4*>(out);
  if (path == 0) {
    const int Hs = H / step, Ws = W / step;
    const dim3 grid((Ws + kTX - 1) / kTX, (Hs + kTY - 1) / kTY,
                    step * step);
    atrous_staged<<<grid, dim3(kTX, kTY), 0, s>>>(c, g, o, H, W, step);
  } else {
    const dim3 block = path == 1 ? dim3(kTX, kTY) : dim3(128, 2);
    const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    atrous_direct<<<grid, block, 0, s>>>(c, g, o, H, W, step);
  }
  return (int)cudaGetLastError();
}
