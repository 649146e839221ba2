// SVGF edge-aware a-trous pass (one of the 5 per frame), one thread per
// pixel, both outputs from one kernel.
//
// Replaces truetrace_tpu/kernels/atrous_pallas.py atrous_pass_pallas
// (:110), which needed the whole image in VMEM and so never ran at 512^2
// (atrous_fits_vmem is false there). Same arithmetic as the plain
// post/svgf._atrous_pass, in the same order: a 3x3 (1,2,1)^2 prefilter of
// the variance at the centre pixel gives sigma_l; 25 B3-spline taps at
// ((i-2)*step, (j-2)*step) are weighted by
// k * max(n.n_q,0)^128 * exp(-|dz|/sigma_z) * exp(-|dlum|/sigma_l)
// (centre tap: k); out colour = sum(w c)/sum(w), var = sum(w^2 var)/
// (sum w)^2. Borders wrap cyclically, as jnp.roll / torch.roll do: tap
// (dy, dx) of pixel (y, x) reads ((y - dy) mod H, (x - dx) mod W).
//
// What bounds it: memory traffic (8 floats read per tap if nothing were
// reused). For step <= 4 each 16x16 block stages its tile plus a halo of
// 2*step pixels (colour, var, normal, depth and luminance: 9 floats per
// texel, <= 37 KB) in shared memory; beyond that the halo outgrows the
// tile and taps read global memory directly (the 512^2 frame's 9 MB of
// inputs stay in the 50 MB L2).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kMaxHalo = 8;        // shared-memory path: step <= 4
constexpr int kSpan = kTile + 2 * kMaxHalo;

__device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

__device__ __forceinline__ float lum3(float r, float g, float b) {
  return r * 0.2126f + g * 0.7152f + b * 0.0722f;
}

// B3-spline weights k = ky * kx, rounded from the double product as the
// Python versions do
__device__ __forceinline__ float tap_k(int i, int j) {
  const double k1[5] = {1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16};
  return (float)(k1[i] * k1[j]);
}

struct Texel {
  float c[3], var, n[3], z, lum;
};

template <bool kShared>
__global__ void atrous_kernel(const float* __restrict__ color,
                              const float* __restrict__ var,
                              const float* __restrict__ normal,
                              const float* __restrict__ depth,
                              float* __restrict__ out_c,
                              float* __restrict__ out_v, int H, int W,
                              int step) {
  __shared__ float sm[kShared ? 9 * kSpan * kSpan : 1];
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const int halo = 2 * step;
  const int span = kTile + 2 * halo;

  auto load = [&](int gy, int gx) {
    Texel t;
    const int p = wrap(gy, H) * W + wrap(gx, W);
    t.c[0] = color[3 * p];
    t.c[1] = color[3 * p + 1];
    t.c[2] = color[3 * p + 2];
    t.var = var[p];
    t.n[0] = normal[3 * p];
    t.n[1] = normal[3 * p + 1];
    t.n[2] = normal[3 * p + 2];
    t.z = depth[p];
    t.lum = lum3(t.c[0], t.c[1], t.c[2]);
    return t;
  };

  if (kShared) {
    const int y0 = blockIdx.y * kTile - halo;
    const int x0 = blockIdx.x * kTile - halo;
    for (int k = threadIdx.y * kTile + threadIdx.x; k < span * span;
         k += kTile * kTile) {
      const int ly = k / span, lx = k % span;
      const Texel t = load(y0 + ly, x0 + lx);
      float* s = sm + 9 * k;
      s[0] = t.c[0]; s[1] = t.c[1]; s[2] = t.c[2]; s[3] = t.var;
      s[4] = t.n[0]; s[5] = t.n[1]; s[6] = t.n[2]; s[7] = t.z;
      s[8] = t.lum;
    }
    __syncthreads();
  }
  if (x >= W || y >= H) return;

  // texel at offset (oy, ox) from this pixel, cyclic
  auto at = [&](int oy, int ox) {
    if (kShared) {
      const float* s = sm + 9 * ((threadIdx.y + halo + oy) * span +
                                 threadIdx.x + halo + ox);
      Texel t;
      t.c[0] = s[0]; t.c[1] = s[1]; t.c[2] = s[2]; t.var = s[3];
      t.n[0] = s[4]; t.n[1] = s[5]; t.n[2] = s[6]; t.z = s[7];
      t.lum = s[8];
      return t;
    }
    return load(y + oy, x + ox);
  };

  const Texel ctr = at(0, 0);
  // 3x3 variance prefilter at the centre (post/svgf._var_prefilter3)
  float acc = 0.0f;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      const float k = (dy == 0 ? 2.0f : 1.0f) * (dx == 0 ? 2.0f : 1.0f);
      acc = acc + at(-dy, -dx).var * k;
    }
  const float var_w = acc / 16.0f;
  const float sig_l = 4.0f * sqrtf(fmaxf(var_w, 1e-10f)) + 1e-8f;
  const float sig_z =
      (float)step * (fabsf(ctr.z) * 0.02f + 1e-2f) + 1e-8f;

  float ac0 = 0.0f, ac1 = 0.0f, ac2 = 0.0f, av = 0.0f, aw = 0.0f;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j) {
      const int dy = (i - 2) * step, dx = (j - 2) * step;
      const Texel q = at(-dy, -dx);
      const float k = tap_k(i, j);
      float w;
      if (dy == 0 && dx == 0) {
        w = k;
      } else {
        const float nd = ctr.n[0] * q.n[0] + ctr.n[1] * q.n[1] +
                         ctr.n[2] * q.n[2];
        const float w_n = powf(fmaxf(nd, 0.0f), 128.0f);
        const float w_z = expf(-fabsf(ctr.z - q.z) / sig_z);
        const float w_l = expf(-fabsf(ctr.lum - q.lum) / sig_l);
        w = w_n * w_z * w_l * k;
      }
      ac0 = ac0 + q.c[0] * w;
      ac1 = ac1 + q.c[1] * w;
      ac2 = ac2 + q.c[2] * w;
      av = av + q.var * (w * w);
      aw = aw + w;
    }
  const float inv = 1.0f / fmaxf(aw, 1e-8f);
  const int p = y * W + x;
  out_c[3 * p] = ac0 * inv;
  out_c[3 * p + 1] = ac1 * inv;
  out_c[3 * p + 2] = ac2 * inv;
  out_v[p] = av * inv * inv;
}

}  // namespace

extern "C" int tt_atrous_pass(const void* color, const void* var,
                              const void* normal, const void* depth,
                              void* out_c, void* out_v, int H, int W,
                              int step, void* stream) {
  if (H <= 0 || W <= 0 || step < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(kTile, kTile);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(color);
  const float* v = static_cast<const float*>(var);
  const float* n = static_cast<const float*>(normal);
  const float* z = static_cast<const float*>(depth);
  if (2 * step <= kMaxHalo) {
    atrous_kernel<true><<<grid, block, 0, s>>>(
        c, v, n, z, static_cast<float*>(out_c), static_cast<float*>(out_v),
        H, W, step);
  } else {
    atrous_kernel<false><<<grid, block, 0, s>>>(
        c, v, n, z, static_cast<float*>(out_c), static_cast<float*>(out_v),
        H, W, step);
  }
  return (int)cudaGetLastError();
}
