// Standalone launch of the traversal step core, with the layout contract
// of truetrace_tpu/kernels/step_pallas.py step_core (:120), which it
// replaces:
//   rowt [32, R] u32 : lane-major unified-table rows (30 words + 2 pad)
//   ray9 [9, R]  f32 : ro, rd, inv_rd
//   st5  [5, R]  u32 : t_best, tri_best, u, v (bits), leaf_lane (0/1)
//   out  [7, R]  u32 : t, tri, u, v, c_hits, c_chim, c_bleaf
// One thread per lane runs tt::step_core_dev, the same device code the
// traversal kernel (traverse.cu) runs every iteration. Bounded by memory
// traffic: 53 words in and 7 out per lane, read coalesced along R.
#include "cwbvh_core.cuh"

namespace {

__global__ void step_core_kernel(const uint32_t* __restrict__ rowt,
                                 const float* __restrict__ ray9,
                                 const uint32_t* __restrict__ st5,
                                 uint32_t* __restrict__ out, int R,
                                 int write_uv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  tt::Ray r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = ray9[(size_t)a * R + i];
    r.d[a] = ray9[(size_t)(3 + a) * R + i];
    r.inv[a] = ray9[(size_t)(6 + a) * R + i];
  }
  float t = __uint_as_float(st5[i]);
  int tri = (int)st5[(size_t)R + i];
  float u = __uint_as_float(st5[(size_t)2 * R + i]);
  float v = __uint_as_float(st5[(size_t)3 * R + i]);
  const bool leaf_lane = st5[(size_t)4 * R + i] != 0u;
  uint32_t hits, chim, bleaf;
  tt::step_core_dev(rowt + i, R, 3, r, leaf_lane, write_uv != 0, t, tri, u,
                    v, hits, chim, bleaf);
  out[i] = __float_as_uint(t);
  out[(size_t)R + i] = (uint32_t)tri;
  out[(size_t)2 * R + i] = __float_as_uint(u);
  out[(size_t)3 * R + i] = __float_as_uint(v);
  out[(size_t)4 * R + i] = hits;
  out[(size_t)5 * R + i] = chim;
  out[(size_t)6 * R + i] = bleaf;
}

}  // namespace

extern "C" int tt_step_core(const void* rowt, const void* ray9,
                            const void* st5, void* out, int R, int write_uv,
                            void* stream) {
  if (R == 0) return (int)cudaSuccess;
  const int block = 256;
  step_core_kernel<<<(R + block - 1) / block, block, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rowt), static_cast<const float*>(ray9),
      static_cast<const uint32_t*>(st5), static_cast<uint32_t*>(out), R,
      write_uv);
  return (int)cudaGetLastError();
}
