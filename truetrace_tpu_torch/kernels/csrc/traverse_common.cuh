// What the single-level (traverse.cu) and two-level (traverse_tlas.cu)
// traversal kernels share: their constants, the octant-ordered slot
// permutation, the outputs of a query, and the persistent-warp launch
// (the grid is the resident blocks per SM times the SM count).
#pragma once

#include <algorithm>
#include <cstdint>

#include "cwbvh_core.cuh"

namespace tt {

constexpr int kMaxStack = 32;
// cwbvh_wavefront._ITER_CAP, cwbvh_tlas's; a test build may lower it
// (tests/test_torch_cuda.py, with the plain version's ITER_CAP)
#ifndef TT_ITER_CAP
#define TT_ITER_CAP 65536
#endif
constexpr int kIterCap = TT_ITER_CAP;
constexpr int kBlock = 128;
constexpr int kRefillMin = 8;     // a warp refills once this many lanes idle
constexpr unsigned kAll = 0xFFFFFFFFu;
// query types (cwbvh_wavefront.CLOSEST, ANY, TRANSMIT)
constexpr int kClosest = 0, kAny = 1, kTransmit = 2;
constexpr float kOpaque = 1e-3f;  // cwbvh_wavefront.OPAQUE

__device__ __forceinline__ uint32_t xor_permute8(uint32_t m, uint32_t v) {
  if (v & 1u) m = ((m & 0xAAu) >> 1) | ((m & 0x55u) << 1);
  if (v & 2u) m = ((m & 0xCCu) >> 2) | ((m & 0x33u) << 2);
  if (v & 4u) m = ((m & 0xF0u) >> 4) | ((m & 0x0Fu) << 4);
  return m;
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}

// The outputs of a query: t, tri, u, v (and the instance, two-level) for
// the closest and any hit, or the transmittance [R,3] against the tint
// table [T,3].
struct Out {
  float* t;
  int* tri;
  float* u;
  float* v;
  int* inst;
  const float* tint;
  int T;
  float* tp;
};

// The persistent grid of `Kernel` with `smem` bytes of dynamic shared
// memory (its S-entry stack) for R rays: the resident blocks per SM,
// memoised per (kernel, S), times the SM count, and no more blocks than
// the rays fill; 0 when the occupancy query fails.
template <auto Kernel>
int persistent_grid(int S, size_t smem, int R) {
  static int memo[kMaxStack + 1] = {0};
  if (memo[S] == 0) {
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return 0;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, kBlock,
                                                      smem) != cudaSuccess)
      return 0;
    memo[S] = n;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::min((R + kBlock - 1) / kBlock, memo[S] * sms);
}

// The error of a launch whose grid came back 0.
inline int no_grid() {
  const cudaError_t e = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
}

}  // namespace tt

// The leaf widths with a compiled kernel; keep cwbvh_wavefront.CUDA_LEAF_K
// in step.
#define TT_FOR_EACH_K(X) X(3) X(4) X(5) X(6) X(8) X(12)
