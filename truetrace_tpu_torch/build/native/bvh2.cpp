// Native binned-SAH BVH2 builder — C++ fast path for San-Miguel-scale
// scenes where the numpy builder's per-node Python overhead dominates.
//
// Role-equivalent of the reference's C# unsafe builders
// (Builders/BVH2Builder.cs — full-sweep SAH over NativeArray pointers);
// algorithmic contract matches truetrace_tpu/build/bvh2.py exactly:
//   - 16-bin binned SAH on the widest centroid axis
//   - leaf when count <= max_leaf, or SAH early-out when count <= sah_cap
//   - output: box [N][2][3], left [N], count [N] (internal: right=left+1),
//     order [T] permutation, depth-first allocation order
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float half_area(const Vec3& lo, const Vec3& hi) {
  float dx = std::max(hi.x - lo.x, 0.f);
  float dy = std::max(hi.y - lo.y, 0.f);
  float dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dy * dz + dz * dx;
}

struct Builder {
  const float* boxes;  // [T][2][3]
  int max_leaf, sah_cap;
  std::vector<Vec3> lo, hi, cent;
  std::vector<int32_t> order;
  // output arrays (grown as we go)
  std::vector<float> out_box;     // N*6
  std::vector<int32_t> out_left, out_count;
  int max_depth = 0;

  int alloc(int k) {
    int i = static_cast<int>(out_left.size());
    out_left.resize(i + k);
    out_count.resize(i + k);
    out_box.resize((i + k) * 6);
    return i;
  }

  void build(int node, int s, int e, int depth) {
    max_depth = std::max(max_depth, depth);
    Vec3 nlo = {kInf, kInf, kInf}, nhi = {-kInf, -kInf, -kInf};
    Vec3 clo = {kInf, kInf, kInf}, chi = {-kInf, -kInf, -kInf};
    for (int i = s; i < e; ++i) {
      int t = order[i];
      nlo = vmin(nlo, lo[t]);
      nhi = vmax(nhi, hi[t]);
      clo = vmin(clo, cent[t]);
      chi = vmax(chi, cent[t]);
    }
    float* bx = &out_box[node * 6];
    bx[0] = nlo.x; bx[1] = nlo.y; bx[2] = nlo.z;
    bx[3] = nhi.x; bx[4] = nhi.y; bx[5] = nhi.z;
    int n = e - s;
    if (n <= max_leaf) {
      out_left[node] = s;
      out_count[node] = n;
      return;
    }
    float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] <= 1e-12f) {
      mid = s + n / 2;
    } else {
      float cmin = axis == 0 ? clo.x : (axis == 1 ? clo.y : clo.z);
      float scale = kBins * (1.f - 1e-6f) / ext[axis];
      int cnt[kBins] = {0};
      Vec3 blo[kBins], bhi[kBins];
      for (int b = 0; b < kBins; ++b) {
        blo[b] = {kInf, kInf, kInf};
        bhi[b] = {-kInf, -kInf, -kInf};
      }
      auto bin_of = [&](int t) {
        float c = axis == 0 ? cent[t].x : (axis == 1 ? cent[t].y : cent[t].z);
        int b = static_cast<int>((c - cmin) * scale);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int i = s; i < e; ++i) {
        int t = order[i];
        int b = bin_of(t);
        cnt[b]++;
        blo[b] = vmin(blo[b], lo[t]);
        bhi[b] = vmax(bhi[b], hi[t]);
      }
      // prefix sweeps
      float lcost[kBins - 1], rcost[kBins - 1];
      int lcnt[kBins - 1];
      {
        Vec3 alo = {kInf, kInf, kInf}, ahi = {-kInf, -kInf, -kInf};
        int ac = 0;
        for (int b = 0; b < kBins - 1; ++b) {
          alo = vmin(alo, blo[b]);
          ahi = vmax(ahi, bhi[b]);
          ac += cnt[b];
          lcnt[b] = ac;
          lcost[b] = ac ? half_area(alo, ahi) * ac : kInf;
        }
        alo = {kInf, kInf, kInf};
        ahi = {-kInf, -kInf, -kInf};
        ac = 0;
        for (int b = kBins - 1; b >= 1; --b) {
          alo = vmin(alo, blo[b]);
          ahi = vmax(ahi, bhi[b]);
          ac += cnt[b];
          rcost[b - 1] = ac ? half_area(alo, ahi) * ac : kInf;
        }
      }
      int best = -1;
      float best_cost = kInf;
      for (int b = 0; b < kBins - 1; ++b) {
        if (lcnt[b] == 0 || lcnt[b] == n) continue;
        float c = lcost[b] + rcost[b];
        if (c < best_cost) {
          best_cost = c;
          best = b;
        }
      }
      if (best < 0) {
        mid = s + n / 2;
      } else {
        float node_area = half_area(nlo, nhi);
        float leaf_cost = n * node_area;
        float split_cost = node_area + best_cost;
        if (leaf_cost <= split_cost && n <= sah_cap) {
          out_left[node] = s;
          out_count[node] = n;
          return;
        }
        // stable partition
        auto it = std::stable_partition(
            order.begin() + s, order.begin() + e,
            [&](int t) { return bin_of(t) <= best; });
        mid = static_cast<int>(it - order.begin());
        if (mid == s || mid == e) mid = s + n / 2;
      }
    }
    int child = alloc(2);
    out_left[node] = child;
    out_count[node] = 0;
    build(child, s, mid, depth + 1);
    build(child + 1, mid, e, depth + 1);
  }
};

}  // namespace

extern "C" {

// Returns node count; caller passes pre-sized outputs via bvh2_emit.
// Two-call protocol: build once (state kept in a heap object), emit, free.
void* bvh2_build(const float* prim_box, int32_t n_prims, int32_t max_leaf,
                 int32_t sah_cap, int32_t* out_n_nodes,
                 int32_t* out_depth) {
  auto* b = new Builder();
  b->boxes = prim_box;
  b->max_leaf = max_leaf;
  b->sah_cap = sah_cap;
  b->lo.resize(n_prims);
  b->hi.resize(n_prims);
  b->cent.resize(n_prims);
  b->order.resize(n_prims);
  for (int t = 0; t < n_prims; ++t) {
    const float* p = prim_box + t * 6;
    b->lo[t] = {p[0], p[1], p[2]};
    b->hi[t] = {p[3], p[4], p[5]};
    b->cent[t] = {(p[0] + p[3]) * 0.5f, (p[1] + p[4]) * 0.5f,
                  (p[2] + p[5]) * 0.5f};
    b->order[t] = t;
  }
  int root = b->alloc(1);
  b->build(root, 0, n_prims, 1);
  *out_n_nodes = static_cast<int32_t>(b->out_left.size());
  *out_depth = b->max_depth;
  return b;
}

void bvh2_emit(void* handle, float* box, int32_t* left, int32_t* count,
               int32_t* order) {
  auto* b = static_cast<Builder*>(handle);
  std::memcpy(box, b->out_box.data(), b->out_box.size() * sizeof(float));
  std::memcpy(left, b->out_left.data(),
              b->out_left.size() * sizeof(int32_t));
  std::memcpy(count, b->out_count.data(),
              b->out_count.size() * sizeof(int32_t));
  std::memcpy(order, b->order.data(), b->order.size() * sizeof(int32_t));
}

void bvh2_free(void* handle) { delete static_cast<Builder*>(handle); }

}  // extern "C"
