// CWBVH collapse (Ylitie 2017 DP) — native fast path.
//
// Mirrors build/cwbvh.py::build_cwbvh exactly (same DP recurrences, greedy
// octant slot assignment, BFS emit and 20-word node packing) so the Python
// and native builders are interchangeable; the contract is documented in
// the Python module. Reference counterpart: Builders/BVH8Builder.cs (C#
// unsafe) — flagged [NATIVE-EQUIV] in SURVEY.md section 2.
//
// C ABI (ctypes, see build/native/loader.py):
//   cwbvh_build(box, left, count, n2, n_nodes*, n_tri*, depth*) -> handle
//   cwbvh_emit(handle, nodes, tri_index, leaf_start, node_depth,
//              slot_child, slot_tri_base, slot_tri_count)
//   cwbvh_free(handle)

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <vector>

namespace {

constexpr double C_NODE = 1.0;
constexpr double C_PRIM = 0.3;
constexpr double INF = std::numeric_limits<double>::infinity();

struct CWResult {
  std::vector<uint32_t> nodes;        // C*20
  std::vector<int32_t> tri_index;     // T
  std::vector<int32_t> leaf_start;    // N2
  std::vector<int32_t> node_depth;    // C
  std::vector<int32_t> slot_child;    // C*8
  std::vector<int32_t> slot_tri_base; // C*8
  std::vector<int32_t> slot_tri_cnt;  // C*8
  int32_t depth = 1;
};

struct Builder {
  const float* box;    // [N2][2][3]
  const int32_t* left;
  const int32_t* count;
  int32_t n2;
  int32_t p_max = 3;   // max tris per leaf slot (fat-leaf rows use 6/12)

  std::vector<double> cost;    // [n2*7]
  std::vector<int8_t> decision;
  CWResult out;

  double blo(int n, int k) const { return box[n * 6 + k]; }
  double bhi(int n, int k) const { return box[n * 6 + 3 + k]; }

  void dp() {
    cost.assign((size_t)n2 * 7, INF);
    decision.assign((size_t)n2 * 7, 0);
    // iterative post order
    std::vector<int32_t> post;
    post.reserve(n2);
    std::vector<int32_t> stack{0};
    while (!stack.empty()) {
      int n = stack.back();
      stack.pop_back();
      post.push_back(n);
      if (count[n] == 0) {
        stack.push_back(left[n]);
        stack.push_back(left[n] + 1);
      }
    }
    for (auto it = post.rbegin(); it != post.rend(); ++it) {
      int n = *it;
      double dx = std::max(bhi(n, 0) - blo(n, 0), 0.0);
      double dy = std::max(bhi(n, 1) - blo(n, 1), 0.0);
      double dz = std::max(bhi(n, 2) - blo(n, 2), 0.0);
      double a = dx * dy + dy * dz + dz * dx;
      double* cn = &cost[(size_t)n * 7];
      int8_t* dn = &decision[(size_t)n * 7];
      if (count[n] > 0) {
        int p = count[n];
        double c_leaf = p <= p_max ? a * p * C_PRIM : INF;
        for (int i = 0; i < 7; i++) { cn[i] = c_leaf; dn[i] = 0; }
        continue;
      }
      const double* cl = &cost[(size_t)left[n] * 7];
      const double* cr = &cost[(size_t)(left[n] + 1) * 7];
      double dist[8];
      int8_t dist_k[8];
      for (int i = 0; i < 8; i++) { dist[i] = INF; dist_k[i] = 0; }
      for (int j = 2; j <= 8; j++) {
        double best = INF;
        int bk = 1;
        for (int k = 1; k < j; k++) {
          if (k <= 7 && (j - k) <= 7) {
            double c = cl[k - 1] + cr[j - k - 1];
            if (c < best) { best = c; bk = k; }
          }
        }
        dist[j - 1] = best;
        dist_k[j - 1] = (int8_t)bk;
      }
      double c_internal = a * C_NODE + dist[7];
      cn[0] = c_internal;
      dn[0] = 1;
      for (int i = 1; i < 7; i++) {
        if (dist[i] < cn[i - 1]) {
          cn[i] = dist[i];
          dn[i] = (int8_t)(1 + dist_k[i]);
        } else {
          cn[i] = cn[i - 1];
          dn[i] = dn[i - 1];
        }
      }
    }
  }

  void get_children(int n, int i, std::vector<int32_t>& outv) {
    int d = decision[(size_t)n * 7 + i];
    if (d == 0 || d == 1) { outv.push_back(n); return; }
    int k = d - 1;
    get_children(left[n], k - 1, outv);
    get_children(left[n] + 1, i - k, outv);
  }

  std::vector<int32_t> expand_internal(int n) {
    std::vector<int32_t> ch;
    int l = left[n], r = left[n] + 1;
    double best = INF;
    int bk = 1;
    for (int k = 1; k < 8; k++) {
      double c = cost[(size_t)l * 7 + (k - 1)] +
                 cost[(size_t)r * 7 + (8 - k - 1)];
      if (c < best) { best = c; bk = k; }
    }
    get_children(l, bk - 1, ch);
    get_children(r, 8 - bk - 1, ch);
    return ch;
  }

  int emit_internal() {
    out.nodes.insert(out.nodes.end(), 20, 0u);
    out.node_depth.push_back(1);
    out.slot_child.insert(out.slot_child.end(), 8, -1);
    out.slot_tri_base.insert(out.slot_tri_base.end(), 8, -1);
    out.slot_tri_cnt.insert(out.slot_tri_cnt.end(), 8, 0);
    return (int)(out.nodes.size() / 20) - 1;
  }

  void collapse() {
    dp();
    out.leaf_start.assign(n2, -1);

    std::deque<std::pair<int, std::vector<int32_t>>> queue;
    std::vector<int32_t> depth_of;   // per emitted node
    std::vector<int32_t> root_children;
    if (count[0] > 0) root_children = {0};
    else root_children = expand_internal(0);
    int root_id = emit_internal();
    depth_of.push_back(1);
    queue.emplace_back(root_id, root_children);
    out.depth = 1;

    struct Pair { double d; int s; int ci; };

    while (!queue.empty()) {
      auto [node_id, children] = std::move(queue.front());
      queue.pop_front();
      int d_here = depth_of[node_id];
      int n_ch = (int)children.size();

      double c_lo[3], c_hi[3];
      for (int k = 0; k < 3; k++) { c_lo[k] = INF; c_hi[k] = -INF; }
      for (int c : children)
        for (int k = 0; k < 3; k++) {
          c_lo[k] = std::min(c_lo[k], blo(c, k));
          c_hi[k] = std::max(c_hi[k], bhi(c, k));
        }

      int64_t e_b[3];
      double scale[3];
      for (int k = 0; k < 3; k++) {
        double ext = std::max(c_hi[k] - c_lo[k], 0.0);
        if (ext <= 0) e_b[k] = 1;
        else {
          int64_t e = (int64_t)std::ceil(std::log2(ext / 255.0));
          e_b[k] = std::min<int64_t>(std::max<int64_t>(e + 127, 1), 254);
        }
        scale[k] = std::exp2((double)e_b[k] - 127.0);
      }

      // greedy octant slot assignment (same ordering as the Python sort
      // on (-dot, slot, child) tuples)
      double parent_c[3];
      for (int k = 0; k < 3; k++) parent_c[k] = 0.5 * (c_lo[k] + c_hi[k]);
      std::vector<std::array<double, 3>> dirs(n_ch);
      for (int ci = 0; ci < n_ch; ci++) {
        int c = children[ci];
        double v[3], nv = 0;
        for (int k = 0; k < 3; k++) {
          v[k] = 0.5 * (blo(c, k) + bhi(c, k)) - parent_c[k];
          nv += v[k] * v[k];
        }
        nv = std::sqrt(nv);
        for (int k = 0; k < 3; k++)
          dirs[ci][k] = nv > 1e-12 ? v[k] / nv : 0.0;
      }
      std::vector<Pair> pairs;
      pairs.reserve(8 * n_ch);
      const double inv_s3 = 1.0 / std::sqrt(3.0);
      for (int s = 0; s < 8; s++) {
        double ds[3] = {((s >> 0) & 1) ? inv_s3 : -inv_s3,
                        ((s >> 1) & 1) ? inv_s3 : -inv_s3,
                        ((s >> 2) & 1) ? inv_s3 : -inv_s3};
        for (int ci = 0; ci < n_ch; ci++) {
          double dot = ds[0] * dirs[ci][0] + ds[1] * dirs[ci][1] +
                       ds[2] * dirs[ci][2];
          pairs.push_back({-dot, s, ci});
        }
      }
      std::sort(pairs.begin(), pairs.end(), [](const Pair& a, const Pair& b) {
        if (a.d != b.d) return a.d < b.d;
        if (a.s != b.s) return a.s < b.s;
        return a.ci < b.ci;
      });
      int slot_of[8];
      for (int s = 0; s < 8; s++) slot_of[s] = -1;
      std::vector<char> assigned(n_ch, 0);
      bool used_slot[8] = {false};
      for (const auto& p : pairs) {
        if (!used_slot[p.s] && !assigned[p.ci]) {
          used_slot[p.s] = true;
          assigned[p.ci] = 1;
          slot_of[p.s] = p.ci;
        }
      }

      uint32_t imask = 0;
      uint32_t meta[8] = {0};
      int64_t qlo[8][3], qhi[8][3];
      std::vector<int32_t> internal_children;
      int base_tri = (int)out.tri_index.size();
      int tri_off = 0;
      for (int s = 0; s < 8; s++) {
        int ci = slot_of[s];
        if (ci < 0) {
          for (int k = 0; k < 3; k++) { qlo[s][k] = 255; qhi[s][k] = 0; }
          continue;
        }
        int c = children[ci];
        for (int k = 0; k < 3; k++) {
          double lo_q = std::floor((blo(c, k) - c_lo[k]) / scale[k]);
          double hi_q = std::ceil((bhi(c, k) - c_lo[k]) / scale[k]);
          qlo[s][k] = std::min<int64_t>(std::max<int64_t>((int64_t)lo_q, 0), 255);
          qhi[s][k] = std::min<int64_t>(std::max<int64_t>((int64_t)hi_q, 0), 255);
        }
        if (count[c] == 0 && decision[(size_t)c * 7] == 1) {
          imask |= (1u << s);
          meta[s] = 0b00100000u | (uint32_t)s;
          internal_children.push_back(c);
        } else {
          int ntri = count[c];
          // classic Ylitie meta byte (unary count, 5-bit offset) only
          // encodes <=3 tris / offset<=31; fat-leaf builds (p_max>3) use
          // a nonzero marker byte instead — every traversal consumer
          // reads slot_tri_base/cnt directly, meta only gates occupancy
          if (ntri <= 3 && tri_off <= 31) {
            uint32_t unary = (1u << ntri) - 1u;
            meta[s] = (unary << 5) | (uint32_t)tri_off;
          } else {
            meta[s] = 0b10000000u | (uint32_t)s;
          }
          out.leaf_start[c] = base_tri + tri_off;
          out.slot_tri_base[(size_t)node_id * 8 + s] = base_tri + tri_off;
          out.slot_tri_cnt[(size_t)node_id * 8 + s] = ntri;
          for (int t = 0; t < ntri; t++)
            out.tri_index.push_back(left[c] + t);
          tri_off += ntri;
        }
      }

      int base_child = (int)(out.nodes.size() / 20);
      for (int c : internal_children) {
        auto ch = expand_internal(c);
        int cid = emit_internal();
        depth_of.push_back(d_here + 1);
        out.depth = std::max(out.depth, d_here + 1);
        queue.emplace_back(cid, std::move(ch));
      }

      // refit metadata
      out.node_depth[node_id] = d_here;
      int rank = 0;
      for (int s = 0; s < 8; s++) {
        if (meta[s] == 0) continue;
        if (imask & (1u << s)) {
          out.slot_child[(size_t)node_id * 8 + s] = base_child + rank;
          rank++;
        }
        // leaf slots: slot_tri_base/cnt were written directly at emission
        // (the meta byte no longer round-trips counts in fat-leaf builds)
      }

      // pack the 20 words
      uint32_t* w = &out.nodes[(size_t)node_id * 20];
      for (int k = 0; k < 3; k++) {
        float f = (float)c_lo[k];
        std::memcpy(&w[k], &f, 4);
      }
      w[3] = (uint32_t)e_b[0] | ((uint32_t)e_b[1] << 8) |
             ((uint32_t)e_b[2] << 16) | (imask << 24);
      w[4] = (uint32_t)base_child;
      w[5] = (uint32_t)base_tri;
      w[6] = meta[0] | (meta[1] << 8) | (meta[2] << 16) | (meta[3] << 24);
      w[7] = meta[4] | (meta[5] << 8) | (meta[6] << 16) | (meta[7] << 24);
      for (int axis = 0; axis < 3; axis++) {
        uint32_t lo0 = 0, lo1 = 0, hi0 = 0, hi1 = 0;
        for (int s = 0; s < 4; s++) {
          lo0 |= (uint32_t)qlo[s][axis] << (8 * s);
          lo1 |= (uint32_t)qlo[s + 4][axis] << (8 * s);
          hi0 |= (uint32_t)qhi[s][axis] << (8 * s);
          hi1 |= (uint32_t)qhi[s + 4][axis] << (8 * s);
        }
        w[8 + 2 * axis] = lo0;
        w[9 + 2 * axis] = lo1;
        w[14 + 2 * axis] = hi0;
        w[15 + 2 * axis] = hi1;
      }
    }
  }
};

}  // namespace

extern "C" {

void* cwbvh_build(const float* box, const int32_t* left,
                  const int32_t* count, int32_t n2, int32_t p_max,
                  int32_t* n_nodes, int32_t* n_tri, int32_t* depth) {
  auto* b = new Builder{box, left, count, n2};
  b->p_max = p_max > 0 ? p_max : 3;
  b->collapse();
  *n_nodes = (int32_t)(b->out.nodes.size() / 20);
  *n_tri = (int32_t)b->out.tri_index.size();
  *depth = b->out.depth;
  return b;
}

void cwbvh_emit(void* h, uint32_t* nodes, int32_t* tri_index,
                int32_t* leaf_start, int32_t* node_depth,
                int32_t* slot_child, int32_t* slot_tri_base,
                int32_t* slot_tri_count) {
  auto* b = (Builder*)h;
  const CWResult& o = b->out;
  std::memcpy(nodes, o.nodes.data(), o.nodes.size() * 4);
  std::memcpy(tri_index, o.tri_index.data(), o.tri_index.size() * 4);
  std::memcpy(leaf_start, o.leaf_start.data(), o.leaf_start.size() * 4);
  std::memcpy(node_depth, o.node_depth.data(), o.node_depth.size() * 4);
  std::memcpy(slot_child, o.slot_child.data(), o.slot_child.size() * 4);
  std::memcpy(slot_tri_base, o.slot_tri_base.data(),
              o.slot_tri_base.size() * 4);
  std::memcpy(slot_tri_count, o.slot_tri_cnt.data(),
              o.slot_tri_cnt.size() * 4);
}

void cwbvh_free(void* h) { delete (Builder*)h; }

}  // extern "C"
