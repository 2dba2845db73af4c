// Native binned-SAH BVH2 builder emitting the compact threaded node arrays.
//
// The framework's equivalent of the reference's Embree-driven BVH
// build + flatten step (host-side, C++ for speed on large scenes). The
// algorithm and output encoding match ipu_ray_lib_tpu/bvh/builder.py
// exactly (binned SAH, 16 bins, first-child-adjacent flatten with miss
// links, conservative fp16 round-up extents) so Python and native builds
// are interchangeable and unit-testable against each other.
//
// C ABI only; loaded from Python via ctypes (see bvh/cbuilder.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr int32_t kInvalidGeom = 0xFFFF;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

static inline float surface_area(const V3& lo, const V3& hi) {
  float dx = std::max(hi.x - lo.x, 0.f);
  float dy = std::max(hi.y - lo.y, 0.f);
  float dz = std::max(hi.z - lo.z, 0.f);
  return 2.f * (dx * dy + dy * dz + dz * dx);
}

// Software float32 -> float16 (round to nearest even), then bump one ulp
// up if the value shrank: conservative "not smaller" rounding so BVH
// boxes never shrink.
static uint16_t f32_to_f16_not_smaller(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFFu;
  uint16_t h;
  if (exp <= 0) {
    // Subnormal or zero:
    if (exp < -10) {
      h = (uint16_t)sign;
    } else {
      mant |= 0x800000u;
      int shift = 14 - exp;
      uint32_t sub = mant >> shift;
      uint32_t rem = mant & ((1u << shift) - 1);
      uint32_t half = 1u << (shift - 1);
      if (rem > half || (rem == half && (sub & 1))) sub += 1;
      h = (uint16_t)(sign | sub);
    }
  } else if (exp >= 31) {
    h = (uint16_t)(sign | 0x7C00u);  // inf
  } else {
    uint32_t rem = mant & 0x1FFFu;
    uint32_t sub = mant >> 13;
    uint16_t base = (uint16_t)(sign | (exp << 10) | sub);
    if (rem > 0x1000u || (rem == 0x1000u && (base & 1))) base += 1;
    h = base;
  }
  // Convert back and bump if smaller (positive extents only):
  auto h2f = [](uint16_t v) -> float {
    uint32_t s = (uint32_t)(v & 0x8000u) << 16;
    uint32_t e = (v >> 10) & 0x1F;
    uint32_t m = v & 0x3FFu;
    uint32_t out;
    if (e == 0) {
      if (m == 0) {
        out = s;
      } else {
        int sh = 0;
        while (!(m & 0x400u)) {
          m <<= 1;
          sh++;
        }
        m &= 0x3FFu;
        out = s | ((uint32_t)(127 - 15 - sh) << 23) | (m << 13);
      }
    } else if (e == 31) {
      out = s | 0x7F800000u | (m << 13);
    } else {
      out = s | ((e - 15 + 127) << 23) | (m << 13);
    }
    float r;
    std::memcpy(&r, &out, 4);
    return r;
  };
  if (h2f(h) < f) h += 1;
  return h;
}

struct Node {
  V3 lo, hi;
  int left = -1, right = -1;
  int64_t first = 0, count = 0;  // leaf primitive range into the ref array
};

// Contiguous per-primitive record, partitioned in place. Streaming the
// 32-byte refs beats the previous index-array design (every pass was a
// random gather through `order` on a machine with one core and a small
// cache); the double-precision centroid is recomputed from the f32
// bounds exactly as the old stored-centroid arrays were filled, so bin
// assignment is unchanged.
struct PrimRef {
  V3 lo, hi;
  int64_t id;
};

static inline double ref_cent(const PrimRef& r, int axis) {
  const float* lo = &r.lo.x;
  const float* hi = &r.hi.x;
  return 0.5 * ((double)lo[axis] + (double)hi[axis]);
}

// Centroid bounds (double, exact min/max — propagating the per-bin
// unions to children gives bitwise the same bounds a direct pass over
// the child range would).
struct CBounds {
  double lo[3], hi[3];
  void reset() {
    for (int a = 0; a < 3; ++a) {
      lo[a] = 1e300;
      hi[a] = -1e300;
    }
  }
  void add(const PrimRef& r) {
    for (int a = 0; a < 3; ++a) {
      double c = ref_cent(r, a);
      lo[a] = std::min(lo[a], c);
      hi[a] = std::max(hi[a], c);
    }
  }
  void merge(const CBounds& o) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], o.lo[a]);
      hi[a] = std::max(hi[a], o.hi[a]);
    }
  }
};

struct ChildInfo {
  V3 glo, ghi;  // geometry bounds
  CBounds cb;   // centroid bounds
  bool valid = false;
};

struct Builder {
  std::vector<PrimRef> refs;
  std::vector<Node> nodes;
  int32_t max_leaf;

  int make_node_b(const V3& lo, const V3& hi, int64_t first, int64_t count) {
    nodes.push_back(Node{lo, hi, -1, -1, first, count});
    return (int)nodes.size() - 1;
  }

  // One sequential pass computing both geometry and centroid bounds —
  // used for the root and the rare degenerate-split children where the
  // binned sweep didn't produce them.
  void range_bounds(int64_t first, int64_t count, V3* glo, V3* ghi,
                    CBounds* cb) {
    V3 lo{std::numeric_limits<float>::infinity(), INFINITY, INFINITY};
    V3 hi{-INFINITY, -INFINITY, -INFINITY};
    cb->reset();
    for (int64_t k = first; k < first + count; ++k) {
      const PrimRef& r = refs[k];
      lo = vmin(lo, r.lo);
      hi = vmax(hi, r.hi);
      cb->add(r);
    }
    *glo = lo;
    *ghi = hi;
  }

  // Partition [first, first+count); returns left count or 0 to make a
  // leaf. Centroid bounds come in from the parent's sweep; child
  // geometry AND centroid bounds go out via the per-bin accumulators
  // (exact min/max unions), so interior nodes cost two sequential
  // passes total (bin + partition) instead of the previous four
  // gather passes (centroid pass, bin pass, partition, per-child
  // bounds pass).
  int64_t split(int64_t first, int64_t count, const CBounds& cb,
                ChildInfo* left, ChildInfo* right) {
    if (count <= max_leaf) return 0;
    int axis = 0;
    double ext = cb.hi[0] - cb.lo[0];
    for (int a = 1; a < 3; ++a) {
      if (cb.hi[a] - cb.lo[a] > ext) {
        ext = cb.hi[a] - cb.lo[a];
        axis = a;
      }
    }
    if (ext <= 0.0) {
      return count / 2;  // degenerate: split by order
    }
    double clo_axis = cb.lo[axis];
    double scale = kNumBins * (1.0 - 1e-6) / ext;
    int64_t bin_count[kNumBins] = {0};
    V3 bin_lo[kNumBins], bin_hi[kNumBins];
    CBounds bin_cb[kNumBins];
    for (int b = 0; b < kNumBins; ++b) {
      bin_lo[b] = {INFINITY, INFINITY, INFINITY};
      bin_hi[b] = {-INFINITY, -INFINITY, -INFINITY};
      bin_cb[b].reset();
    }
    for (int64_t k = first; k < first + count; ++k) {
      const PrimRef& r = refs[k];
      int b = std::min((int)((ref_cent(r, axis) - clo_axis) * scale),
                       kNumBins - 1);
      bin_count[b]++;
      bin_lo[b] = vmin(bin_lo[b], r.lo);
      bin_hi[b] = vmax(bin_hi[b], r.hi);
      bin_cb[b].add(r);
    }
    // Suffix sweep:
    float rcost[kNumBins];
    V3 lo = bin_lo[kNumBins - 1], hi = bin_hi[kNumBins - 1];
    int64_t rc = 0;
    for (int b = kNumBins - 1; b > 0; --b) {
      lo = vmin(lo, bin_lo[b]);
      hi = vmax(hi, bin_hi[b]);
      rc += bin_count[b];
      rcost[b] = surface_area(lo, hi) * rc;
    }
    // Prefix sweep + pick best split:
    int best = -1;
    float best_cost = INFINITY;
    lo = bin_lo[0];
    hi = bin_hi[0];
    int64_t lc = 0;
    for (int b = 0; b < kNumBins - 1; ++b) {
      lo = vmin(lo, bin_lo[b]);
      hi = vmax(hi, bin_hi[b]);
      lc += bin_count[b];
      int64_t rcnt = count - lc;
      if (lc == 0 || rcnt == 0) continue;
      float cost = surface_area(lo, hi) * lc + rcost[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best = b;
      }
    }
    if (best < 0) {
      // All in one bin: median split on centroid order:
      std::nth_element(refs.begin() + first, refs.begin() + first + count / 2,
                       refs.begin() + first + count,
                       [&](const PrimRef& a, const PrimRef& b2) {
                         return ref_cent(a, axis) < ref_cent(b2, axis);
                       });
      return count / 2;
    }
    auto mid = std::partition(refs.begin() + first,
                              refs.begin() + first + count,
                              [&](const PrimRef& r) {
                                int b = std::min(
                                    (int)((ref_cent(r, axis) - clo_axis) *
                                          scale),
                                    kNumBins - 1);
                                return b <= best;
                              });
    // Child bounds from the bin unions (exact):
    left->glo = {INFINITY, INFINITY, INFINITY};
    left->ghi = {-INFINITY, -INFINITY, -INFINITY};
    left->cb.reset();
    right->glo = {INFINITY, INFINITY, INFINITY};
    right->ghi = {-INFINITY, -INFINITY, -INFINITY};
    right->cb.reset();
    for (int b = 0; b < kNumBins; ++b) {
      if (!bin_count[b]) continue;
      ChildInfo* side = (b <= best) ? left : right;
      side->glo = vmin(side->glo, bin_lo[b]);
      side->ghi = vmax(side->ghi, bin_hi[b]);
      side->cb.merge(bin_cb[b]);
    }
    left->valid = right->valid = true;
    return mid - (refs.begin() + first);
  }

  void build_iterative(const CBounds& root_cb) {
    struct SFrame {
      int node;
      CBounds cb;
    };
    std::vector<SFrame> stack;
    stack.push_back({0, root_cb});
    ChildInfo li, ri;
    while (!stack.empty()) {
      SFrame f = stack.back();
      stack.pop_back();
      int ni = f.node;
      int64_t first = nodes[ni].first, count = nodes[ni].count;
      li.valid = ri.valid = false;
      int64_t lc = split(first, count, f.cb, &li, &ri);
      if (lc <= 0 || lc >= count) continue;
      if (!li.valid) {
        // Degenerate split (order-median / one-bin): one fallback pass
        // per child — rare:
        range_bounds(first, lc, &li.glo, &li.ghi, &li.cb);
        range_bounds(first + lc, count - lc, &ri.glo, &ri.ghi, &ri.cb);
      }
      int left = make_node_b(li.glo, li.ghi, first, lc);
      int right = make_node_b(ri.glo, ri.ghi, first + lc, count - lc);
      nodes[ni].left = left;
      nodes[ni].right = right;
      stack.push_back({right, ri.cb});
      stack.push_back({left, li.cb});
    }
  }
};

}  // namespace

extern "C" int bvh_build_compact(
    const float* prim_lo, const float* prim_hi,
    const int32_t* geom_ids, const int32_t* prim_ids, int64_t n,
    int32_t max_leaf_size,
    float* out_mins, uint16_t* out_exts, int32_t* out_meta,
    int32_t* out_geom, int32_t* out_miss,
    int32_t* out_num_nodes, int32_t* out_max_depth) {
  if (n <= 0) return -1;
  Builder b;
  b.max_leaf = std::max(max_leaf_size, 1);
  b.refs.resize(n);
  V3 root_lo{std::numeric_limits<float>::infinity(), INFINITY, INFINITY};
  V3 root_hi{-INFINITY, -INFINITY, -INFINITY};
  CBounds root_cb;
  root_cb.reset();
  for (int64_t i = 0; i < n; ++i) {
    PrimRef& r = b.refs[i];
    r.lo = {prim_lo[3 * i], prim_lo[3 * i + 1], prim_lo[3 * i + 2]};
    r.hi = {prim_hi[3 * i], prim_hi[3 * i + 1], prim_hi[3 * i + 2]};
    r.id = i;
    root_lo = vmin(root_lo, r.lo);
    root_hi = vmax(root_hi, r.hi);
    root_cb.add(r);
  }
  b.nodes.reserve(2 * n);
  b.make_node_b(root_lo, root_hi, 0, n);
  b.build_iterative(root_cb);

  // Emitted subtree sizes (leaves expand to one node per primitive):
  const auto& nodes = b.nodes;
  std::vector<int64_t> size(nodes.size(), 0);
  std::vector<int> post;
  post.reserve(nodes.size());
  {
    std::vector<int> st{0};
    while (!st.empty()) {
      int ni = st.back();
      st.pop_back();
      post.push_back(ni);
      if (nodes[ni].left >= 0) {
        st.push_back(nodes[ni].left);
        st.push_back(nodes[ni].right);
      }
    }
  }
  for (auto it = post.rbegin(); it != post.rend(); ++it) {
    int ni = *it;
    size[ni] = nodes[ni].left < 0
                   ? nodes[ni].count
                   : 1 + size[nodes[ni].left] + size[nodes[ni].right];
  }

  int64_t n_out = size[0];
  int32_t sentinel = (int32_t)n_out;
  int32_t max_depth = 0;

  struct Frame {
    int node;
    int64_t pos;
    int32_t miss;
    int32_t depth;
  };
  std::vector<Frame> st{{0, 0, sentinel, 1}};
  while (!st.empty()) {
    Frame f = st.back();
    st.pop_back();
    if (f.depth > max_depth) max_depth = f.depth;
    const Node& nd = nodes[f.node];
    if (nd.left < 0) {
      int64_t k = nd.count;
      for (int64_t j = 0; j < k; ++j) {
        int64_t me = f.pos + j;
        int64_t p = b.refs[nd.first + j].id;
        out_mins[3 * me] = nd.lo.x;
        out_mins[3 * me + 1] = nd.lo.y;
        out_mins[3 * me + 2] = nd.lo.z;
        float dx = nd.hi.x - nd.lo.x, dy = nd.hi.y - nd.lo.y, dz = nd.hi.z - nd.lo.z;
        if (dx > 65504.f || dy > 65504.f || dz > 65504.f) return -2;
        out_exts[3 * me] = f32_to_f16_not_smaller(std::max(dx, 0.f));
        out_exts[3 * me + 1] = f32_to_f16_not_smaller(std::max(dy, 0.f));
        out_exts[3 * me + 2] = f32_to_f16_not_smaller(std::max(dz, 0.f));
        out_meta[me] = prim_ids[p];
        out_geom[me] = geom_ids[p];
        out_miss[me] = (j + 1 < k) ? (int32_t)(me + 1) : f.miss;
      }
    } else {
      int64_t right_pos = f.pos + 1 + size[nd.left];
      int64_t me = f.pos;
      out_mins[3 * me] = nd.lo.x;
      out_mins[3 * me + 1] = nd.lo.y;
      out_mins[3 * me + 2] = nd.lo.z;
      float dx = nd.hi.x - nd.lo.x, dy = nd.hi.y - nd.lo.y, dz = nd.hi.z - nd.lo.z;
      if (dx > 65504.f || dy > 65504.f || dz > 65504.f) return -2;
      out_exts[3 * me] = f32_to_f16_not_smaller(std::max(dx, 0.f));
      out_exts[3 * me + 1] = f32_to_f16_not_smaller(std::max(dy, 0.f));
      out_exts[3 * me + 2] = f32_to_f16_not_smaller(std::max(dz, 0.f));
      out_meta[me] = (int32_t)right_pos;
      out_geom[me] = kInvalidGeom;
      out_miss[me] = f.miss;
      st.push_back({nd.left, f.pos + 1, (int32_t)right_pos, f.depth + 1});
      st.push_back({nd.right, right_pos, f.miss, f.depth + 1});
    }
  }

  *out_num_nodes = (int32_t)n_out;
  *out_max_depth = max_depth;
  return 0;
}
