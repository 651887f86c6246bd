// Native floor-plan preprocessing kernels.
//
// The reference leans on OpenCV (connectedComponentsWithStats,
// distanceTransform, dilate) and scipy.ndimage for its one-time floor-plan
// processing (building_utils.py:254-288, 322-357, 485-509). These are the
// equivalent kernels implemented directly: 4-connected labeling via
// union-find, exact Euclidean distance transform (Felzenszwalb & Huttenlocher
// 2004, two-pass separable), and binary dilation with a cross structuring
// element. Exposed through a C ABI for ctypes.
//
// Copy of sbsim_tpu/native/floorplan_ops.cc. Built by sbsim_tpu_torch/native/__init__.py
// (g++ -O3 -shared -fPIC) into sbsim_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(int32_t n) : parent(n) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

// Large finite sentinel instead of IEEE infinity: the parabola-intersection
// step computes f-differences, and inf - inf would produce NaNs that corrupt
// the envelope indices.
constexpr double kInf = 1e30;

// 1-D squared distance transform (Felzenszwalb & Huttenlocher 2004).
void dt1d(const double* f, double* d, int n, std::vector<int>& v,
          std::vector<double>& z) {
  v.assign(n, 0);
  z.assign(n + 1, 0.0);
  int k = 0;
  v[0] = 0;
  z[0] = -std::numeric_limits<double>::infinity();
  z[1] = std::numeric_limits<double>::infinity();
  for (int q = 1; q < n; ++q) {
    double s;
    while (true) {
      s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) /
          (2.0 * q - 2.0 * v[k]);
      if (s <= z[k] && k > 0) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = std::numeric_limits<double>::infinity();
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = q - (double)v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

}  // namespace

extern "C" {

// 4-connected component labeling of nonzero pixels, raster-scan numbering.
// labels out: 0 background, 1..n components. Returns n.
int32_t connected_components_4(const uint8_t* image, int32_t h, int32_t w,
                               int32_t* labels) {
  const int32_t n = h * w;
  UnionFind uf(n);
  for (int32_t i = 0; i < h; ++i) {
    for (int32_t j = 0; j < w; ++j) {
      const int32_t idx = i * w + j;
      if (!image[idx]) continue;
      if (i > 0 && image[idx - w]) uf.unite(idx, idx - w);
      if (j > 0 && image[idx - 1]) uf.unite(idx, idx - 1);
    }
  }
  // Relabel roots in raster order of first occurrence.
  std::vector<int32_t> root_label(n, 0);
  int32_t next = 0;
  for (int32_t idx = 0; idx < n; ++idx) {
    if (!image[idx]) {
      labels[idx] = 0;
      continue;
    }
    const int32_t root = uf.find(idx);
    if (root_label[root] == 0) root_label[root] = ++next;
    labels[idx] = root_label[root];
  }
  return next;
}

// Exact Euclidean distance to the nearest zero pixel; zero pixels get 0.
void distance_transform_edt(const uint8_t* image, int32_t h, int32_t w,
                            float* out) {
  std::vector<double> f(h * w);
  for (int32_t idx = 0; idx < h * w; ++idx) {
    f[idx] = image[idx] ? kInf : 0.0;
  }
  std::vector<double> col(h), dcol(h), row(w), drow(w);
  std::vector<int> v;
  std::vector<double> z;
  // Columns.
  for (int32_t j = 0; j < w; ++j) {
    for (int32_t i = 0; i < h; ++i) col[i] = f[i * w + j];
    dt1d(col.data(), dcol.data(), h, v, z);
    for (int32_t i = 0; i < h; ++i) f[i * w + j] = dcol[i];
  }
  // Rows.
  for (int32_t i = 0; i < h; ++i) {
    for (int32_t j = 0; j < w; ++j) row[j] = f[i * w + j];
    dt1d(row.data(), drow.data(), w, v, z);
    for (int32_t j = 0; j < w; ++j) out[i * w + j] = (float)std::sqrt(drow[j]);
  }
}

// Binary dilation with the 4-connected cross element, `iterations` times.
void binary_dilation_cross(const uint8_t* image, int32_t h, int32_t w,
                           int32_t iterations, uint8_t* out) {
  std::vector<uint8_t> cur(image, image + h * w), next(h * w);
  for (int32_t it = 0; it < iterations; ++it) {
    for (int32_t i = 0; i < h; ++i) {
      for (int32_t j = 0; j < w; ++j) {
        const int32_t idx = i * w + j;
        uint8_t val = cur[idx];
        if (!val && i > 0) val = cur[idx - w];
        if (!val && i + 1 < h) val = cur[idx + w];
        if (!val && j > 0) val = cur[idx - 1];
        if (!val && j + 1 < w) val = cur[idx + 1];
        next[idx] = val;
      }
    }
    cur.swap(next);
  }
  std::memcpy(out, cur.data(), h * w);
}

}  // extern "C"
