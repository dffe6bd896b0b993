// Native data-loading kernels for rrt_tpu (the counterpart of the
// reference's C++ scene-build chain: collada.cpp float parsing + bvh.cpp
// construction). Exposed to Python via ctypes (rrt_tpu/utils/native.py,
// which builds this file on first use).
//
// The hot host-side costs when loading big .dae scenes are (a) parsing
// megabyte float/int text arrays and (b) Morton-sorting triangles for the
// cluster acceleration structure; both are implemented here in C++ with
// a pure-NumPy fallback on the Python side.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// Parse whitespace-separated doubles from text[0..len) into out (capacity
// max_out). Returns the number parsed.
int64_t parse_floats(const char* text, int64_t len, double* out,
                     int64_t max_out) {
  int64_t n = 0;
  const char* p = text;
  const char* end = text + len;
  char* next = nullptr;
  while (p < end && n < max_out) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
      ++p;
    if (p >= end) break;
    double v = strtod(p, &next);
    if (next == p) break;
    out[n++] = v;
    p = next;
  }
  return n;
}

// Parse whitespace-separated int64s. Returns the number parsed.
int64_t parse_ints(const char* text, int64_t len, int64_t* out,
                   int64_t max_out) {
  int64_t n = 0;
  const char* p = text;
  const char* end = text + len;
  char* next = nullptr;
  while (p < end && n < max_out) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
      ++p;
    if (p >= end) break;
    long long v = strtoll(p, &next, 10);
    if (next == p) break;
    out[n++] = (int64_t)v;
    p = next;
  }
  return n;
}

static inline uint64_t expand_bits(uint64_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// Morton-order permutation of n triangle centroids (v0,v1,v2 are (n,3)
// row-major doubles). Writes the permutation into order[n].
void morton_order(const double* v0, const double* v1, const double* v2,
                  int64_t n, int64_t* order) {
  std::vector<double> cx(n), cy(n), cz(n);
  double lo[3] = {1e300, 1e300, 1e300};
  double hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i) {
    double c[3];
    for (int k = 0; k < 3; ++k) {
      c[k] = (v0[3 * i + k] + v1[3 * i + k] + v2[3 * i + k]) / 3.0;
      lo[k] = std::min(lo[k], c[k]);
      hi[k] = std::max(hi[k], c[k]);
    }
    cx[i] = c[0]; cy[i] = c[1]; cz[i] = c[2];
  }
  double ext[3];
  for (int k = 0; k < 3; ++k)
    ext[k] = (hi[k] - lo[k]) > 0 ? (hi[k] - lo[k]) : 1.0;
  std::vector<uint64_t> code(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t qx = (uint64_t)std::min(1023.0, std::max(0.0,
        (cx[i] - lo[0]) / ext[0] * 1023.0));
    uint64_t qy = (uint64_t)std::min(1023.0, std::max(0.0,
        (cy[i] - lo[1]) / ext[1] * 1023.0));
    uint64_t qz = (uint64_t)std::min(1023.0, std::max(0.0,
        (cz[i] - lo[2]) / ext[2] * 1023.0));
    code[i] = (expand_bits(qx) << 2) | (expand_bits(qy) << 1)
              | expand_bits(qz);
  }
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order, order + n, [&](int64_t a, int64_t b) {
    return code[a] < code[b];
  });
}

// Per-cluster AABBs over consecutive cluster_size rows of already-ordered
// triangles; invalid rows (valid[i]==0) are skipped; empty clusters get
// inverted boxes. lo/hi are (n_clusters,3).
void cluster_bboxes(const double* v0, const double* v1, const double* v2,
                    const uint8_t* valid, int64_t n, int64_t cluster_size,
                    double* lo, double* hi) {
  int64_t k = n / cluster_size;
  for (int64_t c = 0; c < k; ++c) {
    double mn[3] = {1e300, 1e300, 1e300};
    double mx[3] = {-1e300, -1e300, -1e300};
    bool any = false;
    for (int64_t i = c * cluster_size; i < (c + 1) * cluster_size; ++i) {
      if (!valid[i]) continue;
      any = true;
      for (int kk = 0; kk < 3; ++kk) {
        double a = std::min(std::min(v0[3 * i + kk], v1[3 * i + kk]),
                            v2[3 * i + kk]);
        double b = std::max(std::max(v0[3 * i + kk], v1[3 * i + kk]),
                            v2[3 * i + kk]);
        mn[kk] = std::min(mn[kk], a);
        mx[kk] = std::max(mx[kk], b);
      }
    }
    for (int kk = 0; kk < 3; ++kk) {
      lo[3 * c + kk] = any ? mn[kk] : 3e37;
      hi[3 * c + kk] = any ? mx[kk] : -3e37;
    }
  }
}

// Area-weighted vertex normals (halfEdgeMesh.h:487-514 semantics): per
// face add cross(e1,e2) to each corner vertex, then normalize.
void vertex_normals(const double* verts, int64_t n_verts,
                    const int64_t* tris, int64_t n_tris, double* out) {
  std::memset(out, 0, sizeof(double) * 3 * n_verts);
  for (int64_t t = 0; t < n_tris; ++t) {
    const double* a = verts + 3 * tris[3 * t];
    const double* b = verts + 3 * tris[3 * t + 1];
    const double* c = verts + 3 * tris[3 * t + 2];
    double e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    double e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    double fn[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                    e1[2] * e2[0] - e1[0] * e2[2],
                    e1[0] * e2[1] - e1[1] * e2[0]};
    for (int corner = 0; corner < 3; ++corner) {
      double* dst = out + 3 * tris[3 * t + corner];
      dst[0] += fn[0];
      dst[1] += fn[1];
      dst[2] += fn[2];
    }
  }
  for (int64_t v = 0; v < n_verts; ++v) {
    double* p = out + 3 * v;
    double len = std::sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
    if (len > 0) {
      p[0] /= len;
      p[1] /= len;
      p[2] /= len;
    }
  }
}

}  // extern "C"
