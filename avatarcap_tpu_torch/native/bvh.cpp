// BVH closest-point / signed-distance queries over triangle meshes.
//
// Native host-side replacement for the reference's igl.signed_distance
// (reference gen_data/preprocess_training_data.py:70,304,454) used by the
// offline preprocessing pipeline, where millions of exact point-mesh
// queries dominate. Median-split AABB tree, exact point-triangle
// projection, ray-parity inside test; OpenMP across queries.
//
// C ABI (ctypes):
//   void* bvh_build(const float* verts, int n_verts,
//                   const int* faces, int n_faces);
//   void  bvh_free(void* handle);
//   void  bvh_closest_points(void* handle, const float* queries, int n,
//                            float* out_points, int* out_face,
//                            float* out_bary, float* out_dist);
//   void  bvh_signed_distance(void* handle, const float* queries, int n,
//                             float* out_sdf /* inside-positive */);

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 add(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline Vec3 mul(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm2(Vec3 a) { return dot(a, a); }

struct AABB {
  Vec3 lo{std::numeric_limits<float>::max(),
          std::numeric_limits<float>::max(),
          std::numeric_limits<float>::max()};
  Vec3 hi{-std::numeric_limits<float>::max(),
          -std::numeric_limits<float>::max(),
          -std::numeric_limits<float>::max()};
  void grow(Vec3 p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB& b) { grow(b.lo); grow(b.hi); }
  float dist2(Vec3 p) const {
    float d = 0.f;
    float t;
    t = std::max({lo.x - p.x, 0.f, p.x - hi.x}); d += t * t;
    t = std::max({lo.y - p.y, 0.f, p.y - hi.y}); d += t * t;
    t = std::max({lo.z - p.z, 0.f, p.z - hi.z}); d += t * t;
    return d;
  }
};

// Ericson, Real-Time Collision Detection 5.1.5
static Vec3 closest_on_triangle(Vec3 p, Vec3 a, Vec3 b, Vec3 c, float* u,
                                float* v, float* w) {
  Vec3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) { *u = 1; *v = 0; *w = 0; return a; }
  Vec3 bp = sub(p, b);
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) { *u = 0; *v = 1; *w = 0; return b; }
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float t = d1 / (d1 - d3);
    *u = 1 - t; *v = t; *w = 0;
    return add(a, mul(ab, t));
  }
  Vec3 cp = sub(p, c);
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) { *u = 0; *v = 0; *w = 1; return c; }
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float t = d2 / (d2 - d6);
    *u = 1 - t; *v = 0; *w = t;
    return add(a, mul(ac, t));
  }
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    *u = 0; *v = 1 - t; *w = t;
    return add(b, mul(sub(c, b), t));
  }
  float denom = 1.f / (va + vb + vc);
  float vv = vb * denom, ww = vc * denom;
  *u = 1 - vv - ww; *v = vv; *w = ww;
  return add(a, add(mul(ab, vv), mul(ac, ww)));
}

struct Node {
  AABB box;
  int left = -1, right = -1;  // children, or
  int start = 0, count = 0;   // leaf triangle range
};

struct BVH {
  std::vector<Vec3> verts;
  std::vector<int> faces;     // 3 per triangle
  std::vector<int> tri_order; // permutation into faces
  std::vector<Node> nodes;

  Vec3 tri_centroid(int t) const {
    Vec3 a = verts[faces[3 * t]], b = verts[faces[3 * t + 1]],
         c = verts[faces[3 * t + 2]];
    return mul(add(add(a, b), c), 1.f / 3.f);
  }

  AABB tri_box(int t) const {
    AABB bb;
    bb.grow(verts[faces[3 * t]]);
    bb.grow(verts[faces[3 * t + 1]]);
    bb.grow(verts[faces[3 * t + 2]]);
    return bb;
  }

  int build(int start, int count) {
    Node node;
    for (int i = 0; i < count; ++i) node.box.grow(tri_box(tri_order[start + i]));
    int idx = (int)nodes.size();
    nodes.push_back(node);
    if (count <= 4) {
      nodes[idx].start = start;
      nodes[idx].count = count;
      return idx;
    }
    Vec3 ext = sub(node.box.hi, node.box.lo);
    int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
    int mid = count / 2;
    std::nth_element(
        tri_order.begin() + start, tri_order.begin() + start + mid,
        tri_order.begin() + start + count, [&](int ta, int tb) {
          Vec3 ca = tri_centroid(ta), cb = tri_centroid(tb);
          float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
          float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
          return va < vb;
        });
    int l = build(start, mid);
    int r = build(start + mid, count - mid);
    nodes[idx].left = l;
    nodes[idx].right = r;
    nodes[idx].count = 0;
    return idx;
  }

  void closest(Vec3 p, float* best_d2, int* best_tri, Vec3* best_pt,
               float* best_bary) const {
    // iterative best-first traversal
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      int ni = stack[--sp];
      const Node& n = nodes[ni];
      if (n.box.dist2(p) >= *best_d2) continue;
      if (n.count > 0) {
        for (int i = 0; i < n.count; ++i) {
          int t = tri_order[n.start + i];
          float u, v, w;
          Vec3 cp = closest_on_triangle(p, verts[faces[3 * t]],
                                        verts[faces[3 * t + 1]],
                                        verts[faces[3 * t + 2]], &u, &v, &w);
          float d2 = norm2(sub(p, cp));
          if (d2 < *best_d2) {
            *best_d2 = d2;
            *best_tri = t;
            *best_pt = cp;
            best_bary[0] = u; best_bary[1] = v; best_bary[2] = w;
          }
        }
      } else {
        // visit nearer child first
        float dl = nodes[n.left].box.dist2(p);
        float dr = nodes[n.right].box.dist2(p);
        if (dl < dr) {
          if (sp < 126) { stack[sp++] = n.right; stack[sp++] = n.left; }
        } else {
          if (sp < 126) { stack[sp++] = n.left; stack[sp++] = n.right; }
        }
      }
    }
  }

  // parity of +z ray crossings
  bool inside(Vec3 p) const {
    int stack[128];
    int sp = 0;
    stack[sp++] = 0;
    int crossings = 0;
    while (sp) {
      int ni = stack[--sp];
      const Node& n = nodes[ni];
      // ray +z: box reachable iff xy overlaps and box top above p.z
      if (p.x < n.box.lo.x || p.x > n.box.hi.x || p.y < n.box.lo.y ||
          p.y > n.box.hi.y || p.z > n.box.hi.z)
        continue;
      if (n.count > 0) {
        for (int i = 0; i < n.count; ++i) {
          int t = tri_order[n.start + i];
          Vec3 a = verts[faces[3 * t]], b = verts[faces[3 * t + 1]],
               c = verts[faces[3 * t + 2]];
          // 2D inside test + z of intersection
          auto edge = [](float ax, float ay, float bx, float by, float px,
                         float py) {
            return (bx - ax) * (py - ay) - (by - ay) * (px - ax);
          };
          float e0 = edge(a.x, a.y, b.x, b.y, p.x, p.y);
          float e1 = edge(b.x, b.y, c.x, c.y, p.x, p.y);
          float e2 = edge(c.x, c.y, a.x, a.y, p.x, p.y);
          bool in2d = (e0 >= 0 && e1 >= 0 && e2 >= 0) ||
                      (e0 <= 0 && e1 <= 0 && e2 <= 0);
          float area = edge(a.x, a.y, b.x, b.y, c.x, c.y);
          if (!in2d || std::fabs(area) < 1e-12f) continue;
          float w0 = e1 / area, w1 = e2 / area;
          float w2 = 1.f - w0 - w1;
          float zhit = w0 * a.z + w1 * b.z + w2 * c.z;
          if (zhit > p.z) ++crossings;
        }
      } else {
        if (sp < 126) { stack[sp++] = n.left; stack[sp++] = n.right; }
      }
    }
    return (crossings & 1) == 1;
  }
};

}  // namespace

extern "C" {

void* bvh_build(const float* verts, int n_verts, const int* faces,
                int n_faces) {
  BVH* bvh = new BVH();
  bvh->verts.resize(n_verts);
  std::memcpy(bvh->verts.data(), verts, sizeof(float) * 3 * n_verts);
  bvh->faces.assign(faces, faces + 3 * n_faces);
  bvh->tri_order.resize(n_faces);
  for (int i = 0; i < n_faces; ++i) bvh->tri_order[i] = i;
  bvh->nodes.reserve(2 * n_faces);
  bvh->build(0, n_faces);
  return bvh;
}

void bvh_free(void* handle) { delete static_cast<BVH*>(handle); }

void bvh_closest_points(void* handle, const float* queries, int n,
                        float* out_points, int* out_face, float* out_bary,
                        float* out_dist) {
  const BVH* bvh = static_cast<BVH*>(handle);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    Vec3 p{queries[3 * i], queries[3 * i + 1], queries[3 * i + 2]};
    float d2 = std::numeric_limits<float>::max();
    int tri = 0;
    Vec3 cp{0, 0, 0};
    float bary[3] = {0, 0, 0};
    bvh->closest(p, &d2, &tri, &cp, bary);
    out_points[3 * i] = cp.x;
    out_points[3 * i + 1] = cp.y;
    out_points[3 * i + 2] = cp.z;
    out_face[i] = tri;
    out_bary[3 * i] = bary[0];
    out_bary[3 * i + 1] = bary[1];
    out_bary[3 * i + 2] = bary[2];
    out_dist[i] = std::sqrt(d2);
  }
}

void bvh_signed_distance(void* handle, const float* queries, int n,
                         float* out_sdf) {
  const BVH* bvh = static_cast<BVH*>(handle);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    Vec3 p{queries[3 * i], queries[3 * i + 1], queries[3 * i + 2]};
    float d2 = std::numeric_limits<float>::max();
    int tri = 0;
    Vec3 cp{0, 0, 0};
    float bary[3];
    bvh->closest(p, &d2, &tri, &cp, bary);
    float d = std::sqrt(d2);
    out_sdf[i] = bvh->inside(p) ? d : -d;  // inside-positive
  }
}

}  // extern "C"
