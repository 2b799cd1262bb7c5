// Greedy depth-map triangulation (Garland-Heckbert terrain simplification).
//
// Native counterpart of reference lib/depth_triangulator.cc
// (`approximate_triangulation`, :27-173): start from the image rectangle,
// repeatedly insert the pixel with the largest vertical error inside its
// triangle (heap-driven), until the vertex budget or error threshold is
// reached. Faces touching invalid (zero-depth) vertices are dropped at
// export like the reference's degenerate-face removal (:156-169).

#include <algorithm>
#include <cmath>
#include <queue>
#include <vector>

#include "delaunay.hpp"

namespace smvs_native {

namespace {

struct Cand {
  double error;
  int tri;
  int px, py;
  int stamp;  // triangle version when computed
  bool operator<(const Cand& o) const { return error < o.error; }
};

struct Raster {
  const float* depth;
  int width, height;

  float at(int x, int y) const { return depth[y * width + x]; }
};

// Max-error pixel of a triangle (linear interpolation of vertex depths).
bool max_error_in_tri(const Raster& r, const Delaunay& dt, int t,
                      const std::vector<float>& vdepth, Cand* out) {
  const Tri& T = dt.tris()[t];
  const Point& a = dt.points()[T.v[0]];
  const Point& b = dt.points()[T.v[1]];
  const Point& c = dt.points()[T.v[2]];
  double da = vdepth[T.v[0]], db = vdepth[T.v[1]], dc = vdepth[T.v[2]];
  int x0 = std::max(0, (int)std::floor(std::min({a.x, b.x, c.x})));
  int x1 = std::min(r.width - 1, (int)std::ceil(std::max({a.x, b.x, c.x})));
  int y0 = std::max(0, (int)std::floor(std::min({a.y, b.y, c.y})));
  int y1 = std::min(r.height - 1, (int)std::ceil(std::max({a.y, b.y, c.y})));
  double det = (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
  if (std::abs(det) < 1e-12) return false;
  double best = 0.0;
  int bx = -1, by = -1;
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      float d = r.at(x, y);
      if (d <= 0.0f) continue;
      double wx = x, wy = y;
      double l1 = ((wx - a.x) * (c.y - a.y) - (wy - a.y) * (c.x - a.x)) / det;
      double l2 = ((b.x - a.x) * (wy - a.y) - (b.y - a.y) * (wx - a.x)) / det;
      double l0 = 1.0 - l1 - l2;
      if (l0 < 0 || l1 < 0 || l2 < 0) continue;
      double interp = l0 * da + l1 * db + l2 * dc;
      // Invalid-vertex triangles always want refinement at valid pixels.
      double err = (da <= 0 || db <= 0 || dc <= 0)
                       ? d
                       : std::abs(interp - d);
      if (err > best) {
        best = err;
        bx = x;
        by = y;
      }
    }
  }
  if (bx < 0) return false;
  out->error = best;
  out->tri = t;
  out->px = bx;
  out->py = by;
  return true;
}

}  // namespace

// Greedy triangulation. Returns vertex (x, y, depth) triplets and faces.
// max_vertices: hard budget; error_threshold: absolute depth error to stop.
void approximate_triangulation(const float* depth, int width, int height,
                               int max_vertices, double error_threshold,
                               std::vector<double>* out_xyz,
                               std::vector<int>* out_faces) {
  Raster r{depth, width, height};
  Delaunay dt;
  dt.init_with_box(0, 0, width - 1, height - 1);
  std::vector<float> vdepth;
  auto corner_depth = [&](int x, int y) { return r.at(x, y); };
  vdepth.push_back(corner_depth(0, 0));
  vdepth.push_back(corner_depth(width - 1, 0));
  vdepth.push_back(corner_depth(0, height - 1));
  vdepth.push_back(corner_depth(width - 1, height - 1));

  std::vector<int> tri_stamp(dt.tris().size(), 0);
  std::priority_queue<Cand> heap;
  for (int t = 0; t < (int)dt.tris().size(); ++t) {
    Cand c;
    if (max_error_in_tri(r, dt, t, vdepth, &c)) {
      c.stamp = 0;
      heap.push(c);
    }
  }

  while (!heap.empty() && (int)dt.points().size() < max_vertices) {
    Cand c = heap.top();
    heap.pop();
    if (c.tri >= (int)tri_stamp.size() || !dt.tris()[c.tri].alive ||
        tri_stamp[c.tri] != c.stamp)
      continue;  // stale entry
    if (c.error <= error_threshold) break;

    dt.changed().clear();
    int vid = dt.insert((double)c.px, (double)c.py, c.tri);
    if (vid < 0) continue;
    vdepth.push_back(r.at(c.px, c.py));
    tri_stamp.resize(dt.tris().size(), 0);
    for (int t : dt.changed()) {
      tri_stamp[t] += 1;
      Cand nc;
      if (max_error_in_tri(r, dt, t, vdepth, &nc)) {
        nc.stamp = tri_stamp[t];
        heap.push(nc);
      }
    }
  }

  // Export: drop faces with any invalid-depth vertex.
  std::vector<double> xy;
  std::vector<int> faces;
  dt.export_mesh(&xy, &faces);
  out_xyz->clear();
  out_faces->clear();
  std::vector<int> remap(xy.size() / 2, -1);
  for (size_t f = 0; f + 2 < faces.size(); f += 3) {
    bool ok = true;
    for (int k = 0; k < 3; ++k)
      if (vdepth[faces[f + k]] <= 0.0f) ok = false;
    if (!ok) continue;
    for (int k = 0; k < 3; ++k) {
      int v = faces[f + k];
      if (remap[v] < 0) {
        remap[v] = (int)(out_xyz->size() / 3);
        out_xyz->push_back(xy[2 * v]);
        out_xyz->push_back(xy[2 * v + 1]);
        out_xyz->push_back(vdepth[v]);
      }
      out_faces->push_back(remap[v]);
    }
  }
}

}  // namespace smvs_native
