// Incremental 2D Delaunay triangulation (triangle-adjacency Bowyer-Watson).
// See delaunay.cpp; native counterpart of reference lib/delaunay_2d.h.

#pragma once

#include <vector>

namespace smvs_native {

struct Point {
  double x, y;
};

struct Tri {
  int v[3];  // ccw vertex ids
  int n[3];  // neighbor across edge (v[e], v[e+1]); -1 = hull
  bool alive;
};

struct BEdge {
  int a, b, outside;
};

class Delaunay {
 public:
  // Start from a bounding rectangle (two triangles, four corner points).
  void init_with_box(double min_x, double min_y, double max_x, double max_y);

  // Insert a point; returns its vertex id (or -1). `hint` is a triangle id
  // to start the location walk from. Triangles created by this insertion
  // are appended to `changed()` (cleared by the caller).
  int insert(double x, double y, int hint = -1);

  int locate(const Point& p, int hint = -1) const;
  bool point_in_tri(int t, const Point& p) const;

  void export_mesh(std::vector<double>* xy, std::vector<int>* faces) const;

  const std::vector<Point>& points() const { return points_; }
  const std::vector<Tri>& tris() const { return tris_; }
  std::vector<int>& changed() { return changed_; }

 private:
  void N_alive_off(int t) { tris_[t].alive = false; }

  std::vector<Point> points_;
  std::vector<Tri> tris_;
  std::vector<int> cavity_, stack_, changed_;
  std::vector<BEdge> boundary_;
  mutable int last_alive_ = 0;
};

}  // namespace smvs_native
