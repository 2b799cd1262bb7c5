// Incremental 2D Delaunay triangulation with point-location walk.
//
// Native counterpart of the reference's Guibas-Stolfi quad-edge
// implementation (reference lib/delaunay_2d.cc, lib/quad_edge.h), built
// instead on a triangle-adjacency Bowyer-Watson design: triangles store
// their three neighbors; insertion digs the star-shaped cavity of all
// triangles whose circumcircle contains the point and retriangulates it.
// Used by the greedy depth-map triangulator (triangulate.cpp).

#include "delaunay.hpp"

#include <cmath>
#include <cstdio>

namespace smvs_native {

static inline double orient2d(const Point& a, const Point& b, const Point& c) {
  return (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
}

// > 0 iff d lies inside the circumcircle of (a, b, c) (ccw ordered).
static double incircle(const Point& a, const Point& b, const Point& c,
                       const Point& d) {
  double adx = a.x - d.x, ady = a.y - d.y;
  double bdx = b.x - d.x, bdy = b.y - d.y;
  double cdx = c.x - d.x, cdy = c.y - d.y;
  double ad2 = adx * adx + ady * ady;
  double bd2 = bdx * bdx + bdy * bdy;
  double cd2 = cdx * cdx + cdy * cdy;
  return adx * (bdy * cd2 - cdy * bd2) - ady * (bdx * cd2 - cdx * bd2) +
         ad2 * (bdx * cdy - cdx * bdy);
}

void Delaunay::init_with_box(double min_x, double min_y, double max_x,
                             double max_y) {
  points_.clear();
  tris_.clear();
  // Four corner points, two triangles.
  points_.push_back({min_x, min_y});
  points_.push_back({max_x, min_y});
  points_.push_back({min_x, max_y});
  points_.push_back({max_x, max_y});
  // ccw triangles: (0,1,3) and (0,3,2), sharing edge (3,0)/(0,3).
  tris_.push_back({{0, 1, 3}, {-1, -1, 1}, true});
  tris_.push_back({{0, 3, 2}, {0, -1, -1}, true});
  last_alive_ = 0;
}

bool Delaunay::point_in_tri(int t, const Point& p) const {
  const Tri& T = tris_[t];
  const Point& a = points_[T.v[0]];
  const Point& b = points_[T.v[1]];
  const Point& c = points_[T.v[2]];
  return orient2d(a, b, p) >= 0 && orient2d(b, c, p) >= 0 &&
         orient2d(c, a, p) >= 0;
}

int Delaunay::locate(const Point& p, int hint) const {
  // Straight walk from hint toward p.
  int t = (hint >= 0 && hint < (int)tris_.size() && tris_[hint].alive)
              ? hint
              : last_alive_;
  if (!tris_[t].alive) {
    for (int i = (int)tris_.size() - 1; i >= 0; --i)
      if (tris_[i].alive) { t = i; break; }
  }
  for (int guard = 0; guard < (int)tris_.size() * 4 + 16; ++guard) {
    const Tri& T = tris_[t];
    int next = -1;
    for (int e = 0; e < 3; ++e) {
      const Point& a = points_[T.v[e]];
      const Point& b = points_[T.v[(e + 1) % 3]];
      if (orient2d(a, b, p) < 0) {
        next = T.n[e];
        break;
      }
    }
    if (next < 0) return t;  // inside (or on hull edge with no neighbor)
    t = next;
  }
  return t;  // degenerate fallback
}

int Delaunay::insert(double x, double y, int hint) {
  Point p{x, y};
  int t0 = locate(p, hint);
  if (t0 < 0) return -1;

  // Collect the cavity: BFS over triangles whose circumcircle contains p.
  cavity_.clear();
  stack_.clear();
  stack_.push_back(t0);
  tris_[t0].alive = false;
  cavity_.push_back(t0);
  while (!stack_.empty()) {
    int t = stack_.back();
    stack_.pop_back();
    for (int e = 0; e < 3; ++e) {
      int nb = tris_[t].n[e];
      if (nb < 0 || !tris_[nb].alive) continue;
      const Tri& N = tris_[nb];
      if (incircle(points_[N.v[0]], points_[N.v[1]], points_[N.v[2]], p) > 0) {
        N_alive_off(nb);
        cavity_.push_back(nb);
        stack_.push_back(nb);
      }
    }
  }

  // Boundary edges of the cavity (edges whose twin is outside).
  boundary_.clear();
  for (int t : cavity_) {
    for (int e = 0; e < 3; ++e) {
      int nb = tris_[t].n[e];
      if (nb < 0 || tris_[nb].alive) {
        boundary_.push_back({tris_[t].v[e], tris_[t].v[(e + 1) % 3], nb});
      }
    }
  }

  int pi = (int)points_.size();
  points_.push_back(p);

  // One new triangle per boundary edge; link neighbors.
  int first_new = (int)tris_.size();
  for (size_t i = 0; i < boundary_.size(); ++i) {
    const BEdge& be = boundary_[i];
    Tri nt;
    nt.v[0] = pi;
    nt.v[1] = be.a;
    nt.v[2] = be.b;
    nt.n[0] = -1;  // edge (p, a): filled below
    nt.n[1] = be.outside;  // edge (a, b)
    nt.n[2] = -1;  // edge (b, p)
    nt.alive = true;
    int id = (int)tris_.size();
    if (be.outside >= 0) {
      Tri& O = tris_[be.outside];
      for (int e = 0; e < 3; ++e)
        if ((O.v[e] == be.b && O.v[(e + 1) % 3] == be.a)) O.n[e] = id;
    }
    tris_.push_back(nt);
    changed_.push_back(id);
  }
  // Stitch the fan: edges (p,a) and (b,p) between consecutive new tris.
  int n_new = (int)tris_.size() - first_new;
  for (int i = 0; i < n_new; ++i) {
    Tri& A = tris_[first_new + i];
    for (int j = 0; j < n_new; ++j) {
      if (i == j) continue;
      Tri& B = tris_[first_new + j];
      if (A.v[1] == B.v[2]) A.n[0] = first_new + j;  // (p, a) twin (b', p)
      if (A.v[2] == B.v[1]) A.n[2] = first_new + j;
    }
  }
  last_alive_ = first_new;
  return pi;
}

void Delaunay::export_mesh(std::vector<double>* xy,
                           std::vector<int>* faces) const {
  xy->clear();
  faces->clear();
  for (const Point& p : points_) {
    xy->push_back(p.x);
    xy->push_back(p.y);
  }
  for (const Tri& t : tris_) {
    if (!t.alive) continue;
    faces->push_back(t.v[0]);
    faces->push_back(t.v[1]);
    faces->push_back(t.v[2]);
  }
}

}  // namespace smvs_native
