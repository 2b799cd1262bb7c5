// C API for the native meshing library (loaded from Python via ctypes).

#include <cstddef>
#include <vector>

using std::size_t;

#include "delaunay.hpp"

namespace smvs_native {
void approximate_triangulation(const float* depth, int width, int height,
                               int max_vertices, double error_threshold,
                               std::vector<double>* out_xyz,
                               std::vector<int>* out_faces);
void simplify_qem(const float* verts, int n_verts, const int* faces,
                  int n_faces, int target_faces,
                  std::vector<float>* out_verts, std::vector<int>* out_faces);
}  // namespace smvs_native

extern "C" {

// Greedy depth-map triangulation. Writes up to max_* entries; returns 0 on
// success, -1 if the output buffers were too small.
int smvs_approx_triangulate(const float* depth, int width, int height,
                            int max_vertices, double error_threshold,
                            double* out_xyz, int max_out_verts,
                            int* out_faces, int max_out_faces,
                            int* n_verts, int* n_faces) {
  std::vector<double> xyz;
  std::vector<int> faces;
  smvs_native::approximate_triangulation(depth, width, height, max_vertices,
                                         error_threshold, &xyz, &faces);
  *n_verts = (int)(xyz.size() / 3);
  *n_faces = (int)(faces.size() / 3);
  if (*n_verts > max_out_verts || *n_faces > max_out_faces) return -1;
  for (size_t i = 0; i < xyz.size(); ++i) out_xyz[i] = xyz[i];
  for (size_t i = 0; i < faces.size(); ++i) out_faces[i] = faces[i];
  return 0;
}

int smvs_simplify_mesh(const float* verts, int n_verts, const int* faces,
                       int n_faces, int target_faces,
                       float* out_verts, int max_out_verts,
                       int* out_faces, int max_out_faces,
                       int* out_n_verts, int* out_n_faces) {
  std::vector<float> ov;
  std::vector<int> of;
  smvs_native::simplify_qem(verts, n_verts, faces, n_faces, target_faces,
                            &ov, &of);
  *out_n_verts = (int)(ov.size() / 3);
  *out_n_faces = (int)(of.size() / 3);
  if (*out_n_verts > max_out_verts || *out_n_faces > max_out_faces) return -1;
  for (size_t i = 0; i < ov.size(); ++i) out_verts[i] = ov[i];
  for (size_t i = 0; i < of.size(); ++i) out_faces[i] = of[i];
  return 0;
}

// Plain Delaunay triangulation of 2D points (for tests / tooling).
int smvs_delaunay(const double* pts_xy, int n_pts, double min_x, double min_y,
                  double max_x, double max_y, int* out_faces,
                  int max_out_faces, int* n_faces) {
  smvs_native::Delaunay dt;
  dt.init_with_box(min_x, min_y, max_x, max_y);
  for (int i = 0; i < n_pts; ++i)
    dt.insert(pts_xy[2 * i], pts_xy[2 * i + 1]);
  std::vector<double> xy;
  std::vector<int> faces;
  dt.export_mesh(&xy, &faces);
  *n_faces = (int)(faces.size() / 3);
  if (*n_faces > max_out_faces) return -1;
  for (size_t i = 0; i < faces.size(); ++i) out_faces[i] = faces[i];
  return 0;
}
}
