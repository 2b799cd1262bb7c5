// Quadric error metric (QEM) mesh decimation.
//
// Native counterpart of reference lib/mesh_simplifier.cc (Garland-Heckbert
// quadrics, optimal collapse position via 4x4 solve, priority queue,
// manifold-safe collapses), implemented independently with a lazy-deletion
// heap over half-edge collapses.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstring>
#include <queue>
#include <set>
#include <vector>

namespace smvs_native {

namespace {

using Quadric = std::array<double, 10>;  // symmetric 4x4: upper triangle

inline void quadric_add_plane(Quadric& q, double a, double b, double c,
                              double d) {
  q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
  q[4] += b * b; q[5] += b * c; q[6] += b * d;
  q[7] += c * c; q[8] += c * d;
  q[9] += d * d;
}

inline Quadric quadric_sum(const Quadric& p, const Quadric& q) {
  Quadric r;
  for (int i = 0; i < 10; ++i) r[i] = p[i] + q[i];
  return r;
}

inline double quadric_eval(const Quadric& q, const double v[3]) {
  double x = v[0], y = v[1], z = v[2];
  return q[0] * x * x + 2 * q[1] * x * y + 2 * q[2] * x * z + 2 * q[3] * x +
         q[4] * y * y + 2 * q[5] * y * z + 2 * q[6] * y +
         q[7] * z * z + 2 * q[8] * z + q[9];
}

// Solve for the minimizing position; falls back to the midpoint.
bool quadric_optimum(const Quadric& q, double out[3]) {
  double A[3][3] = {{q[0], q[1], q[2]}, {q[1], q[4], q[5]}, {q[2], q[5], q[7]}};
  double b[3] = {-q[3], -q[6], -q[8]};
  // Gaussian elimination with partial pivoting.
  int idx[3] = {0, 1, 2};
  for (int col = 0; col < 3; ++col) {
    int piv = col;
    for (int r = col + 1; r < 3; ++r)
      if (std::abs(A[r][col]) > std::abs(A[piv][col])) piv = r;
    if (std::abs(A[piv][col]) < 1e-10) return false;
    std::swap(A[col], A[piv]);
    std::swap(b[col], b[piv]);
    for (int r = col + 1; r < 3; ++r) {
      double f = A[r][col] / A[col][col];
      for (int c = col; c < 3; ++c) A[r][c] -= f * A[col][c];
      b[r] -= f * b[col];
    }
  }
  for (int r = 2; r >= 0; --r) {
    double s = b[r];
    for (int c = r + 1; c < 3; ++c) s -= A[r][c] * out[c];
    out[r] = s / A[r][r];
  }
  (void)idx;
  return true;
}

struct Collapse {
  double cost;
  int a, b;        // collapse a -> position, removing b
  int stamp;       // sum of vertex versions when computed
  double pos[3];
  bool operator<(const Collapse& o) const { return cost > o.cost; }  // min-heap
};

}  // namespace

// Decimate to target_faces. verts: [n*3], faces: [m*3]. Outputs compacted.
void simplify_qem(const float* verts, int n_verts, const int* faces,
                  int n_faces, int target_faces,
                  std::vector<float>* out_verts, std::vector<int>* out_faces) {
  std::vector<std::array<double, 3>> V(n_verts);
  for (int i = 0; i < n_verts; ++i)
    V[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  std::vector<std::array<int, 3>> F(n_faces);
  for (int i = 0; i < n_faces; ++i)
    F[i] = {faces[3 * i], faces[3 * i + 1], faces[3 * i + 2]};

  // Per-vertex quadrics from incident face planes (reference :137-162).
  std::vector<Quadric> Q(n_verts);
  for (auto& q : Q) q.fill(0.0);
  std::vector<std::vector<int>> vfaces(n_verts);
  for (int f = 0; f < n_faces; ++f) {
    auto& t = F[f];
    double ux = V[t[1]][0] - V[t[0]][0], uy = V[t[1]][1] - V[t[0]][1],
           uz = V[t[1]][2] - V[t[0]][2];
    double vx = V[t[2]][0] - V[t[0]][0], vy = V[t[2]][1] - V[t[0]][1],
           vz = V[t[2]][2] - V[t[0]][2];
    double nx = uy * vz - uz * vy, ny = uz * vx - ux * vz,
           nz = ux * vy - uy * vx;
    double len = std::sqrt(nx * nx + ny * ny + nz * nz);
    if (len < 1e-20) continue;
    nx /= len; ny /= len; nz /= len;
    double d = -(nx * V[t[0]][0] + ny * V[t[0]][1] + nz * V[t[0]][2]);
    for (int k = 0; k < 3; ++k) {
      quadric_add_plane(Q[t[k]], nx, ny, nz, d);
      vfaces[t[k]].push_back(f);
    }
  }

  std::vector<int> version(n_verts, 0);
  std::vector<bool> vdead(n_verts, false), fdead(n_faces, false);
  int faces_alive = n_faces;

  auto neighbors = [&](int v, std::set<int>* out) {
    out->clear();
    for (int f : vfaces[v]) {
      if (fdead[f]) continue;
      for (int k = 0; k < 3; ++k)
        if (F[f][k] != v) out->insert(F[f][k]);
    }
  };

  std::priority_queue<Collapse> heap;
  auto push_edge = [&](int a, int b) {
    if (a > b) std::swap(a, b);
    Collapse c;
    c.a = a;
    c.b = b;
    c.stamp = version[a] + version[b];
    Quadric q = quadric_sum(Q[a], Q[b]);
    if (!quadric_optimum(q, c.pos)) {
      c.pos[0] = 0.5 * (V[a][0] + V[b][0]);
      c.pos[1] = 0.5 * (V[a][1] + V[b][1]);
      c.pos[2] = 0.5 * (V[a][2] + V[b][2]);
    }
    c.cost = quadric_eval(q, c.pos);
    heap.push(c);
  };

  {
    std::set<std::pair<int, int>> seen;
    for (int f = 0; f < n_faces; ++f)
      for (int k = 0; k < 3; ++k) {
        int a = F[f][k], b = F[f][(k + 1) % 3];
        if (a > b) std::swap(a, b);
        if (seen.insert({a, b}).second) push_edge(a, b);
      }
  }

  std::set<int> nb_a, nb_b;
  while (faces_alive > target_faces && !heap.empty()) {
    Collapse c = heap.top();
    heap.pop();
    if (vdead[c.a] || vdead[c.b] ||
        c.stamp != version[c.a] + version[c.b])
      continue;
    // Manifold guard: shared neighbors of a and b must be exactly the
    // opposite vertices of the faces on edge (a, b) (<= 2).
    neighbors(c.a, &nb_a);
    neighbors(c.b, &nb_b);
    int shared = 0;
    for (int v : nb_a)
      if (nb_b.count(v)) ++shared;
    if (shared > 2) continue;

    // Collapse b into a at the optimal position.
    V[c.a] = {c.pos[0], c.pos[1], c.pos[2]};
    Q[c.a] = quadric_sum(Q[c.a], Q[c.b]);
    vdead[c.b] = true;
    for (int f : vfaces[c.b]) {
      if (fdead[f]) continue;
      bool has_a = false;
      for (int k = 0; k < 3; ++k) has_a |= (F[f][k] == c.a);
      if (has_a) {
        fdead[f] = true;
        --faces_alive;
      } else {
        for (int k = 0; k < 3; ++k)
          if (F[f][k] == c.b) F[f][k] = c.a;
        vfaces[c.a].push_back(f);
      }
    }
    version[c.a] += 1;
    version[c.b] += 1;
    neighbors(c.a, &nb_a);
    for (int v : nb_a) push_edge(c.a, v);
  }

  // Compact output.
  std::vector<int> remap(n_verts, -1);
  out_verts->clear();
  out_faces->clear();
  for (int f = 0; f < n_faces; ++f) {
    if (fdead[f]) continue;
    auto& t = F[f];
    if (t[0] == t[1] || t[1] == t[2] || t[0] == t[2]) continue;
    for (int k = 0; k < 3; ++k) {
      int v = t[k];
      if (remap[v] < 0) {
        remap[v] = (int)(out_verts->size() / 3);
        out_verts->push_back((float)V[v][0]);
        out_verts->push_back((float)V[v][1]);
        out_verts->push_back((float)V[v][2]);
      }
      out_faces->push_back(remap[v]);
    }
  }
}

}  // namespace smvs_native
