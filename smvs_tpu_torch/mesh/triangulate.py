"""Depth-map triangulation (full grid + approximate greedy), numpy on the
host (port of `smvs_tpu/mesh/triangulate.py`, the same arithmetic).

Counterpart of reference `lib/depth_triangulator.cc`:

- ``full_triangulation`` mirrors MVE's ``depthmap_triangulate`` (used at
  reference :19-25): a grid mesh over valid pixels with depth-discontinuity
  rejection,
- ``approximate_triangulation`` back-projects the native greedy
  triangulation (C++: `smvs_tpu_torch/native/triangulate.cpp`, reference
  :27-173).
"""

from __future__ import annotations

import numpy as np

from smvs_tpu_torch import native
from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.mesh.ply import PointSet


def _backproject_pixels(xs, ys, depths, camera: Camera, width, height):
    inv = camera.inverse_calibration(width, height)
    vx = inv[0, 0] * (xs + 0.5) + inv[0, 2]
    vy = inv[1, 1] * (ys + 0.5) + inv[1, 2]
    p_cam = np.stack([vx * depths, vy * depths, depths], axis=-1)
    return (p_cam - camera.trans) @ camera.rot


def full_triangulation(depth_z: np.ndarray, camera: Camera,
                       dd_factor: float = 5.0,
                       color: np.ndarray | None = None) -> PointSet:
    """Grid triangulation with depth-discontinuity rejection.

    An edge between adjacent pixels survives when the depth difference stays
    below ``dd_factor * min_depth * pixel_footprint``; 2x2 blocks with all
    four corners valid are split along the diagonal.
    """
    h, w = depth_z.shape
    valid = depth_z > 0
    idx = np.full((h, w), -1, np.int64)
    ys, xs = np.nonzero(valid)
    idx[ys, xs] = np.arange(len(xs))
    verts = _backproject_pixels(xs.astype(np.float64), ys.astype(np.float64),
                                depth_z[ys, xs], camera, w, h)

    fp = 1.0 / camera.flen_pixels(w, h)  # angular pixel footprint

    def edge_ok(d1, d2):
        return np.abs(d1 - d2) <= dd_factor * np.minimum(d1, d2) * fp

    d00 = depth_z[:-1, :-1]
    d10 = depth_z[:-1, 1:]
    d01 = depth_z[1:, :-1]
    d11 = depth_z[1:, 1:]
    v00 = valid[:-1, :-1]
    v10 = valid[:-1, 1:]
    v01 = valid[1:, :-1]
    v11 = valid[1:, 1:]
    i00 = idx[:-1, :-1]
    i10 = idx[:-1, 1:]
    i01 = idx[1:, :-1]
    i11 = idx[1:, 1:]

    faces = []

    def add(mask, a, b, c, da, db, dc):
        ok = mask & edge_ok(da, db) & edge_ok(db, dc) & edge_ok(da, dc)
        faces.append(np.stack([a[ok], b[ok], c[ok]], axis=-1))

    all4 = v00 & v10 & v01 & v11
    # split along the shorter diagonal
    diag_a = np.abs(d00 - d11)
    diag_b = np.abs(d10 - d01)
    split_a = all4 & (diag_a <= diag_b)
    split_b = all4 & ~split_a
    add(split_a, i00, i01, i11, d00, d01, d11)
    add(split_a, i00, i11, i10, d00, d11, d10)
    add(split_b, i00, i01, i10, d00, d01, d10)
    add(split_b, i01, i11, i10, d01, d11, d10)
    # exactly-three-valid corners
    add(v00 & v10 & v01 & ~v11, i00, i01, i10, d00, d01, d10)
    add(v00 & v10 & ~v01 & v11, i00, i11, i10, d00, d11, d10)
    add(v00 & ~v10 & v01 & v11, i00, i01, i11, d00, d01, d11)
    add(~v00 & v10 & v01 & v11, i01, i11, i10, d01, d11, d10)

    faces = np.concatenate(faces) if faces else np.zeros((0, 3), np.int64)
    colors = None
    if color is not None:
        c = color[ys, xs]
        if c.ndim == 1:
            c = np.repeat(c[:, None], 3, axis=-1)
        colors = np.clip(c * 255.0, 0, 255).astype(np.uint8) \
            if c.dtype != np.uint8 else c
    return PointSet(vertices=verts.astype(np.float32),
                    faces=faces.astype(np.int32), colors=colors)


def approximate_triangulation(depth_z: np.ndarray, camera: Camera,
                              max_vertex_fraction: float = 0.025,
                              error_fraction: float = 0.0005) -> PointSet:
    """Greedy simplified triangulation, back-projected to world space."""
    h, w = depth_z.shape
    vxyd, faces = native.approximate_triangulation(
        np.asarray(depth_z, np.float32), max_vertex_fraction, error_fraction)
    if len(vxyd) == 0:
        return PointSet(vertices=np.zeros((0, 3), np.float32),
                        faces=np.zeros((0, 3), np.int32))
    verts = _backproject_pixels(vxyd[:, 0], vxyd[:, 1], vxyd[:, 2],
                                camera, w, h)
    return PointSet(vertices=verts.astype(np.float32),
                    faces=faces.astype(np.int32))


def merge_meshes(meshes: list[PointSet]) -> PointSet:
    """Append meshes (mve::geom::mesh_merge semantics, reference :280-283)."""
    verts, faces, colors = [], [], []
    off = 0
    has_colors = all(m.colors is not None for m in meshes if len(m.vertices))
    for m in meshes:
        if len(m.vertices) == 0:
            continue
        verts.append(m.vertices)
        if m.faces is not None and len(m.faces):
            faces.append(m.faces + off)
        if has_colors and m.colors is not None:
            colors.append(m.colors)
        off += len(m.vertices)
    if not verts:
        return PointSet(vertices=np.zeros((0, 3), np.float32))
    return PointSet(
        vertices=np.concatenate(verts),
        faces=np.concatenate(faces).astype(np.int32) if faces else None,
        colors=np.concatenate(colors) if colors else None,
    )
