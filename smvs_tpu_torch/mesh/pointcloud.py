"""Global fusion of per-view depth maps into a world-space point set
(numpy, host side; port of `smvs_tpu/mesh/pointcloud.py`, reference
`lib/mesh_generator.cc`).

Back-projects each view's depth map along pixel rays, rotates normals to
world space (with the internal (n, -n, -n) convention flip, reference
:195-203), cuts surfaces by projected-area ("surface power") consistency
across views (:24-158), and attaches a per-vertex footprint scale and
boundary confidence (:249-262), or triangulates each cut depth map and
merges the meshes (the CLI's ``-m``, greedy simplified with ``-y``;
`mesh/triangulate.py`). The JAX package computes these in numpy on the
host too; moving fusion onto the card is queued in ROADMAP.md.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np

from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.mesh import triangulate as tri
from smvs_tpu_torch.mesh.ply import PointSet


@dataclasses.dataclass
class FusionOptions:
    """Mirror of `MeshGenerator::Options` (reference
    `lib/mesh_generator.h:23-34`)."""

    cut_surfaces: bool = True
    create_triangle_mesh: bool = False
    simplify: bool = False  # read with create_triangle_mesh only


def backproject(depth_z: np.ndarray, camera: Camera) -> np.ndarray:
    """Per-pixel 3D world positions [H, W, 3] from a z-depth map (0 -> origin)."""
    h, w = depth_z.shape
    inv = camera.inverse_calibration(w, h)
    xs = np.arange(w) + 0.5
    ys = np.arange(h) + 0.5
    vx = inv[0, 0] * xs + inv[0, 2]
    vy = inv[1, 1] * ys + inv[1, 2]
    p_cam = np.stack(
        [np.broadcast_to(vx[None, :], (h, w)) * depth_z,
         np.broadcast_to(vy[:, None], (h, w)) * depth_z,
         depth_z], axis=-1)
    return (p_cam - camera.trans) @ camera.rot  # R^T (p - t)


def normals_to_world(normals_cam: np.ndarray, camera: Camera) -> np.ndarray:
    """smvs-internal normals -> world (reference :195-203 flips y/z first)."""
    flipped = normals_cam * np.asarray([1.0, -1.0, -1.0])
    return flipped @ camera.rot  # cam-to-world rotation = R^T, applied as x@R


def footprint_scale(depth_z: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Per-pixel scale = 2 x mean distance to valid 4/8-neighbors

    (approximates the reference's mean adjacent-vertex distance over the
    full triangulation, :252-262).
    """
    h, w = depth_z.shape
    valid = depth_z > 0
    total = np.zeros((h, w))
    count = np.zeros((h, w))
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        sl_src = (slice(max(dy, 0), h + min(dy, 0)),
                  slice(max(dx, 0), w + min(dx, 0)))
        sl_dst = (slice(max(-dy, 0), h + min(-dy, 0)),
                  slice(max(-dx, 0), w + min(-dx, 0)))
        nb_valid = valid[sl_src] & valid[sl_dst]
        d = np.linalg.norm(positions[sl_src] - positions[sl_dst], axis=-1)
        total[sl_dst] += np.where(nb_valid, d, 0.0)
        count[sl_dst] += nb_valid
    return np.where(count > 0, total / np.maximum(count, 1), 0.0) * 2.0


def boundary_confidence(depth_z: np.ndarray, rings: int = 4) -> np.ndarray:
    """Confidence 0 at reconstruction boundaries ramping to 1 after `rings`

    erosion steps (counterpart of mve::geom::depthmap_mesh_confidences as
    used at reference :249-250).
    """
    valid = depth_z > 0
    conf = np.zeros(depth_z.shape, np.float32)
    cur = valid.copy()
    for r in range(rings + 1):
        conf = np.where(cur, (r / (rings + 1.0)), conf)
        # erode: keep pixels whose 8-neighborhood is fully inside `cur`
        p = np.pad(cur, 1)
        er = p[:-2, :-2] & p[:-2, 1:-1] & p[:-2, 2:] & p[1:-1, :-2] & \
            p[1:-1, 2:] & p[2:, :-2] & p[2:, 1:-1] & p[2:, 2:]
        cur = cur & er
    conf = np.where(cur, 1.0, conf)
    return np.where(valid, conf, 0.0)


def _surface_power(KR: np.ndarray, t: np.ndarray, pos: np.ndarray,
                   normal: np.ndarray) -> np.ndarray:
    """Projected surface area of an oriented point in a view

    (reference `ViewProjection::get_surface_power`, :323-344).
    pos/normal: [..., 3].
    """
    u = pos @ KR[0] - t[0]
    v = pos @ KR[1] - t[1]
    w = pos @ KR[2] - t[2]
    denom = np.maximum(w * w, 1e-20)
    u_dx = (KR[0] * w[..., None] - KR[2] * u[..., None]) / denom[..., None]
    v_dx = (KR[1] * w[..., None] - KR[2] * v[..., None]) / denom[..., None]
    return -np.sum(normal * np.cross(u_dx, v_dx), axis=-1)


def _view_projection(camera: Camera, width: int, height: int):
    K = camera.calibration(width, height)
    KR = K @ camera.rot
    t = KR @ camera.cam_position()
    return KR, t


def cut_depth_maps(
    depths: list[np.ndarray],
    normals_world: list[np.ndarray],
    positions: list[np.ndarray],
    cameras: list[Camera],
) -> list[np.ndarray]:
    """Cross-view consistency cutting (reference `cut_depth_maps`, :24-158).

    All maps are z-depth; positions/normals in world space. Returns the cut
    depth maps.
    """
    n = len(depths)
    projs = [_view_projection(cameras[j], d.shape[1], d.shape[0])
             for j, d in enumerate(depths)]
    # Precompute each view's own surface power field
    own_power = []
    for j in range(n):
        KR, t = projs[j]
        own_power.append(_surface_power(KR, t, positions[j],
                                        normals_world[j]))
    out = []
    for i in range(n):
        d_i = depths[i]
        valid = d_i > 0
        pos = positions[i]
        nrm = normals_world[i]
        KR_i, t_i = projs[i]
        power_i = own_power[i]
        keep = valid & (power_i >= 0)
        consistency = np.zeros(d_i.shape, np.float32)
        killed = np.zeros(d_i.shape, bool)
        for j in range(n):
            if j == i:
                continue
            KR_j, t_j = projs[j]
            hj, wj = depths[j].shape
            u = pos @ KR_j[0] - t_j[0]
            v = pos @ KR_j[1] - t_j[1]
            z = pos @ KR_j[2] - t_j[2]
            ok = valid & (z > 0)
            xj = np.clip((u / np.where(z == 0, 1, z)).astype(np.int64), 0,
                         wj - 1)
            yj = np.clip((v / np.where(z == 0, 1, z)).astype(np.int64), 0,
                         hj - 1)
            inb = ok & (u / np.where(z == 0, 1, z) >= 0) & \
                (u / np.where(z == 0, 1, z) < wj) & \
                (v / np.where(z == 0, 1, z) >= 0) & \
                (v / np.where(z == 0, 1, z) < hj)
            dm_j = depths[j][yj, xj]
            inb &= dm_j > 0

            power_j = _surface_power(KR_j, t_j, pos, nrm)
            power_jj = own_power[j][yj, xj]

            behind = dm_j * 1.01 < z  # our point is behind j's surface
            in_front = dm_j * 0.997 > z
            matched = inb & ~behind & ~in_front
            front = inb & in_front

            consistency -= np.where(front & (power_jj > 0.5 * power_i),
                                    power_jj, 0.0)
            killed |= matched & ((power_jj > 2.0 * power_i)
                                 | (power_j > 2.0 * power_i))
            consistency += np.where(matched, power_jj, 0.0)
        keep &= ~killed & (consistency > 0)
        out.append(np.where(keep, d_i, 0.0))
    return out


def fuse_views(
    depths: list[np.ndarray],
    normals_cam: list[np.ndarray],
    cameras: list[Camera],
    colors: list[np.ndarray] | None = None,
    opts: FusionOptions = FusionOptions(),
) -> PointSet:
    """Fuse per-view (z-depth, smvs normal map) into one world point set,
    or with ``opts.create_triangle_mesh`` into one merged triangle mesh
    (reference `generate_mesh`, :160-299; point-set branch :284-292).
    """
    positions = [backproject(d, c) for d, c in zip(depths, cameras)]
    normals_w = [normals_to_world(nc, c)
                 for nc, c in zip(normals_cam, cameras)]
    if opts.cut_surfaces and len(depths) > 1:
        depths = cut_depth_maps(depths, normals_w, positions, cameras)

    if opts.create_triangle_mesh:
        if opts.simplify:
            # The greedy triangulation runs in C++ outside the GIL: one
            # thread per view, the meshes merged in view order.
            with concurrent.futures.ThreadPoolExecutor(len(depths)) as ex:
                meshes = list(ex.map(tri.approximate_triangulation, depths,
                                     cameras))
        else:
            meshes = [tri.full_triangulation(
                d, cameras[i], color=None if colors is None else colors[i])
                for i, d in enumerate(depths)]
        return tri.merge_meshes(meshes)

    verts, norms, vals, confs, cols = [], [], [], [], []
    for i, d in enumerate(depths):
        mask = d > 0
        pos = positions[i]
        verts.append(pos[mask])
        norms.append(normals_w[i][mask])
        vals.append(footprint_scale(d, pos)[mask])
        confs.append(boundary_confidence(d)[mask])
        if colors is not None:
            c = colors[i]
            if c.ndim == 2:
                c = np.repeat(c[..., None], 3, axis=-1)
            cols.append(np.clip(c[mask] * 255.0, 0, 255).astype(np.uint8)
                        if c.dtype != np.uint8 else c[mask])
    return PointSet(
        vertices=np.concatenate(verts).astype(np.float32),
        normals=np.concatenate(norms).astype(np.float32),
        values=np.concatenate(vals).astype(np.float32),
        confidences=np.concatenate(confs).astype(np.float32),
        colors=np.concatenate(cols) if cols else None,
    )


def clip_aabb(ps: PointSet, aabb_min, aabb_max) -> PointSet:
    """Axis-aligned bounding-box clip (reference `app/smvsrecon.cc:300-330`)."""
    m = np.all((ps.vertices >= np.asarray(aabb_min))
               & (ps.vertices <= np.asarray(aabb_max)), axis=-1)

    def sel(x):
        return None if x is None else x[m]

    return PointSet(vertices=ps.vertices[m], normals=sel(ps.normals),
                    colors=sel(ps.colors), values=sel(ps.values),
                    confidences=sel(ps.confidences))
