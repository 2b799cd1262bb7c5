"""Synthetic scenes with analytic ground truth (numpy).

The port's own copy of `make_two_view_scene`, `make_plane_scene`,
`make_lambertian_sphere_scene` and `save_as_mve_scene` of
`smvs_tpu/core/synthetic.py`, and of `bench_dtu.py`'s `make_dtu_scene`.
The arithmetic is the same numpy code (the sphere's SH shading in float64
through `shading.sh`), so the images and depths equal the JAX package's
scenes, and a saved scene loads in either package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from smvs_tpu_torch.core import scene as sc
from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.shading import sh as shmod


@dataclasses.dataclass
class SyntheticScene:
    cameras: list[Camera]
    images: list[np.ndarray]  # float32 [H, W] (or [H, W, 3]) in [0, 1]
    depths: list[np.ndarray | None]  # analytic z-depth maps (0 = unknown)
    width: int
    height: int


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear sample img[y, x] with border clamp (MVE linear_at semantics)."""
    h, w = img.shape
    x = np.clip(x, 0.0, w - 1.0)
    y = np.clip(y, 0.0, h - 1.0)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v10 = img[y0, x0 + 1]
    v01 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v10 * fx * (1 - fy)
        + v01 * (1 - fx) * fy
        + v11 * fx * fy
    )


def make_two_view_scene(
    dim: int = 460,
    gridsize: int = 15,
    depth_fn=None,
    baseline: float = 0.3,
    rotate: bool = True,
    texture: str = "checker",
) -> SyntheticScene:
    """The two-view scene of the reference harness
    (`tests/test_optimization.cc:40-116`).

    View 1 carries the analytic depth ``depth_fn(i, j)`` (default: the
    slanted plane ``5 + 0.005*i + 0.005*j``); view 0's image is the
    texture, and view 1's image plus view 0's depth are synthesized by
    warping.
    """
    if depth_fn is None:
        depth_fn = lambda i, j: 5.0 + 0.005 * i + 0.005 * j  # noqa: E731

    rot0 = np.eye(3)
    trans0 = np.zeros(3)
    if rotate:
        rot1 = np.array(
            [
                [0.9958143234, -0.09047859907, -0.02066593803],
                [0.0904353857, 0.996034503, -0.003206958761],
                [0.02082847804, 0.001360671129, 0.9998072386],
            ]
        )
    else:
        rot1 = np.eye(3)
    trans1 = np.array([baseline, 0.0, 0.0])

    cam0 = Camera(flen=1.0, rot=rot0, trans=trans0)
    cam1 = Camera(flen=1.0, rot=rot1, trans=trans1)

    xs, ys = np.meshgrid(np.arange(dim), np.arange(dim), indexing="xy")
    if texture == "noise":
        rng = np.random.default_rng(7)
        tex = rng.uniform(60.0, 180.0, size=(dim, dim))
        k = np.exp(-0.5 * (np.arange(-4, 5) / 1.5) ** 2)
        k /= k.sum()
        tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, tex)
        tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
        image0 = tex
    else:
        image0 = np.where((np.abs(xs // gridsize - ys // gridsize) % 2) == 0,
                          120.0, 80.0)
    image0 = (image0 / 255.0).astype(np.float32)

    depth1 = depth_fn(xs.astype(np.float64), ys.astype(np.float64))

    M, t = cam1.fill_reprojection(cam0, dim, dim, dim, dim)
    u = xs + 0.5
    v = ys + 0.5
    p = np.stack([u, v, np.ones_like(u)], axis=-1) @ M.T  # [H,W,3]
    proj = p * depth1[..., None] + t
    px = proj[..., 0] / proj[..., 2] - 0.5
    py = proj[..., 1] / proj[..., 2] - 0.5
    pz = proj[..., 2]
    valid = (px > 0.0) & (px < dim) & (py > 0.0) & (py < dim)

    image1 = np.full((dim, dim), 100.0 / 255.0, dtype=np.float64)
    image1[valid] = _bilinear(image0.astype(np.float64), px[valid], py[valid])

    depth0 = np.zeros((dim, dim), dtype=np.float64)
    ix = np.clip(px[valid].astype(np.int64), 0, dim - 1)
    iy = np.clip(py[valid].astype(np.int64), 0, dim - 1)
    depth0[iy, ix] = pz[valid]

    return SyntheticScene(
        cameras=[cam0, cam1],
        images=[image0.astype(np.float32), image1.astype(np.float32)],
        depths=[depth0, depth1],
        width=dim,
        height=dim,
    )


def make_plane_scene(
    n_views: int = 3,
    dim: int = 200,
    plane=(0.0, 0.05, 0.1, 5.0),  # n . P = d with n = (nx, ny, 1) normalized
    baseline: float = 0.15,
    cameras: list[Camera] | None = None,
    color: bool = False,
) -> SyntheticScene:
    """N views of an analytically textured world plane.

    Every view's image and depth are rendered exactly (no resampling): the
    plane ``n . P = d`` is intersected per pixel ray and shaded with a
    smooth analytic texture. ``cameras`` renders the given views instead
    of ``n_views`` on a sideways line (the JAX version's only layout).
    ``color`` renders [H, W, 3] images whose channels carry the texture
    shifted and scaled differently (the gray scene's image is the red
    channel), so a view's luminance differs from every channel.
    """
    nrm = np.array([plane[0], plane[1], 1.0])
    nrm /= np.linalg.norm(nrm)
    d_off = plane[3]

    def texture(x, y):
        return (
            0.55
            + 0.18 * np.sin(2.1 * x) * np.sin(1.7 * y)
            + 0.12 * np.sin(5.3 * x + 1.0) * np.cos(4.1 * y)
            + 0.08 * np.cos(9.7 * x - 2.0) * np.sin(8.3 * y + 0.7)
        )

    if cameras is None:
        cameras = _sideways_cameras(n_views, baseline)

    images, depths = [], []
    xs, ys = np.meshgrid(np.arange(dim), np.arange(dim), indexing="xy")
    for cam in cameras:
        inv = cam.inverse_calibration(dim, dim)
        dir_cam = np.stack(
            [inv[0, 0] * (xs + 0.5) + inv[0, 2],
             inv[1, 1] * (ys + 0.5) + inv[1, 2],
             np.ones_like(xs, dtype=np.float64)], axis=-1)
        dir_world = dir_cam @ cam.rot  # R^T d
        C = cam.cam_position()
        s = (d_off - nrm @ C) / (dir_world @ nrm)
        P = C + s[..., None] * dir_world
        depths.append(s.copy())  # z-depth: dir_cam's z-component is 1
        px, py = P[..., 0], P[..., 1]
        img = texture(px, py)
        if color:
            img = np.stack([img, 0.9 * texture(px + 0.37, py - 0.21) + 0.04,
                            1.1 - texture(0.8 * px, 1.2 * py + 0.5)],
                           axis=-1)
        images.append(img.astype(np.float32))
    return SyntheticScene(cameras=cameras, images=images, depths=depths,
                          width=dim, height=dim)


def make_dtu_scene(n_views: int, dims: list[int]) -> SyntheticScene:
    """``n_views`` views of the plane of `make_plane_scene` from a camera
    grid of 7 columns, view i rendered at ``dims[i]`` x ``dims[i]`` (the
    JAX repository's DTU-scale benchmark scene, `bench_dtu.py`); the
    scene's width and height are those of the last view."""
    plane = (0.0, 0.05, 0.1, 5.0)
    nrm = np.array([plane[0], plane[1], 1.0])
    nrm /= np.linalg.norm(nrm)
    d_off = plane[3]

    def texture(x, y):
        return (
            0.55
            + 0.18 * np.sin(2.1 * x) * np.sin(1.7 * y)
            + 0.12 * np.sin(5.3 * x + 1.0) * np.cos(4.1 * y)
            + 0.08 * np.cos(9.7 * x - 2.0) * np.sin(8.3 * y + 0.7)
        )

    cols = 7
    rows = (n_views + cols - 1) // cols
    cameras = []
    for i in range(n_views):
        gx = i % cols - (cols - 1) / 2
        gy = i // cols - (rows - 1) / 2
        yaw = 0.03 * gx
        pitch = 0.02 * gy
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        rot = (np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
               @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
        cam_pos = np.array([0.12 * gx, 0.10 * gy, 0.0])
        cameras.append(Camera(flen=1.0, rot=rot, trans=-rot @ cam_pos))

    images, depths = [], []
    for i, cam in enumerate(cameras):
        dim = dims[i]
        xs, ys = np.meshgrid(np.arange(dim), np.arange(dim), indexing="xy")
        inv = cam.inverse_calibration(dim, dim)
        dir_cam = np.stack(
            [inv[0, 0] * (xs + 0.5) + inv[0, 2],
             inv[1, 1] * (ys + 0.5) + inv[1, 2],
             np.ones_like(xs, dtype=np.float64)], axis=-1)
        dir_world = dir_cam @ cam.rot
        C = cam.cam_position()
        s = (d_off - nrm @ C) / (dir_world @ nrm)
        P = C + s[..., None] * dir_world
        depths.append(s.copy())
        images.append(texture(P[..., 0], P[..., 1]).astype(np.float32))
    return SyntheticScene(cameras=cameras, images=images, depths=depths,
                          width=dims[-1], height=dims[-1])


def _sideways_cameras(n_views: int, baseline: float) -> list[Camera]:
    cameras = []
    for i in range(n_views):
        angle = 0.04 * (i - (n_views - 1) / 2)
        ca, sa = np.cos(angle), np.sin(angle)
        rot = np.array([[ca, 0, -sa], [0, 1, 0], [sa, 0, ca]])
        cam_pos = np.array([baseline * (i - (n_views - 1) / 2), 0.0, 0.0])
        trans = -rot @ cam_pos
        cameras.append(Camera(flen=1.0, rot=rot, trans=trans))
    return cameras


def make_lambertian_sphere_scene(
    n_views: int = 3,
    dim: int = 200,
    center=(0.0, 0.0, 6.0),
    radius: float = 2.8,
    baseline: float = 0.15,
    light_params: np.ndarray | None = None,
) -> SyntheticScene:
    """N views of a textureless Lambertian sphere under SH lighting: the
    shape-from-shading ground truth of the `-S` path. Uniform albedo,
    intensity = SH(light, world normal) clipped to [0, 1], exact per-pixel
    ray-sphere depth; background pixels get depth 0 and intensity 0 (below
    the lighting fit's 0.05 gate)."""
    if light_params is None:
        # gentle directional lighting over a positive ambient floor
        light_params = np.zeros(16)
        light_params[0] = 0.55
        light_params[1] = 0.18   # x band
        light_params[2] = -0.12  # y band
        light_params[3] = -0.25  # z band (camera-facing normals have z<0)
    O = np.asarray(center, np.float64)

    images, depths = [], []
    xs, ys = np.meshgrid(np.arange(dim), np.arange(dim), indexing="xy")
    cameras = _sideways_cameras(n_views, baseline)
    for cam in cameras:
        inv = cam.inverse_calibration(dim, dim)
        dir_cam = np.stack(
            [inv[0, 0] * (xs + 0.5) + inv[0, 2],
             inv[1, 1] * (ys + 0.5) + inv[1, 2],
             np.ones_like(xs, dtype=np.float64)], axis=-1)
        dir_world = dir_cam @ cam.rot  # R^T d
        C = cam.cam_position()
        # |C + s*d - O|^2 = r^2, near root; z-depth = s (dir_cam z == 1).
        oc = C - O
        a = np.sum(dir_world**2, axis=-1)
        b = 2.0 * (dir_world @ oc)
        c = oc @ oc - radius * radius
        disc = b * b - 4.0 * a * c
        hit = disc > 0.0
        s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a),
                     0.0)
        P = C + s[..., None] * dir_world
        n_world = (P - O) / radius
        basis = shmod.eval_4_band(torch.from_numpy(n_world.reshape(-1, 3)))
        val = basis.numpy() @ np.asarray(light_params)
        val = np.clip(val.reshape(dim, dim), 0.0, 1.0)
        images.append(np.where(hit, val, 0.0).astype(np.float32))
        depths.append(np.where(hit, s, 0.0))
    return SyntheticScene(cameras=cameras, images=images, depths=depths,
                          width=dim, height=dim)


def forward_cameras() -> list[Camera]:
    """Four views moving toward the plane of `make_plane_scene`, 0.4 apart
    with a little sideways jitter. No pair rectifies (near-forward
    motion), so their SGM takes the general warp."""
    centers = ((0.0, 0.0, 0.0), (0.05, 0.02, 0.4), (-0.04, 0.03, 0.8),
               (0.02, -0.03, 1.2))
    return [Camera(flen=1.0, rot=np.eye(3), trans=-np.asarray(c))
            for c in centers]


def degrade_scene(
    scene: SyntheticScene,
    noise_std: float = 0.0,
    exposure_delta: float = 0.0,
    gamma_err: float = 0.0,
    seed: int = 0,
) -> SyntheticScene:
    """Photo-like degradations of the images, the cameras and depths
    untouched: ``gamma_err`` a per-view exponent error image **
    (1 + gamma_err * u_i), ``exposure_delta`` a per-view gain
    1 + exposure_delta * u_i (u_i evenly spaced in [-1, 1] over the
    views), ``noise_std`` i.i.d. Gaussian sensor noise drawn from
    ``seed``, in that order, then clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    n = len(scene.images)
    us = np.linspace(-1.0, 1.0, n) if n > 1 else np.zeros(1)
    images = []
    for i, img in enumerate(scene.images):
        out = np.asarray(img, np.float64)
        if gamma_err:
            out = np.clip(out, 0.0, None) ** (1.0 + gamma_err * us[i])
        if exposure_delta:
            out = out * (1.0 + exposure_delta * us[i])
        if noise_std:
            out = out + rng.normal(size=out.shape) * noise_std
        images.append(np.clip(out, 0.0, 1.0).astype(np.float32))
    return dataclasses.replace(scene, images=images)


def save_as_mve_scene(scene: SyntheticScene, path: str,
                      n_features: int = 200) -> None:
    """Write the synthetic scene as an on-disk MVE scene (views + bundle).

    Features are sampled from the last view's analytic depth and
    back-projected to world, observed by all views: enough for bundle-based
    view selection and SGM depth ranges.
    """
    views = []
    for i, (cam, img) in enumerate(zip(scene.cameras, scene.images)):
        v = sc.View(view_id=i, name=f"{i:03d}", camera=cam)
        v.set_image("undistorted",
                    np.clip(img * 255.0, 0, 255).astype(np.uint8))
        views.append(v)

    ref = len(scene.cameras) - 1
    cam_r = scene.cameras[ref]
    depth_r = scene.depths[ref]
    inv = cam_r.inverse_calibration(scene.width, scene.height)
    rng = np.random.default_rng(0)
    feats = []
    for _ in range(n_features):
        x = rng.integers(5, scene.width - 5)
        y = rng.integers(5, scene.height - 5)
        z = depth_r[y, x]
        if z <= 0:
            continue
        ray = inv @ np.array([x + 0.5, y + 0.5, 1.0])
        p_world = cam_r.rot.T @ (ray * z - cam_r.trans)
        feats.append(sc.Feature3D(pos=p_world, color=np.array([128, 128, 128]),
                                  refs=list(range(len(scene.cameras)))))
    bundle = sc.Bundle(cameras=list(scene.cameras), features=feats)
    os.makedirs(path, exist_ok=True)
    for i, v in enumerate(views):
        v.path = os.path.join(path, "views", f"view_{i:04d}.mve")
    sc.Scene(path=path, views=views, bundle=bundle).save()
