"""Synthetic two-view scene with analytic ground truth (numpy).

The port's own copy of `smvs_tpu/core/synthetic.py:make_two_view_scene`:
a textured slanted plane seen from view 1, with view 0's image warped
through the known geometry. The arithmetic is the same numpy code, so
the images and depths are bit-equal to the JAX package's scene.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from smvs_tpu_torch.core.camera import Camera


@dataclasses.dataclass
class SyntheticScene:
    cameras: list[Camera]
    images: list[np.ndarray]  # float32 [H, W] in [0, 1]
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
