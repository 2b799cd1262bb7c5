"""Epipolar rectification for the plane-sweep (SGM) initializer (port of
`smvs_tpu/sgm/rectify.py`).

After rectification every inverse-depth plane of the sweep is a pure
x-shift, so the cost volume needs no per-plane gathers. The host-side
math is numpy and identical to the JAX package's; `warp_homography` is
the one image resample per view.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.image import ops as iops


@dataclasses.dataclass(frozen=True)
class RectifiedPair:
    """Host-side rectification data for one (main, neighbor) view pair.

    A pixel (x, y) is addressed at continuous coordinates (x+0.5, y+0.5).

    Attributes:
      H_main / H_nbr: 3x3 homographies from original pixel-center
        homogeneous coords to rectified pixel-center coords.
      fB: rectified focal length times signed baseline; a point at
        rectified depth Z has disparity ``fB / Z + off``.
      off: constant disparity offset.
      L_main: linear form; the main-camera z-depth of rectified pixel r at
        rectified depth Z is ``Z * (L_main @ (r_x, r_y, 1))``.
      disp_lo / disp_hi: disparity sweep bounds.
      nbr_pad: extra columns on each side of the rectified neighbor
        canvas; H_nbr/off/disp_* are in the widened canvas coordinates.
    """

    valid: bool
    width: int = 0
    height: int = 0
    H_main: np.ndarray | None = None
    H_nbr: np.ndarray | None = None
    fB: float = 0.0
    off: float = 0.0
    L_main: np.ndarray | None = None
    disp_lo: float = 0.0
    disp_hi: float = 0.0
    nbr_pad: int = 0


def _pixel_grid_form(row3: np.ndarray, width: int, height: int,
                     n: int = 5) -> np.ndarray:
    """Evaluate a linear form row3 . (x+0.5, y+0.5, 1) over an n x n grid."""
    xs = np.linspace(0.5, width - 0.5, n)
    ys = np.linspace(0.5, height - 0.5, n)
    gx, gy = np.meshgrid(xs, ys)
    return row3[0] * gx + row3[1] * gy + row3[2]


def rectify_pair(
    cam_main: Camera,
    cam_nbr: Camera,
    width: int,
    height: int,
    range_main: tuple[float, float],
    range_nbr: tuple[float, float],
    min_baseline: float = 1e-9,
    min_perp: float = 0.15,
    nbr_pad: int | None = None,
) -> RectifiedPair:
    """Rectifying transforms for a view pair, or ``valid=False`` for a
    degenerate (near-forward-motion) pair. ``range_*`` are (min, max)
    z-depth sweep ranges in each camera's frame."""
    invalid = RectifiedPair(valid=False)

    C1 = cam_main.cam_position()
    C2 = cam_nbr.cam_position()
    b = C2 - C1
    bn = np.linalg.norm(b)
    if bn < min_baseline:
        return invalid

    e1 = b / bn
    if np.dot(e1, cam_main.rot[0]) < 0:
        e1 = -e1
    z_ref = cam_main.viewing_direction()
    e3 = z_ref - np.dot(z_ref, e1) * e1
    n3 = np.linalg.norm(e3)
    if n3 < min_perp:
        return invalid
    e3 /= n3
    e2 = np.cross(e3, e1)
    R_r = np.stack([e1, e2, e3])  # world-to-rectified rotation

    f = cam_main.flen_pixels(width, height)
    K1_inv = cam_main.inverse_calibration(width, height)
    K2_inv = cam_nbr.inverse_calibration(width, height)

    A_main = R_r @ cam_main.rot.T @ K1_inv
    A_nbr = R_r @ cam_nbr.rot.T @ K2_inv

    g_main = _pixel_grid_form(A_main[2], width, height)
    g_nbr = _pixel_grid_form(A_nbr[2], width, height)
    if g_main.min() < 0.2 or g_nbr.min() < 0.2:
        return invalid

    def k_rect(A):
        c = A @ np.array([width / 2.0, height / 2.0, 1.0])
        cx = width / 2.0 - f * c[0] / c[2]
        cy = height / 2.0 - f * c[1] / c[2]
        return np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]]), cx, cy

    K_rm, cx_m, cy_m = k_rect(A_main)
    K_rn, cx_n, _ = k_rect(A_nbr)
    K_rn[1, 2] = K_rm[1, 2]

    H_main = K_rm @ A_main
    H_nbr = K_rn @ A_nbr

    corners = np.array([[0.5, 0.5, 1], [width - 0.5, 0.5, 1],
                        [0.5, height - 0.5, 1],
                        [width - 0.5, height - 0.5, 1]], dtype=np.float64)
    ym = (corners @ H_main.T)
    yn = (corners @ H_nbr.T)
    ym = ym[:, 1] / ym[:, 2]
    yn = yn[:, 1] / yn[:, 2]
    lo = max(ym.min(), yn.min(), 0.0)
    hi = min(ym.max(), yn.max(), float(height))
    if hi - lo < 0.25 * height:
        return invalid

    xn = corners @ H_nbr.T
    xn = xn[:, 0] / xn[:, 2]
    need = max(0.0, -xn.min(), xn.max() - width)
    q = 128 if width >= 768 else 32
    auto_pad = int(min(int(np.ceil(need / q)) * q, 3 * q))
    pad = auto_pad if nbr_pad is None else int(nbr_pad)
    if pad:
        H_nbr = H_nbr.copy()
        H_nbr[0, :] += pad * H_nbr[2, :]
        cx_n += pad

    B = float(np.dot(e1, b))
    fB = f * B
    off = float(cx_m - cx_n)

    z_bounds = []
    for (dmin, dmax), g in ((range_main, g_main), (range_nbr, g_nbr)):
        z_bounds.append(dmin * g.min())
        z_bounds.append(dmax * g.max())
    z_lo, z_hi = max(min(z_bounds), 1e-9), max(z_bounds)
    d_a, d_b = fB / z_lo, fB / z_hi
    disp_lo, disp_hi = min(d_a, d_b) + off, max(d_a, d_b) + off
    disp_lo = float(np.clip(disp_lo, -(width + pad), width + pad))
    disp_hi = float(np.clip(disp_hi, -(width + pad), width + pad))

    L_main = (cam_main.rot @ R_r.T @ np.linalg.inv(K_rm))[2]

    return RectifiedPair(
        valid=True, width=width, height=height,
        H_main=H_main, H_nbr=H_nbr, fB=fB, off=off, L_main=L_main,
        disp_lo=disp_lo, disp_hi=disp_hi, nbr_pad=pad,
    )


def warp_homography(img: torch.Tensor, H_inv: torch.Tensor,
                    out_width: int | None = None) -> torch.Tensor:
    """Resample ``img`` [H, W] under an output->input pixel homography.

    Output pixel (x, y) samples the input at ``H_inv @ (x+0.5, y+0.5, 1)``
    (bilinear, zero outside); ``out_width`` renders onto a wider canvas.
    Rounded as the JAX package's compiled warp: the homography's linear
    forms in plain float32, the bilinear blends as fused multiply-adds
    (`iops.bilinear_packed4_fma`), so the census of a rectified image
    reads the same bits.
    """
    h, w = img.shape
    ow = w if out_width is None else out_width
    ys = torch.arange(h, device=img.device).to(img.dtype)[:, None]
    xs = torch.arange(ow, device=img.device).to(img.dtype)[None, :]
    u = xs + 0.5
    v = ys + 0.5
    Hc = H_inv.to(img.dtype)
    px = Hc[0, 0] * u + Hc[0, 1] * v + Hc[0, 2]
    py = Hc[1, 0] * u + Hc[1, 1] * v + Hc[1, 2]
    pz = Hc[2, 0] * u + Hc[2, 1] * v + Hc[2, 2]
    px = px / pz - 0.5
    py = py / pz - 0.5
    ok = (pz > 0) & (px >= 0) & (py >= 0) & (px <= w - 1) & (py <= h - 1)
    return torch.where(ok, iops.bilinear_packed4_fma(iops.pack_window4(img),
                                                     px, py), 0.0)
