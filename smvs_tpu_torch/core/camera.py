"""Pinhole camera model with MVE conventions (numpy, host side).

The port's own copy of the pieces of `smvs_tpu/core/camera.py` that the
base-mode path uses: the focal length is normalized by ``max(width,
height)`` and a view pair's warp is ``h = w * M @ (x+0.5, y+0.5, 1) + t``
(reference `lib/correspondence.cc:20-51`).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Camera:
    """MVE-convention camera.

    Attributes:
      flen: focal length normalized by ``max(width, height)``.
      rot: 3x3 world-to-camera rotation.
      trans: camera translation; world point ``p`` maps to ``rot @ p + trans``.
      ppoint: principal point in normalized [0,1] image coordinates.
      paspect: pixel aspect ratio.
    """

    flen: float
    rot: np.ndarray
    trans: np.ndarray
    ppoint: tuple[float, float] = (0.5, 0.5)
    paspect: float = 1.0

    def __post_init__(self):
        self.rot = np.asarray(self.rot, dtype=np.float64).reshape(3, 3)
        self.trans = np.asarray(self.trans, dtype=np.float64).reshape(3)

    def calibration(self, width: int, height: int) -> np.ndarray:
        """Pixel-space intrinsic matrix K (MVE fill_calibration semantics)."""
        dim_aspect = width / height
        image_aspect = dim_aspect * self.paspect
        if image_aspect < 1.0:  # portrait
            ax = self.flen * height / self.paspect
            ay = self.flen * height
        else:
            ax = self.flen * width
            ay = self.flen * width * self.paspect
        return np.array(
            [
                [ax, 0.0, width * self.ppoint[0]],
                [0.0, ay, height * self.ppoint[1]],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )

    def inverse_calibration(self, width: int, height: int) -> np.ndarray:
        K = self.calibration(width, height)
        return np.array(
            [
                [1.0 / K[0, 0], 0.0, -K[0, 2] / K[0, 0]],
                [0.0, 1.0 / K[1, 1], -K[1, 2] / K[1, 1]],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )

    def flen_pixels(self, width: int, height: int) -> float:
        """Focal length in pixels (reference `lib/stereo_view.h:132-139`)."""
        return float(self.calibration(width, height)[0, 0])

    def cam_position(self) -> np.ndarray:
        """Camera center in world coordinates (-R^T t)."""
        return -self.rot.T @ self.trans

    def viewing_direction(self) -> np.ndarray:
        """Optical axis in world coordinates (third row of R)."""
        return self.rot[2]

    def fill_reprojection(
        self,
        dst: "Camera",
        src_width: int,
        src_height: int,
        dst_width: int,
        dst_height: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Warp operator ``(M, t)`` from this (source) view into ``dst``.

        A source pixel ``u = (x+0.5, y+0.5, 1)`` at z-depth ``w`` projects
        to ``h = w * M @ u + t``; the destination pixel is
        ``(h0/h2, h1/h2)`` and its z-depth ``h2``.
        """
        Kd = dst.calibration(dst_width, dst_height)
        Ks_inv = self.inverse_calibration(src_width, src_height)
        R_rel = dst.rot @ self.rot.T
        M = Kd @ R_rel @ Ks_inv
        t = Kd @ (dst.trans - R_rel @ self.trans)
        return M, t
