"""Image gradient + Hessian by least-squares quadratic fit on 3x3 windows
(port of `smvs_tpu/image/gradients.py`, reference `lib/stereo_view.cc:98-188`).

A fixed 6x9 matrix maps the 3x3 neighborhood to the coefficients of the
best-fit quadratic a*x^2 + b*y^2 + c*xy + d*x + e*y + f; the gradient is
(d, e) and the Hessian (2a, c, 2b). Border pixels are zero.
"""

from __future__ import annotations

import numpy as np
import torch

# M[k, c] with c = (a+1)*3 + (b+1) indexing the sample at offset (a=dx, b=dy).
_M = np.array(
    [
        [1 / 6, 1 / 6, 1 / 6, -1 / 3, -1 / 3, -1 / 3, 1 / 6, 1 / 6, 1 / 6],
        [1 / 6, -1 / 3, 1 / 6, 1 / 6, -1 / 3, 1 / 6, 1 / 6, -1 / 3, 1 / 6],
        [1 / 4, 0, -1 / 4, 0, 0, 0, -1 / 4, 0, 1 / 4],
        [-1 / 6, -1 / 6, -1 / 6, 0, 0, 0, 1 / 6, 1 / 6, 1 / 6],
        [-1 / 6, 0, 1 / 6, -1 / 6, 0, 1 / 6, -1 / 6, 0, 1 / 6],
        [-1 / 9, 2 / 9, -1 / 9, 2 / 9, 5 / 9, 2 / 9, -1 / 9, 2 / 9, -1 / 9],
    ],
    dtype=np.float64,
)


def gradients_and_hessian(img: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(gradient [2, H, W], hessian [3, H, W]) of img [H, W]: channels
    (Ix, Iy) and (Ixx, Ixy, Iyy); the border ring is zero."""
    m = torch.as_tensor(_M, dtype=img.dtype, device=img.device)
    h, w = img.shape
    acc = [torch.zeros_like(img) for _ in range(6)]
    xp = torch.nn.functional.pad(img, (1, 1, 1, 1))
    for a in range(-1, 2):  # x offset
        for b in range(-1, 2):  # y offset
            c = (a + 1) * 3 + (b + 1)
            shifted = xp[1 + b : 1 + b + h, 1 + a : 1 + a + w]
            for k in range(6):
                acc[k] = acc[k] + m[k, c] * shifted

    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    r = [torch.where(interior, a_, 0.0) for a_ in acc]
    gradient = torch.stack([r[3], r[4]])
    hessian = torch.stack([2.0 * r[0], r[2], 2.0 * r[1]])
    return gradient, hessian
