"""Scaled (non-orthonormal) spherical-harmonics bases (port of
`smvs_tpu/shading/sh.py`, reference `lib/spherical_harmonics.h`).

The smvs shading model drops the normalization constants of the basis
(`evaluate_3_band` / `evaluate_4_band`, reference :53-151); the lighting
coefficients absorb the scale. `eval_4_band_jac` is the hand-derived
derivative table (reference :157-201). Plain tensor functions of normals
[..., 3].
"""

from __future__ import annotations

import torch


def eval_3_band_exact(n: torch.Tensor) -> torch.Tensor:
    """Orthonormal 3-band SH (9 coeffs); reference :22-47. n: (..., 3)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    c0 = 0.28209479177387814347
    c1 = 0.48860251190291992158
    c2 = 0.94617469575756001809
    c3 = 0.31539156525252000603
    c4 = 1.09254843059207907054
    c5 = 0.54627421529603953526
    return torch.stack(
        [
            torch.full_like(x, c0),
            c1 * y,
            c1 * z,
            c1 * x,
            c4 * x * y,
            c4 * z * y,
            c2 * z * z - c3,
            c4 * z * x,
            c5 * (x * x - y * y),
        ],
        dim=-1,
    )


def eval_3_band(n: torch.Tensor) -> torch.Tensor:
    """Scaled 3-band SH (9 coeffs); reference :53-73. n: (..., 3)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack(
        [
            torch.ones_like(x),
            y,
            z,
            x,
            x * y,
            y * z,
            -x * x - y * y + 2.0 * z * z,
            x * z,
            x * x - y * y,
        ],
        dim=-1,
    )


def eval_4_band(n: torch.Tensor) -> torch.Tensor:
    """Scaled 4-band SH (16 coeffs); reference :133-151. n: (..., 3)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    l3 = torch.stack(
        [
            (3.0 * x2 - y2) * y,
            x * y * z,
            (4.0 * z2 - x2 - y2) * y,
            (2.0 * z2 - 3.0 * x2 - 3.0 * y2) * z,
            (4.0 * z2 - x2 - y2) * x,
            (x2 - y2) * z,
            (x2 - 3.0 * y2) * x,
        ],
        dim=-1,
    )
    return torch.cat([eval_3_band(n), l3], dim=-1)


def eval_4_band_jac(n: torch.Tensor) -> torch.Tensor:
    """Analytic d(eval_4_band)/dn: (..., 3) -> (..., 16, 3); row 0 (the
    constant band) is zero (reference :157-201)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    x2, y2, z2 = x * x, y * y, z * z
    rows = [
        (zero, zero, zero),                                   # 1
        (zero, one, zero),                                    # y
        (zero, zero, one),                                    # z
        (one, zero, zero),                                    # x
        (y, x, zero),                                         # xy
        (zero, z, y),                                         # yz
        (-2.0 * x, -2.0 * y, 4.0 * z),                        # -x2-y2+2z2
        (z, zero, x),                                         # xz
        (2.0 * x, -2.0 * y, zero),                            # x2-y2
        (6.0 * x * y, 3.0 * x2 - 3.0 * y2, zero),             # (3x2-y2)y
        (y * z, x * z, x * y),                                # xyz
        (-2.0 * x * y, 4.0 * z2 - x2 - 3.0 * y2, 8.0 * y * z),  # (4z2-x2-y2)y
        (-6.0 * x * z, -6.0 * y * z, 6.0 * z2 - 3.0 * x2 - 3.0 * y2),
        (4.0 * z2 - 3.0 * x2 - y2, -2.0 * x * y, 8.0 * x * z),  # (4z2-x2-y2)x
        (2.0 * x * z, -2.0 * y * z, x2 - y2),                 # (x2-y2)z
        (3.0 * x2 - 3.0 * y2, -6.0 * x * y, zero),            # (x2-3y2)x
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
