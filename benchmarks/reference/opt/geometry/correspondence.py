"""Closed-form stereo correspondence (port of
`smvs_tpu/geometry/correspondence.py`, reference `lib/correspondence.cc`).

A main-view pixel center (u, v) at z-depth w maps through the view-pair
warp (M, t) to ``h = w * M @ (u, v, 1) + t``; the neighbor pixel is
(h0/h2, h1/h2) and the neighbor z-depth h2.
"""

from __future__ import annotations

import torch


def _forms(M, u, v):
    p = M[..., 0, 0] * u + M[..., 0, 1] * v + M[..., 0, 2]
    q = M[..., 1, 0] * u + M[..., 1, 1] * v + M[..., 1, 2]
    r = M[..., 2, 0] * u + M[..., 2, 1] * v + M[..., 2, 2]
    return p, q, r


def warp(M: torch.Tensor, t: torch.Tensor, u, v, w):
    """Project (u, v, w) into the neighbor view -> (proj (..., 2), depth)."""
    p, q, r = _forms(M, u, v)
    a = w * p + t[..., 0]
    b = w * q + t[..., 1]
    d = w * r + t[..., 2]
    return torch.stack([a / d, b / d], dim=-1), d


def warp_jacobian(M: torch.Tensor, t: torch.Tensor, u, v, w, w_dx, w_dy):
    """2x2 Jacobian d(neighbor pixel)/d(main pixel) along the surface,
    (..., 2, 2) as [[du'/du, du'/dv], [dv'/du, dv'/dv]]
    (reference `lib/correspondence.cc:89-100`)."""
    p, q, r = _forms(M, u, v)
    a = w * p + t[..., 0]
    b = w * q + t[..., 1]
    d = w * r + t[..., 2]
    d2 = d * d

    da_du = w_dx * p + w * M[..., 0, 0]
    da_dv = w_dy * p + w * M[..., 0, 1]
    db_du = w_dx * q + w * M[..., 1, 0]
    db_dv = w_dy * q + w * M[..., 1, 1]
    dd_du = w_dx * r + w * M[..., 2, 0]
    dd_dv = w_dy * r + w * M[..., 2, 1]

    j00 = da_du / d - a * dd_du / d2
    j01 = da_dv / d - a * dd_dv / d2
    j10 = db_du / d - b * dd_du / d2
    j11 = db_dv / d - b * dd_dv / d2
    return torch.stack(
        [torch.stack([j00, j01], dim=-1), torch.stack([j10, j11], dim=-1)],
        dim=-2)


def warp_depth_gradient(M: torch.Tensor, t: torch.Tensor, u, v, w):
    """d(neighbor pixel)/d(depth) -> (..., 2)
    (reference `Correspondence::get_derivative`, :53-72)."""
    p, q, r = _forms(M, u, v)
    a = w * p + t[..., 0]
    b = w * q + t[..., 1]
    d = w * r + t[..., 2]
    d2 = d * d
    return torch.stack([(p * d - r * a) / d2, (q * d - r * b) / d2], dim=-1)


def jacobian_condition(jac: torch.Tensor) -> torch.Tensor:
    """sigma_max^2 / sigma_min^2 of a 2x2 warp Jacobian (closed form;
    reference `lib/depth_optimizer.cc:560-574`)."""
    j00 = jac[..., 0, 0]
    j01 = jac[..., 0, 1]
    j10 = jac[..., 1, 0]
    j11 = jac[..., 1, 1]
    m = torch.sqrt((j00 - j11) ** 2 + (j01 + j10) ** 2)
    p = torch.sqrt((j00 + j11) ** 2 + (j01 - j10) ** 2)
    s0 = (m + p) / 2.0
    s1 = torch.abs(s0 - m)
    hi = torch.maximum(s0, s1) ** 2
    lo = torch.minimum(s0, s1) ** 2
    return hi / lo
