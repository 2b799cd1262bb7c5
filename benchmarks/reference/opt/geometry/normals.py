"""Differential geometry of the depth surface in camera coordinates
(port of `smvs_tpu/geometry/normals.py`, reference `lib/surface_derivative.cc`).

Pixel coordinates are centered at the principal point and depth
derivatives are per pixel (`lib/gauss_newton_step.cc:210-239`).
"""

from __future__ import annotations

import torch


def normal(x, y, inv_flen, w, dx, dy):
    """Unit surface normal (..., 3); reference `lib/surface_derivative.cc:17-28`."""
    nx = dx
    ny = -dy
    nz = (x * dx + y * dy + w) * inv_flen
    n = torch.stack([nx, ny, nz], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def normal_divergence(x, y, flen, w, dx, dy, dxy, dxx, dyy):
    """Spatial derivatives of the unit normal (d n/dx, d n/dy) as (..., 6),
    with the sign conventions of reference `lib/surface_derivative.cc:69-107`."""
    a = w + x * dx + y * dy
    ax = 2.0 * dx + x * dxx + y * dxy
    ay = 2.0 * dy + y * dyy + x * dxy

    t = (a / flen) ** 2 + dx * dx + dy * dy
    n = torch.sqrt(t)

    f2 = 1.0 / (flen * flen)
    nx = (dx * dxx + dy * dxy + f2 * a * ax) / n
    ny = (dx * dxy + dy * dyy + f2 * a * ay) / n

    xx = (dxx * n - dx * nx) / t
    yy = (dyy * n - dy * ny) / t
    xy = (dxy * n - dx * ny) / t
    yx = (dxy * n - dy * nx) / t
    zx = (ax * n - a * nx) / (t * flen)
    zy = (ay * n - a * ny) / (t * flen)
    return torch.stack([xx, -yx, zx, xy, -yy, zy], dim=-1)


def mean_curvature(dx, dy, dxy, dxx, dyy):
    """Mean curvature of the graph surface; reference
    `lib/surface_derivative.cc:193-203`."""
    dx2 = dx * dx
    dy2 = dy * dy
    c = (1.0 + dx2) * dyy - 2.0 * dx * dy * dxy + (1.0 + dy2) * dxx
    denom = 1.0 + dx2 + dy2
    return c / torch.sqrt(denom * denom * denom)
