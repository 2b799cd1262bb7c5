"""Global spherical-harmonics lighting and its linear fit (port of
`smvs_tpu/shading/lighting.py`, reference `lib/global_lighting.cc` and
`lib/light_optimizer.cc`).

A 16-coefficient scaled-SH lighting; the fit is a 16x16 normal-equation
solve over every pixel with a valid (unit) normal and enough intensity.
"""

from __future__ import annotations

import torch

from smvs_tpu_torch.shading import sh
from smvs_tpu_torch.utils.timing import host_reads


def pinv(a: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of a matrix with `jnp.linalg.pinv`'s cutoff.

    JAX zeroes singular values at or below ``10 * max(m, n) * eps`` times
    the largest; `torch.linalg.pinv` defaults to ``max(m, n) * eps``, ten
    times lower, which inverts a near-singular normal matrix (few valid
    normals, or all of them in one plane) into other lighting. The same
    SVD, cutoff and product as JAX's.
    """
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cutoff = 10.0 * max(m, n) * torch.finfo(a.dtype).eps * s[..., :1]
    s = torch.where(s > cutoff, s, torch.inf)
    return vh.mT @ (u.mT / s[..., :, None])


def fit_lighting(normal_map: torch.Tensor, image: torch.Tensor
                 ) -> torch.Tensor:
    """Fit 16 SH coefficients (reference `lib/light_optimizer.cc:22-55`).

    normal_map: [H, W, 3] (zero or NaN where invalid); image: [H, W] shading
    image. Pixels with non-unit normals or intensity < 0.05 are excluded.
    The normal equations are summed in the inputs' dtype (float32 on the
    card, where the caller keeps TF32 off: `device.set_cuda_precision`).
    On the card `torch.linalg.svd` checks its convergence on the host, so
    each fit waits for the device: a read-back, counted in
    ``host_reads["lighting"]``, one a view. With a leading view axis
    (normal_map [V, H, W, 3], image [V, H, W]), one fit per view [V, 16],
    each view fitted alone: a batched SVD may take another algorithm than
    a single one, and round otherwise.
    """
    if normal_map.ndim == 4:
        return torch.stack([fit_lighting(n, i)
                            for n, i in zip(normal_map, image)])
    finite = torch.isfinite(normal_map).all(dim=-1)
    nm = torch.where(finite[..., None], normal_map, 0.0)
    norm = torch.sqrt((nm * nm).sum(-1))
    valid = finite & (torch.abs(norm - 1.0) <= 1e-4) & (image >= 0.05)
    basis = sh.eval_4_band(nm)  # [H, W, 16]
    # torch.where (not a mask multiply): excluded pixels may hold NaN
    # normals (unrasterized patches), and 0 * NaN would poison the sums.
    basis = torch.where(valid[..., None], basis, 0.0).reshape(-1, 16)
    b = basis.T @ torch.where(valid, image, 0.0).reshape(-1)
    A = basis.T @ basis
    if A.is_cuda:
        host_reads["lighting"] += 1
    return pinv(A) @ b


def value_for_normal(params: torch.Tensor, normals: torch.Tensor
                     ) -> torch.Tensor:
    """Rendered shading for normals (..., 3)
    (reference `lib/global_lighting.cc:15-21`)."""
    return sh.eval_4_band(normals) @ params


def render_normal_map(params: torch.Tensor, normal_map: torch.Tensor
                      ) -> torch.Tensor:
    """Shade a normal map; invalid (non-unit) normals render 0
    (reference `lib/global_lighting.cc:23-46`)."""
    norm = torch.sqrt((normal_map * normal_map).sum(-1))
    shaded = value_for_normal(params, normal_map)
    return torch.where(torch.abs(norm - 1.0) <= 1e-4, shaded, 0.0)
