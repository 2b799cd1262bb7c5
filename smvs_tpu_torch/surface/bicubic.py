"""Hermite bicubic interpolation over a unit cell (port of
`smvs_tpu/surface/bicubic.py`, reference `lib/bicubic_patch.cc`).

A cell is defined by 4 corner nodes carrying (f, dx, dy, dxy). The
interpolant and its derivatives are linear in the 16 node parameters, so
``basis(x, y)`` gives rows with ``value = basis @ params16``. Parameters
are node-major: ``params16[4*n + v]``, n in (00, 10, 01, 11) with 10 = +x,
v in (f, dx, dy, dxy).
"""

from __future__ import annotations

import numpy as np
import torch

# Hermite coefficient matrix, value-major parameters -> power-basis
# coefficients a[j*4+i] of x^i y^j (reference `lib/bicubic_patch.cc:20-38`).
_HERMITE_VALUE_MAJOR = np.array(
    [
        [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [-3, 3, 0, 0, -2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [2, -2, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, -3, 3, 0, 0, -2, -1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 2, -2, 0, 0, 1, 1, 0, 0],
        [-3, 0, 3, 0, 0, 0, 0, 0, -2, 0, -1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, -3, 0, 3, 0, 0, 0, 0, 0, -2, 0, -1, 0],
        [9, -9, -9, 9, 6, 3, -6, -3, 6, -6, 3, -3, 4, 2, 2, 1],
        [-6, 6, 6, -6, -3, -3, 3, 3, -4, 4, -2, 2, -2, -2, -1, -1],
        [2, 0, -2, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 2, 0, -2, 0, 0, 0, 0, 0, 1, 0, 1, 0],
        [-6, 6, 6, -6, -4, -2, 4, 2, -3, 3, -3, 3, -2, -1, -2, -1],
        [4, -4, -4, 4, 2, 2, -2, -2, 2, -2, 2, -2, 1, 1, 1, 1],
    ],
    dtype=np.float64,
)

# Columns value-major -> node-major (ref index 4*v + n, ours 4*n + v).
_PERM = np.array([4 * v + n for n in range(4) for v in range(4)])

# A3[i, j, m]: coefficient of x^i y^j contributed by node-major param m.
_A3 = _HERMITE_VALUE_MAJOR[:, _PERM].reshape(4, 4, 16).transpose(1, 0, 2)


def _powers(x: torch.Tensor):
    """(x^i, d/dx x^i, d2/dx2 x^i) for i in 0..3 on a new last axis."""
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    p = torch.stack([one, x, x * x, x * x * x], dim=-1)
    dp = torch.stack([zero, one, 2.0 * x, 3.0 * x * x], dim=-1)
    ddp = torch.stack([zero, zero, 2.0 * one, 6.0 * x], dim=-1)
    return p, dp, ddp


def basis_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All six basis rows at unit-cell coords: [..., 6, 16] for
    (f, dx, dy, dxy, dxx, dyy), broadcasting over the shape of x/y."""
    a3 = torch.as_tensor(_A3, dtype=x.dtype, device=x.device)
    px, dpx, ddpx = _powers(x)
    py, dpy, ddpy = _powers(y)

    def row(a, b):
        return torch.einsum("...i,...j,ijm->...m", a, b, a3)

    return torch.stack([row(px, py), row(dpx, py), row(px, dpy),
                        row(dpx, dpy), row(ddpx, py), row(px, ddpy)], dim=-2)


def pixel_basis(patchsize: int, subsample: int = 1, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Basis rows for every pixel center of a patch, in pixel units.

    Pixel (i, j) of a size-S patch evaluates at ((i+.5)/S, (j+.5)/S);
    first derivatives are scaled by 1/S, second ones by 1/S^2. Returns
    [P, 6, 16], P = (S/subsample)^2 in row-major (j, i) order.
    """
    s = patchsize
    idx = np.arange(0, s, subsample)
    ii, jj = np.meshgrid(idx, idx, indexing="xy")
    x = (ii.reshape(-1) + 0.5) / s
    y = (jj.reshape(-1) + 0.5) / s
    rows = basis_rows(torch.as_tensor(x, dtype=dtype, device=device),
                      torch.as_tensor(y, dtype=dtype, device=device))
    scale = torch.as_tensor(
        [1.0, 1.0 / s, 1.0 / s, 1.0 / s**2, 1.0 / s**2, 1.0 / s**2],
        dtype=dtype, device=device)
    return rows * scale[None, :, None]


def evaluate(params16: torch.Tensor, x, y) -> torch.Tensor:
    """(f, dx, dy, dxy, dxx, dyy) at unit-cell coords: params16 (..., 16)
    node-major, x/y broadcastable to its leading shape; returns (..., 6)."""
    rows = basis_rows(torch.as_tensor(x, dtype=params16.dtype,
                                      device=params16.device),
                      torch.as_tensor(y, dtype=params16.dtype,
                                      device=params16.device))
    return torch.einsum("...km,...m->...k", rows, params16)


def fit_to_data(x: torch.Tensor, y: torch.Tensor, data: torch.Tensor
                ) -> torch.Tensor:
    """Least-squares power-basis coefficients alpha[j*4+i] of x^i y^j
    fitted to samples (reference `lib/bicubic_patch.cc:341-383`): the
    minimum-norm solution through the SVD, singular values below
    eps * max(n, 16) of the largest cut, as `jnp.linalg.lstsq` solves it
    on every device."""
    px, _, _ = _powers(x)
    py, _, _ = _powers(y)
    A = torch.einsum("ni,nj->nji", px, py).reshape(x.shape[0], 16)
    rtol = torch.finfo(A.dtype).eps * max(A.shape)
    return torch.linalg.pinv(A, rtol=rtol) @ data


def evaluate_power(alpha: torch.Tensor, x, y) -> torch.Tensor:
    """A power-basis patch (from `fit_to_data`) at (x, y)."""
    px, _, _ = _powers(torch.as_tensor(x, dtype=alpha.dtype,
                                       device=alpha.device))
    py, _, _ = _powers(torch.as_tensor(y, dtype=alpha.dtype,
                                       device=alpha.device))
    return torch.einsum("...i,...j,ji->...", px, py, alpha.reshape(4, 4))
