"""9-point-stencil block linear algebra on the node grid (port of
`smvs_tpu/solver/stencil.py`).

Hessian blocks only couple nodes that share a patch (reference
`lib/gauss_newton_step.cc:98-122`), so the system is a stencil tensor:
SpMV is 9 shifted batched 4x4 contractions and block-Jacobi a batched 4x4
inverse. Layout is channel-major: vectors [4, ny1, nx1], the stencil
[3, 3, 4, 4, ny1, nx1], the preconditioner [4, 4, ny1, nx1]. A batch of
views sits between the channel axes and the grid (vectors [4, V, ny1,
nx1], the stencil [3, 3, 4, 4, V, ny1, nx1], masks [V, ny1, nx1]); every
function here takes either form.
"""

from __future__ import annotations

import torch

_CORNERS = [(0, 0), (1, 0), (0, 1), (1, 1)]  # (ax, ay), node-major order


def _pad_yx(x: torch.Tensor, top: int, bottom: int, left: int, right: int
            ) -> torch.Tensor:
    """Zero pad of the two trailing (y, x) dims."""
    return torch.nn.functional.pad(x, (left, right, top, bottom))


def scatter_patch_systems(
    g_patch: torch.Tensor,  # [16, (V,) ny, nx] corner-major gradient planes
    H_patch: torch.Tensor,  # [16, 16, (V,) ny, nx] per-patch Hessian planes
    active: torch.Tensor,  # [(V,) ny+1, nx+1] bool
    patch_valid: torch.Tensor,  # [(V,) ny, nx] bool
):
    """Accumulate per-patch systems into the node grid.

    Corner a of patch (i, j) is node (i + ax, j + ay). Inactive nodes get
    zero gradient rows and zero Hessian rows/columns (reference
    `lib/gauss_newton_step.cc:88-121`). Returns (g [4, ny1, nx1],
    Hb [3, 3, 4, 4, ny1, nx1]) where Hb[1+dy, 1+dx] couples node (i, j)
    to node (i+dy, j+dx).
    """
    ny, nx = g_patch.shape[-2:]
    ny1, nx1 = ny + 1, nx + 1
    lead = tuple(g_patch.shape[1:-2])  # (V,) for a batch of views
    dtype = g_patch.dtype

    act = active.to(dtype)
    ap = _pad_yx(act, 1, 1, 1, 1)
    pv = patch_valid.to(dtype)

    g = torch.zeros((4, *lead, ny1, nx1), dtype=dtype,
                    device=g_patch.device)
    for a, (ax, ay) in enumerate(_CORNERS):
        contrib = g_patch[4 * a : 4 * a + 4] * pv
        g = g + _pad_yx(contrib, ay, 1 - ay, ax, 1 - ax)
    g = g * act

    planes = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = torch.zeros((4, 4, *lead, ny1, nx1), dtype=dtype,
                              device=g_patch.device)
            for a, (ax, ay) in enumerate(_CORNERS):
                bx, by = ax + dx, ay + dy
                if (bx, by) not in _CORNERS:
                    continue
                b = _CORNERS.index((bx, by))
                blk = H_patch[4 * a : 4 * a + 4, 4 * b : 4 * b + 4] * pv
                acc = acc + _pad_yx(blk, ay, 1 - ay, ax, 1 - ax)
            nb_act = ap[..., 1 + dy : 1 + dy + ny1, 1 + dx : 1 + dx + nx1]
            planes.append(acc * (act * nb_act))
    Hb = torch.stack(planes, dim=0).reshape(3, 3, 4, 4, *lead, ny1, nx1)
    return g, Hb


def spmv(Hb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = H @ x with H in stencil form; x, y: [4, ny1, nx1]
    (reference `BlockSparseMatrix::multiply`, :276-298)."""
    return spmv_padded(Hb, _pad_yx(x, 1, 1, 1, 1))


def spmv_padded(Hb: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """`spmv` on x given with one row and one column more on each side
    [4, ny1 + 2, nx1 + 2]: zeros at the grid's edges, or, for a band of
    the grid's rows, the neighbor bands' edge rows (`dist.rows`)."""
    ny1, nx1 = xp.shape[-2] - 2, xp.shape[-1] - 2
    y = torch.zeros((*xp.shape[:-2], ny1, nx1), dtype=xp.dtype,
                    device=xp.device)
    for oy in range(3):
        for ox in range(3):
            xs = xp[..., oy : oy + ny1, ox : ox + nx1]
            y = y + (Hb[oy, ox] * xs[None]).sum(1)
    return y


def block_jacobi_inverse(Hb: torch.Tensor, active: torch.Tensor
                         ) -> torch.Tensor:
    """Inverted diagonal 4x4 blocks [4, 4, ny1, nx1]; zero where inactive
    or singular (reference `lib/block_sparse_matrix.h:300-316`)."""
    diag = torch.movedim(Hb[1, 1], (0, 1), (-2, -1))  # [ny1, nx1, 4, 4]
    eye = torch.eye(4, dtype=Hb.dtype, device=Hb.device)
    ok = active & (torch.abs(diag).sum((-1, -2)) > 0)
    safe = torch.where(ok[..., None, None], diag, eye)
    inv, info = torch.linalg.inv_ex(safe)
    finite = torch.isfinite(inv).all(dim=-1).all(dim=-1) & ok & (info == 0)
    inv = torch.where(finite[..., None, None], inv, 0.0)
    return torch.movedim(inv, (-2, -1), (0, 1))


def apply_block_diag(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """z = P @ x for a block-diagonal P [4, 4, ny1, nx1]; x [4, ny1, nx1]."""
    return (P * x[None]).sum(1)
