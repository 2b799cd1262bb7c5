"""Geometric multigrid preconditioner for the stencil normal equations
(port of `smvs_tpu/solver/mg.py`).

A symmetric V(1,1) cycle whose coarse spaces are nested in the surface's
own function space: Hermite-subdivision prolongation, Galerkin coarse
operators ``A_c = P^T A P`` in closed form on the 9-point block stencil,
and damped block-Jacobi smoothing: per-node relative row damping for base
systems, a constant OMEGA for shading systems (`build`'s ``damp_rows``;
the JAX package's ``SMVS_MG_OMEGA=const`` override has no counterpart
here). A per-apply guard falls back to damped block-Jacobi when the
V-cycle is indefinite for a system.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from smvs_tpu_torch.solver import stencil
from smvs_tpu_torch.utils.perview import per_view

OMEGA = 0.8  # smoother damping ceiling
COARSE_SWEEPS = 8  # damped-Jacobi sweeps on the coarsest grid
_ROW_STIFF_FACTOR = 2.0  # rows past this multiple of the median get damped


def coarse_size(n: int) -> int:
    """Nodes of the next-coarser grid: keep every even-index node."""
    return (n + 1) // 2


@functools.lru_cache(maxsize=None)
def _weights_1d():
    """1D Hermite subdivision weights W(u) mapping a coarse (f, d) pair to
    the fine (f, d) pair at fine node 2I + u (see the JAX module)."""
    w0 = np.array([[1.0, 0.0], [0.0, 0.5]])
    wp = np.array([[0.5, 0.125], [-0.75, -0.125]])  # left coarse neighbor
    wm = np.array([[0.5, -0.125], [0.75, -0.125]])  # right coarse neighbor
    return {0: w0, 1: wp, -1: wm}


@functools.lru_cache(maxsize=None)
def _weights_4_np():
    """4x4 channel weights on (f, dx, dy, dxy): x-transfer I_2 (x) w,
    y-transfer w (x) I_2."""
    w = _weights_1d()
    eye = np.eye(2)
    wx = {u: np.kron(eye, w[u]) for u in (-1, 0, 1)}
    wy = {u: np.kron(w[u], eye) for u in (-1, 0, 1)}
    return wx, wy


def _weights_4(dtype, device):
    wx, wy = _weights_4_np()

    def cvt(d):
        return {u: torch.as_tensor(m, dtype=dtype, device=device)
                for u, m in d.items()}

    return cvt(wx), cvt(wy)


def _axis_up(x: torch.Tensor, W: dict, axis: int, n_out: int
             ) -> torch.Tensor:
    """1D prolongation along `axis` of x [4, ...]: coarse n -> fine n_out."""
    x = torch.movedim(x, axis, -1)
    xp = torch.nn.functional.pad(x, (0, 1))
    even = torch.einsum("ab,b...->a...", W[0], xp[..., :-1])
    odd = (torch.einsum("ab,b...->a...", W[1], xp[..., :-1])
           + torch.einsum("ab,b...->a...", W[-1], xp[..., 1:]))
    inter = torch.stack([even, odd], dim=-1).reshape(*x.shape[:-1], -1)
    return torch.movedim(inter[..., :n_out], -1, axis)


def _axis_down(x: torch.Tensor, W: dict, axis: int) -> torch.Tensor:
    """Adjoint of :func:`_axis_up` (transposed weights, gathered taps)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    nc = coarse_size(n)
    xp = torch.nn.functional.pad(x, (1, 2 * nc - n))
    out = (torch.einsum("ba,b...->a...", W[0], xp[..., 1::2][..., :nc])
           + torch.einsum("ba,b...->a...", W[1], xp[..., 2::2][..., :nc])
           + torch.einsum("ba,b...->a...", W[-1], xp[..., 0::2][..., :nc]))
    return torch.movedim(out, -1, axis)


def prolong(xc: torch.Tensor, ny1: int, nx1: int) -> torch.Tensor:
    """Hermite subdivision [4, ncy, ncx] -> [4, ny1, nx1]."""
    wx, wy = _weights_4(xc.dtype, xc.device)
    return _axis_up(_axis_up(xc, wx, -1, nx1), wy, -2, ny1)


def restrict(xf: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`prolong`: [4, ny1, nx1] -> [4, ncy, ncx]."""
    wx, wy = _weights_4(xf.dtype, xf.device)
    return _axis_down(_axis_down(xf, wx, -1), wy, -2)


def restrict_mask(active: torch.Tensor) -> torch.Tensor:
    """Coarse activity: any fine node in the transfer support is active."""
    a = active.to(torch.float32)
    ny1, nx1 = a.shape[-2:]
    ncy, ncx = coarse_size(ny1), coarse_size(nx1)
    ap = torch.nn.functional.pad(a, (1, 2 * ncx - nx1, 1, 2 * ncy - ny1))

    def taps(x, axis):
        x = torch.movedim(x, axis, -1)
        nc = (x.shape[-1] - 1) // 2
        out = (x[..., 1::2][..., :nc] + x[..., 2::2][..., :nc]
               + x[..., 0::2][..., :nc])
        return torch.movedim(out, -1, axis)

    return taps(taps(ap, -1), -2) > 0


@functools.lru_cache(maxsize=None)
def _galerkin_weight_np() -> np.ndarray:
    """Combined Galerkin weight tensor G [9*16, 9*9*16] (float64):
    G[(DY,DX,e,f), ((u,v),(dy,dx),a,b)] = W2(u,v)[a,e] W2(u+dy-2DY,
    v+dx-2DX)[b,f], zero when the second offset leaves {-1, 0, 1}."""
    wx, wy = _weights_4_np()

    def w2(u, v):
        return wy[u] @ wx[v]

    offs = (-1, 0, 1)
    G = np.zeros((9, 4, 4, 9, 9, 4, 4), np.float64)
    for qi, (DY, DX) in enumerate([(a, b) for a in offs for b in offs]):
        for ti, (u, v) in enumerate([(a, b) for a in offs for b in offs]):
            left = w2(u, v)
            for pi, (dy, dx) in enumerate(
                    [(a, b) for a in offs for b in offs]):
                ru, rv = u + dy - 2 * DY, v + dx - 2 * DX
                if abs(ru) > 1 or abs(rv) > 1:
                    continue
                right = w2(ru, rv)
                G[qi, :, :, ti, pi] = np.einsum("ae,bf->efab", left, right)
    return G.reshape(9 * 16, 9 * 9 * 16)


def galerkin_coarse(Hb: torch.Tensor) -> torch.Tensor:
    """Coarse stencil A_c = P^T A P in closed form, as one matmul of the
    constant weight tensor against the 9 strided windows of the fine
    stencil planes. Hb: [3, 3, 4, 4, (V,) ny1, nx1] ->
    [3, 3, 4, 4, (V,) ncy, ncx]."""
    ny1, nx1 = Hb.shape[-2:]
    lead = tuple(Hb.shape[4:-2])
    ncy, ncx = coarse_size(ny1), coarse_size(nx1)
    Hp = torch.nn.functional.pad(Hb, (1, 2 * ncx - nx1, 1, 2 * ncy - ny1))
    Hp = Hp.reshape(9, 16, *Hp.shape[4:])
    win = torch.stack(
        [Hp[..., 1 + u::2, 1 + v::2][..., :ncy, :ncx]
         for u in (-1, 0, 1) for v in (-1, 0, 1)], dim=0)
    G = torch.as_tensor(_galerkin_weight_np(), dtype=Hb.dtype,
                        device=Hb.device)
    if not lead:
        out = G @ win.reshape(9 * 9 * 16, ncy * ncx)
    else:  # one product per view, as the view alone takes it
        out = per_view(lambda w: G @ w.reshape(9 * 9 * 16, ncy * ncx),
                       win, dim=3).movedim(0, 1)
    return out.reshape(3, 3, 4, 4, *lead, ncy, ncx)


class Levels(NamedTuple):
    """Galerkin operators + inverted block diagonals, finest first."""

    ops: tuple  # stencil tensors [3, 3, 4, 4, (V,) ny1_l, nx1_l]
    pinvs: tuple  # block-Jacobi inverses [4, 4, (V,) ny1_l, nx1_l]
    shapes: tuple  # (ny1, nx1) per level
    omegas: tuple  # per-node damping maps [(V,) ny1_l, nx1_l]
    active: torch.Tensor | None = None  # fine-level active mask


def num_levels(ny1: int, nx1: int, min_size: int = 8) -> int:
    n = 1
    while min(coarse_size(ny1), coarse_size(nx1)) >= min_size:
        ny1, nx1 = coarse_size(ny1), coarse_size(nx1)
        n += 1
    return n


def build(Hb: torch.Tensor, active: torch.Tensor, min_size: int = 8,
          damp_rows: bool = True) -> Levels:
    """The V-cycle hierarchy for one assembled system, or for a batch of
    views' systems (Hb [3, 3, 4, 4, V, ny1, nx1], active [V, ny1, nx1]),
    each level and damping map computed per view.

    ``damp_rows`` selects the smoother damping per problem, as the JAX
    package measured it: True (base photometric systems) damps each row
    by its Gershgorin excess over the median row (`_node_omega`), whose
    coarse levels otherwise grow outlier rows that make the V-cycle
    indefinite; False (shading systems) keeps a constant OMEGA on every
    level, because their stiff rows are the shading term's only strong
    constraint on weakly textured nodes.
    """

    def omega(H, pinv):
        if damp_rows:
            return _node_omega(H, pinv)
        return torch.full(H.shape[4:], OMEGA, dtype=H.dtype,
                          device=H.device)

    ny1, nx1 = Hb.shape[-2:]
    pinv0 = stencil.block_jacobi_inverse(Hb, active)
    ops = [Hb]
    pinvs = [pinv0]
    shapes = [(ny1, nx1)]
    omegas = [omega(Hb, pinv0)]
    act = active
    for _ in range(num_levels(ny1, nx1, min_size) - 1):
        Hb = galerkin_coarse(Hb)
        act = restrict_mask(act)
        pinv = stencil.block_jacobi_inverse(Hb, act)
        ops.append(Hb)
        pinvs.append(pinv)
        shapes.append(tuple(Hb.shape[-2:]))
        omegas.append(omega(Hb, pinv))
    return Levels(ops=tuple(ops), pinvs=tuple(pinvs), shapes=tuple(shapes),
                  omegas=tuple(omegas), active=active)


def _median_of_positive(lam: torch.Tensor, batch_dims: int = 0
                        ) -> torch.Tensor:
    """Median over the positive entries (numpy's midpoint rule for an even
    count), 1.0 when there are none; no host sync. With ``batch_dims``
    leading axes, one median per batch entry (``lam.shape[:batch_dims]``),
    each the one the entry alone gives: a sort and a gather per row."""
    lead = lam.shape[:batch_dims]
    rows = lam.reshape(int(np.prod(lead)), -1)
    n = (rows > 0).sum(-1, keepdim=True)
    s = torch.sort(torch.where(rows > 0, rows, torch.inf), dim=-1).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=rows.shape[-1] - 1)
    med = 0.5 * (torch.gather(s, -1, lo) + torch.gather(s, -1, hi))
    return torch.where(n > 0, med, torch.ones_like(med)).reshape(lead)


def _row_sums(Hb: torch.Tensor, pinv: torch.Tensor) -> torch.Tensor:
    """Gershgorin block-row sums lam_i = sum_j ||pinv_i A_ij||_F of one
    system [ny1, nx1]."""
    prod = sum(
        pinv[None, None, :, b, None, :, :] * Hb[:, :, None, b, :, :, :]
        for b in range(4))
    return torch.sqrt(torch.sum(prod * prod, dim=(2, 3))).sum((0, 1))


def _node_omega(Hb: torch.Tensor, pinv: torch.Tensor) -> torch.Tensor:
    """Per-node smoother damping map [(V,) ny1, nx1]: rows are damped by
    their excess over the typical row (of their own view),
    w_i = OMEGA * min(1, F * median(lam) / lam_i) with the Gershgorin
    block-row sum lam_i = sum_j ||pinv_i A_ij||_F."""
    if Hb.ndim == 6:
        lam = _row_sums(Hb, pinv)
    else:  # view by view (`utils.perview`), each summed as it is alone
        lam = per_view(_row_sums, Hb, pinv, dim=(4, 2))
    med = _median_of_positive(lam, lam.ndim - 2)[..., None, None]
    scale = torch.clamp(_ROW_STIFF_FACTOR * med / torch.clamp(lam, min=1e-6),
                        max=1.0)
    return OMEGA * scale.to(Hb.dtype)


def _smooth(levels: Levels, l: int, r: torch.Tensor) -> torch.Tensor:
    return levels.omegas[l][None] * stencil.apply_block_diag(
        levels.pinvs[l], r)


def apply(levels: Levels, r: torch.Tensor) -> torch.Tensor:
    """z = M^-1 r: one symmetric V(1,1) cycle, projected on the active
    set, with the indefiniteness guard: if <r, z> <= 0 the damped
    block-Jacobi result is returned for this apply (for a batch of views,
    r [4, V, ny1, nx1], the guard is taken per view)."""
    z = apply_vcycle(levels, r)
    if levels.active is not None:
        r = torch.where(levels.active[None], r, 0.0)
    rz = r * z
    if r.ndim > 3:  # per view, as each view alone sums it
        rz = per_view(torch.sum, rz, dim=1).reshape(1, -1, 1, 1)
    else:
        rz = torch.sum(rz)
    return torch.where(rz > 0, z, jacobi(levels, r))


def apply_vcycle(levels: Levels, r: torch.Tensor) -> torch.Tensor:
    """One symmetric V(1,1) cycle, active-projected, without the guard."""

    def cycle(l: int, rl: torch.Tensor) -> torch.Tensor:
        A = levels.ops[l]
        if l == len(levels.ops) - 1:
            z = _smooth(levels, l, rl)
            for _ in range(COARSE_SWEEPS - 1):
                z = z + _smooth(levels, l, rl - stencil.spmv(A, z))
            return z
        z = _smooth(levels, l, rl)
        coarse_r = restrict(rl - stencil.spmv(A, z))
        zc = cycle(l + 1, coarse_r)
        z = z + prolong(zc, levels.shapes[l][0], levels.shapes[l][1])
        return z + _smooth(levels, l, rl - stencil.spmv(A, z))

    if levels.active is not None:
        r = torch.where(levels.active[None], r, 0.0)
    z = cycle(0, r)
    if levels.active is not None:
        z = torch.where(levels.active[None], z, 0.0)
    return z


def jacobi(levels: Levels, r: torch.Tensor) -> torch.Tensor:
    """Damped block-Jacobi on the fine level (always PD on the active set)."""
    zj = _smooth(levels, 0, r)
    if levels.active is not None:
        zj = torch.where(levels.active[None], zj, 0.0)
    return zj
