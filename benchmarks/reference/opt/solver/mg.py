"""Geometric multigrid preconditioner for the stencil normal equations
(port of `smvs_tpu/solver/mg.py`).

A symmetric V(1,1) cycle whose coarse spaces are nested in the surface's
own function space: Hermite-subdivision prolongation, Galerkin coarse
operators ``A_c = P^T A P`` in closed form on the 9-point block stencil,
and damped block-Jacobi smoothing: per-node relative row damping for base
systems, a constant OMEGA for shading systems (`build`'s ``damp_rows``;
``SMVS_MG_OMEGA=const`` in the environment, read at import as in the JAX
package, keeps the constant OMEGA for every system). A per-apply guard
falls back to damped block-Jacobi when the V-cycle is indefinite for a
system.

The hierarchy also runs on a grid split by rows over the ranks of a
``patch`` group (`build`'s ``split``, a `dist.rows.RowSplit`): each rank
holds a band of every level's rows, derived from the finer level's band
(coarse node I is fine node 2I), and the transfers, the Galerkin
products and the smoother's stencil products take one row of halo from
the neighbor bands. The damping map's median gathers the level's row
sums, and the guard's sums are summed over the group. From the first
level on which a rank would hold fewer than `dist.mesh.GATHER_ROWS` (8)
rows, the levels are gathered whole onto every rank and solved there as
on one device.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from benchmarks.reference.opt.solver import stencil
from benchmarks.reference.opt.utils.perview import per_view

OMEGA = 0.8  # smoother damping ceiling
COARSE_SWEEPS = 8  # damped-Jacobi sweeps on the coarsest grid
_ROW_STIFF_FACTOR = 2.0  # rows past this multiple of the median get damped
# "const" turns the relative row damping off (a constant OMEGA on every
# system, the guard carrying stiff ones), as in the JAX package.
_OMEGA_POLICY = os.environ.get("SMVS_MG_OMEGA", "rel")


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


def _taps_up(xp: torch.Tensor, W: dict) -> torch.Tensor:
    """Fine entries 2k and 2k + 1 from coarse entries k and k + 1 of xp
    [4, ..., m + 1] (last axis): [4, ..., 2m]."""
    even = torch.einsum("ab,b...->a...", W[0], xp[..., :-1])
    odd = (torch.einsum("ab,b...->a...", W[1], xp[..., :-1])
           + torch.einsum("ab,b...->a...", W[-1], xp[..., 1:]))
    return torch.stack([even, odd], dim=-1).reshape(*xp.shape[:-1], -1)


def _axis_up(x: torch.Tensor, W: dict, axis: int, n_out: int
             ) -> torch.Tensor:
    """1D prolongation along `axis` of x [4, ...]: coarse n -> fine n_out."""
    x = torch.movedim(x, axis, -1)
    inter = _taps_up(torch.nn.functional.pad(x, (0, 1)), W)
    return torch.movedim(inter[..., :n_out], -1, axis)


def _taps_down(xp: torch.Tensor, W: dict, s: int, nc: int) -> torch.Tensor:
    """Coarse entries i < nc from entries s + 2i, s + 2i + 1 and
    s + 2i + 2 of xp (last axis; fine nodes 2I - 1, 2I, 2I + 1)."""
    xp = xp[..., s:]
    return (torch.einsum("ba,b...->a...", W[0], xp[..., 1::2][..., :nc])
            + torch.einsum("ba,b...->a...", W[1], xp[..., 2::2][..., :nc])
            + torch.einsum("ba,b...->a...", W[-1], xp[..., 0::2][..., :nc]))


def _axis_down(x: torch.Tensor, W: dict, axis: int) -> torch.Tensor:
    """Adjoint of :func:`_axis_up` (transposed weights, gathered taps)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    nc = coarse_size(n)
    xp = torch.nn.functional.pad(x, (1, 2 * nc - n))
    return torch.movedim(_taps_down(xp, W, 0, nc), -1, axis)


def prolong(xc: torch.Tensor, ny1: int, nx1: int) -> torch.Tensor:
    """Hermite subdivision [4, ncy, ncx] -> [4, ny1, nx1]."""
    wx, wy = _weights_4(xc.dtype, xc.device)
    return _axis_up(_axis_up(xc, wx, -1, nx1), wy, -2, ny1)


def restrict(xf: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`prolong`: [4, ny1, nx1] -> [4, ncy, ncx]."""
    wx, wy = _weights_4(xf.dtype, xf.device)
    return _axis_down(_axis_down(xf, wx, -1), wy, -2)


def _taps(x: torch.Tensor, axis: int, s: int, nc: int) -> torch.Tensor:
    """Sum of entries s + 2i, s + 2i + 1, s + 2i + 2 along ``axis``."""
    x = torch.movedim(x, axis, -1)[..., s:]
    out = (x[..., 1::2][..., :nc] + x[..., 2::2][..., :nc]
           + x[..., 0::2][..., :nc])
    return torch.movedim(out, -1, axis)


def restrict_mask(active: torch.Tensor) -> torch.Tensor:
    """Coarse activity: any fine node in the transfer support is active."""
    a = active.to(torch.float32)
    ny1, nx1 = a.shape[-2:]
    ncy, ncx = coarse_size(ny1), coarse_size(nx1)
    ap = torch.nn.functional.pad(a, (1, 2 * ncx - nx1, 1, 2 * ncy - ny1))
    return _taps(_taps(ap, -1, 0, ncx), -2, 0, ncy) > 0


# The same transfers on a band of a level's rows (``split``, a
# `dist.rows.RowSplit`): its rows [r0, r1) with one halo row on each side
# give the coarse rows c = [c0, c1) whose fine rows 2I it holds, and the
# coarse rows [c0 - 1, c1 + 1) give its fine rows; ``s`` = 2 c0 - r0
# aligns the taps.


def _coarse_rows(split) -> tuple:
    c = split.coarse().band
    return c, 2 * c.start - split.band.start


def restrict_band(xf: torch.Tensor, split) -> torch.Tensor:
    """`restrict` on a band: the coarse band's rows [4, (V,), c1 - c0,
    ncx] from the fine band's rows."""
    wx, wy = _weights_4(xf.dtype, xf.device)
    c, s = _coarse_rows(split)
    xh = split.halo(_axis_down(xf, wx, -1))
    return torch.movedim(_taps_down(torch.movedim(xh, -2, -1), wy, s,
                                    len(c)), -1, -2)


def prolong_band(xch: torch.Tensor, band: range, c: range, nx1: int
                 ) -> torch.Tensor:
    """`prolong` on a band: the fine rows ``band`` from the coarse rows
    [c0 - 1, c1 + 1) ``xch`` (zero beyond the grid), ``c`` the coarse
    band of ``band``."""
    wx, wy = _weights_4(xch.dtype, xch.device)
    x = torch.movedim(_axis_up(xch, wx, -1, nx1), -2, -1)
    lo = band.start - 2 * (c.start - 1)  # fine rows from 2 (c0 - 1)
    return torch.movedim(_taps_up(x, wy)[..., lo:lo + len(band)], -1, -2)


def restrict_mask_band(active: torch.Tensor, split) -> torch.Tensor:
    """`restrict_mask` on a band: the coarse band's activity."""
    a = active.to(torch.float32)
    nx1 = a.shape[-1]
    ncx = coarse_size(nx1)
    c, s = _coarse_rows(split)
    ax = _taps(torch.nn.functional.pad(a, (1, 2 * ncx - nx1)), -1, 0, ncx)
    return _taps(split.halo(ax), -2, s, len(c)) > 0


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
    ncy, ncx = coarse_size(ny1), coarse_size(nx1)
    Hp = torch.nn.functional.pad(Hb, (1, 2 * ncx - nx1, 1, 2 * ncy - ny1))
    return _galerkin(Hp, 0, ncy, ncx)


def galerkin_band(Hb: torch.Tensor, split) -> torch.Tensor:
    """`galerkin_coarse` on a band: the coarse band's operator rows."""
    nx1 = Hb.shape[-1]
    ncx = coarse_size(nx1)
    c, s = _coarse_rows(split)
    Hp = torch.nn.functional.pad(split.halo(Hb), (1, 2 * ncx - nx1))
    return _galerkin(Hp, s, len(c), ncx)


def _galerkin(Hp: torch.Tensor, s: int, ncy: int, ncx: int) -> torch.Tensor:
    """The coarse rows i < ncy of A_c from the fine stencil padded by a
    row and a column (Hp: fine rows 2I - 1 .. 2I + 1 of coarse row i at
    s + 2i .. s + 2i + 2)."""
    lead = tuple(Hp.shape[4:-2])
    Hp = Hp[..., s:, :].reshape(9, 16, *Hp.shape[4:-2], -1, Hp.shape[-1])
    win = torch.stack(
        [Hp[..., 1 + u::2, 1 + v::2][..., :ncy, :ncx]
         for u in (-1, 0, 1) for v in (-1, 0, 1)], dim=0)
    G = torch.as_tensor(_galerkin_weight_np(), dtype=Hp.dtype,
                        device=Hp.device)
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
    # Per level its `dist.rows.RowSplit` (the tensors above then hold this
    # rank's band of its rows) or None (the whole level); None for a
    # hierarchy on one device.
    splits: tuple | None = None


def num_levels(ny1: int, nx1: int, min_size: int = 8) -> int:
    n = 1
    while min(coarse_size(ny1), coarse_size(nx1)) >= min_size:
        ny1, nx1 = coarse_size(ny1), coarse_size(nx1)
        n += 1
    return n


def build(Hb: torch.Tensor, active: torch.Tensor, min_size: int = 8,
          damp_rows: bool = True, split=None) -> Levels:
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

    With ``split`` (a `dist.rows.RowSplit` of the grid's rows), Hb and
    active are this rank's band of them, and so is every level of the
    hierarchy until a rank would hold fewer than `dist.mesh.GATHER_ROWS`
    rows of one (`RowSplit.banded`): that level and the coarser ones are
    gathered whole on every rank.
    """

    def omega(H, pinv, sp):
        if damp_rows and _OMEGA_POLICY != "const":
            return _node_omega(H, pinv, None if sp is None else sp.gather)
        return torch.full(H.shape[4:], OMEGA, dtype=H.dtype,
                          device=H.device)

    ny1 = Hb.shape[-2] if split is None else split.n
    nx1 = Hb.shape[-1]
    pinv0 = stencil.block_jacobi_inverse(Hb, active)
    ops = [Hb]
    pinvs = [pinv0]
    shapes = [(ny1, nx1)]
    omegas = [omega(Hb, pinv0, split)]
    splits = [split]
    act = active
    for _ in range(num_levels(ny1, nx1, min_size) - 1):
        sp = splits[-1]
        if sp is None:
            Hb = galerkin_coarse(Hb)
            act = restrict_mask(act)
        else:
            Hb = galerkin_band(Hb, sp)
            act = restrict_mask_band(act, sp)
            sp = sp.coarse()
            if not sp.banded:
                Hb, act, sp = sp.gather(Hb), sp.gather(act), None
        pinv = stencil.block_jacobi_inverse(Hb, act)
        ops.append(Hb)
        pinvs.append(pinv)
        shapes.append((Hb.shape[-2] if sp is None else sp.n, Hb.shape[-1]))
        omegas.append(omega(Hb, pinv, sp))
        splits.append(sp)
    return Levels(ops=tuple(ops), pinvs=tuple(pinvs), shapes=tuple(shapes),
                  omegas=tuple(omegas), active=active,
                  splits=None if split is None else tuple(splits))


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


def _node_omega(Hb: torch.Tensor, pinv: torch.Tensor, gather=None
                ) -> torch.Tensor:
    """Per-node smoother damping map [(V,) ny1, nx1]: rows are damped by
    their excess over the typical row (of their own view),
    w_i = OMEGA * min(1, F * median(lam) / lam_i) with the Gershgorin
    block-row sum lam_i = sum_j ||pinv_i A_ij||_F. On a band of the rows,
    ``gather`` puts the level's row sums together for the median."""
    if Hb.ndim == 6:
        lam = _row_sums(Hb, pinv)
    else:  # view by view (`utils.perview`), each summed as it is alone
        lam = per_view(_row_sums, Hb, pinv, dim=(4, 2))
    whole = lam if gather is None else gather(lam)
    med = _median_of_positive(whole, lam.ndim - 2)[..., None, None]
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
    r [4, V, ny1, nx1], the guard is taken per view; on bands of the rows
    its sums are summed over the group)."""
    z = apply_vcycle(levels, r)
    if levels.active is not None:
        r = torch.where(levels.active[None], r, 0.0)
    rz = r * z
    if r.ndim > 3:  # per view, as each view alone sums it
        rz = per_view(torch.sum, rz, dim=1)
    else:
        rz = torch.sum(rz)
    if levels.splits is not None:
        rz = levels.splits[0].sum(rz)
    if r.ndim > 3:
        rz = rz.reshape(1, -1, 1, 1)
    return torch.where(rz > 0, z, jacobi(levels, r))


def apply_vcycle(levels: Levels, r: torch.Tensor) -> torch.Tensor:
    """One symmetric V(1,1) cycle, active-projected, without the guard."""
    splits = levels.splits or (None,) * len(levels.ops)

    def spmv(l: int, x: torch.Tensor) -> torch.Tensor:
        sp = splits[l]
        if sp is None:
            return stencil.spmv(levels.ops[l], x)
        return sp.spmv(levels.ops[l], x)

    def down(l: int, x: torch.Tensor) -> torch.Tensor:
        """Level l's residual -> level l + 1's."""
        sp = splits[l]
        if sp is None:
            return restrict(x)
        xc = restrict_band(x, sp)
        return xc if splits[l + 1] is not None else sp.coarse().gather(xc)

    def up(l: int, zc: torch.Tensor) -> torch.Tensor:
        """Level l + 1's correction -> level l's."""
        sp = splits[l]
        if sp is None:
            return prolong(zc, levels.shapes[l][0], levels.shapes[l][1])
        c = sp.coarse().band
        if splits[l + 1] is not None:
            zh = splits[l + 1].halo(zc)
        else:  # the whole coarse level: its rows [c0 - 1, c1 + 1)
            zh = stencil._pad_yx(zc, 1, 1, 0, 0)[..., c.start:c.stop + 2, :]
        return prolong_band(zh, sp.band, c, levels.shapes[l][1])

    def cycle(l: int, rl: torch.Tensor) -> torch.Tensor:
        if l == len(levels.ops) - 1:
            z = _smooth(levels, l, rl)
            for _ in range(COARSE_SWEEPS - 1):
                z = z + _smooth(levels, l, rl - spmv(l, z))
            return z
        z = _smooth(levels, l, rl)
        zc = cycle(l + 1, down(l, rl - spmv(l, z)))
        z = z + up(l, zc)
        return z + _smooth(levels, l, rl - spmv(l, z))

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
