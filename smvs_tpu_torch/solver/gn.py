"""Batched Gauss-Newton normal-equation assembly, analytic base mode
(port of `smvs_tpu/solver/gn.py`, reference `lib/gauss_newton_step.cc`).

Per (patch, pixel) the data terms (warped neighbor gradient against the
main gradient, IRLS-L1 weighted) get closed-form value-space Jacobian
columns; the normal-divergence regularizer's columns come from forward-mode
AD (`torch.func.jvp`, the counterpart of JAX's `jax.linearize`). The
per-pixel quadratic forms are contracted to per-patch 16x16 systems with
two matrix products and scattered into the 9-point stencil.

The shading term is not ported yet; `assemble` has no lighting argument.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from smvs_tpu_torch.geometry import normals as nrm
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.solver import stencil
from smvs_tpu_torch.surface import bicubic
from smvs_tpu_torch.surface.state import Surface, patch_params

R_FACTOR = 1e-4  # IRLS-L1 floor, reference `lib/gauss_newton_step.cc:17`


@dataclasses.dataclass
class ViewSet:
    """Per-view data at the current scale, on the device."""

    grad_main: torch.Tensor  # [2, H, W]
    sub_gh: torch.Tensor  # [N, H, W, 5] or bf16 [N, H, W, 10]
    M: torch.Tensor  # [N, 3, 3]
    t: torch.Tensor  # [N, 3]
    flen: torch.Tensor  # scalar, pixels


@dataclasses.dataclass(frozen=True)
class GNOptions:
    regularization: float = 0.01


def _sampling_for_scale(scale: int) -> int:
    """Pixel subsampling per scale (reference `lib/gauss_newton_step.cc:157-161`)."""
    if scale < 3:
        return 1
    if scale < 5:
        return 2
    return 4


def _patch_pixel_coords(surf: Surface, sampling: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Global pixel coords (px, py) of each patch's (subsampled) pixels,
    [ny, nx, P] in the surface dtype."""
    ps = surf.patchsize
    dt, dev = surf.nodes.dtype, surf.nodes.device
    idx = np.arange(0, ps, sampling)
    ii, jj = np.meshgrid(idx, idx, indexing="xy")
    lx = torch.as_tensor(ii.reshape(-1), dtype=dt, device=dev)
    ly = torch.as_tensor(jj.reshape(-1), dtype=dt, device=dev)
    bx = surf.start_x + torch.arange(surf.num_patches_x, dtype=dt,
                                     device=dev) * ps
    by = surf.start_y + torch.arange(surf.num_patches_y, dtype=dt,
                                     device=dev) * ps
    shape = (surf.num_patches_y, surf.num_patches_x, lx.numel())
    px = torch.broadcast_to(bx[None, :, None] + lx[None, None, :], shape)
    py = torch.broadcast_to(by[:, None, None] + ly[None, None, :], shape)
    return px, py


def extract_patch_pixels(img: torch.Tensor, surf: Surface, sampling: int = 1
                         ) -> torch.Tensor:
    """img [C?, H, W] -> per-patch pixel values [ny, nx, P(, C)] by static
    slicing, in the order of `_patch_pixel_coords`."""
    ps = surf.patchsize
    ny, nx = surf.num_patches_y, surf.num_patches_x
    sy, sx = surf.start_y, surf.start_x
    lead = img.shape[:-2]
    region = img[..., sy : sy + ny * ps, sx : sx + nx * ps]
    r = region.reshape(*lead, ny, ps, nx, ps)
    r = r[..., ::sampling, :, ::sampling]
    r = torch.movedim(r, -3, -2)  # [..., ny, nx, ps/s, ps/s]
    r = r.reshape(*lead, ny, nx, r.shape[-1] * r.shape[-2])
    if lead:
        r = torch.movedim(r, tuple(range(len(lead))),
                          tuple(range(-len(lead), 0)))
    return r


def _residual_weights(diffs, subdiffs, div, grad_main, vis, opts: GNOptions,
                      dtype, n_pix, pair_idx):
    """IRLS / term weights of one patch without the shading term
    (reference `lib/gauss_newton_step.cc:334-418`).

    diffs [N, P, 2], subdiffs [P, pairs, 2] or None, div [P, 6],
    grad_main [P, 2], vis [N] -> [P, 2N + 2*pairs + 6 + 2].
    """
    n_sub = diffs.shape[0]
    num_subs = torch.sum(vis)
    num_diffs = num_subs * (num_subs + 1.0) / 2.0
    wts = []
    data_w = vis[None, :, None] / (R_FACTOR + torch.abs(
        torch.movedim(diffs, 0, 1)))  # [P, N, 2]
    wts.append(data_w.reshape(-1, 2 * n_sub))
    if pair_idx:
        pv = torch.stack([vis[a] * vis[b] for a, b in pair_idx])
        pair_w = pv[None, :, None] / (R_FACTOR + torch.abs(subdiffs))
        wts.append(pair_w.reshape(-1, 2 * len(pair_idx)))

    gm_abs = torch.abs(grad_main).sum(-1)  # [P]
    basic_w = opts.regularization * 0.005 / torch.clamp(gm_abs, min=0.03)
    basic_w = basic_w * num_diffs
    reg_w = basic_w[:, None] / (R_FACTOR + torch.abs(div))
    if opts.regularization <= 0.0:
        reg_w = torch.zeros_like(reg_w)
    wts.append(reg_w)
    wts.append(torch.zeros((n_pix, 2), dtype=dtype, device=div.device))
    return torch.cat(wts, dim=-1)


def _nan0(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _data_term_analytic(M, t, gh_img, u, v, w, wdx, wdy):
    """Warped-gradient data term for ONE neighbor with closed-form
    value-space derivatives (reference `lib/correspondence.cc:53-187`,
    consumed at `lib/gauss_newton_step.cc:183-207`).

    Returns (jg [..., 2], d_jg/dw [..., 2], S [...]) with jg = J^T grad_sub
    and S = d jg_x/d wdx = d jg_y/d wdy.
    """
    p = M[0, 0] * u + M[0, 1] * v + M[0, 2]
    q = M[1, 0] * u + M[1, 1] * v + M[1, 2]
    r = M[2, 0] * u + M[2, 1] * v + M[2, 2]
    a = w * p + t[0]
    b = w * q + t[1]
    d = w * r + t[2]
    e = 1.0 / d
    e2 = e * e

    vals5 = iops.sample_gh(gh_img, a * e - 0.5, b * e - 0.5)  # [..., 5]
    gs0 = vals5[..., 0]
    gs1 = vals5[..., 1]
    hxx = vals5[..., 2]
    hxy = vals5[..., 3]
    hyy = vals5[..., 4]

    gu = (p - r * a * e) * e
    gv = (q - r * b * e) * e

    A_u = wdx * p + w * M[0, 0]
    A_v = wdy * p + w * M[0, 1]
    B_u = wdx * q + w * M[1, 0]
    B_v = wdy * q + w * M[1, 1]
    D_u = wdx * r + w * M[2, 0]
    D_v = wdy * r + w * M[2, 1]
    j00 = (A_u - a * D_u * e) * e
    j01 = (A_v - a * D_v * e) * e
    j10 = (B_u - b * D_u * e) * e
    j11 = (B_v - b * D_v * e) * e

    jg0 = j00 * gs0 + j10 * gs1
    jg1 = j01 * gs0 + j11 * gs1

    dj00 = (M[0, 0] - (A_u * r + p * D_u + a * M[2, 0]) * e
            + 2.0 * a * r * D_u * e2) * e
    dj01 = (M[0, 1] - (A_v * r + p * D_v + a * M[2, 1]) * e
            + 2.0 * a * r * D_v * e2) * e
    dj10 = (M[1, 0] - (B_u * r + q * D_u + b * M[2, 0]) * e
            + 2.0 * b * r * D_u * e2) * e
    dj11 = (M[1, 1] - (B_v * r + q * D_v + b * M[2, 1]) * e
            + 2.0 * b * r * D_v * e2) * e

    dgs0 = hxx * gu + hxy * gv
    dgs1 = hxy * gu + hyy * gv

    djg0_dw = dj00 * gs0 + dj10 * gs1 + j00 * dgs0 + j10 * dgs1
    djg1_dw = dj01 * gs0 + dj11 * gs1 + j01 * dgs0 + j11 * dgs1
    S = gu * gs0 + gv * gs1

    jg = torch.stack([jg0, jg1], dim=-1)
    djg_dw = torch.stack([djg0_dw, djg1_dw], dim=-1)
    return jg, djg_dw, S


_SYM_PAIRS = [(k, l) for k in range(6) for l in range(k, 6)]  # 21 upper-tri


@functools.lru_cache(maxsize=None)
def _contraction_tensors_np(patchsize: int, sampling: int, dtype_name: str):
    """Static basis contraction tensors (numpy): basis_flat [P*6, 16] and
    gsym [P*21, 256] with gsym[p, (k,l)] = vec(b_pk b_pl^T) (+ transpose
    when k != l), so H = A_sym @ gsym and g = b @ basis_flat."""
    basis = bicubic.pixel_basis(patchsize, sampling,
                                dtype=getattr(torch, dtype_name)).numpy()
    P = basis.shape[0]
    gsym = np.zeros((P, len(_SYM_PAIRS), 16, 16), basis.dtype)
    for idx, (k, l) in enumerate(_SYM_PAIRS):
        outer = np.einsum("pm,pn->pmn", basis[:, k, :], basis[:, l, :])
        if k != l:
            outer = outer + np.swapaxes(outer, -1, -2)
        gsym[:, idx] = outer
    return (basis.reshape(P * 6, 16),
            gsym.reshape(P * len(_SYM_PAIRS), 256))


def _contraction_tensors(patchsize: int, sampling: int, dtype, device):
    basis_flat, gsym = _contraction_tensors_np(
        patchsize, sampling, str(dtype).removeprefix("torch."))
    return (torch.as_tensor(basis_flat, device=device),
            torch.as_tensor(gsym, device=device))


def _assemble_flat(params, pix_u, pix_v, gm, vis_f, patch_ok, view: ViewSet,
                   patchsize: int, sampling: int, opts: GNOptions,
                   width: int, height: int):
    """Whole-grid GN assembly: accumulate the per-pixel quadratic form
    A = J6^T W J6 (21 symmetric entries) and b = J6^T W r elementwise,
    then contract to per-patch systems with two matrix products.

    params [B, 16], pix_u/v [B, P], gm [B, P, 2], vis_f [B, N],
    patch_ok [B] -> (g [B, 16], H [B, 16, 16]).
    """
    dtype = params.dtype
    B, P = pix_u.shape
    n_sub = view.M.shape[0]

    safe = torch.zeros_like(params)
    safe[:, 0::4] = 1.0
    params_safe = torch.where(patch_ok[:, None] > 0, params, safe)
    basis_flat, gsym = _contraction_tensors(patchsize, sampling, dtype,
                                            params.device)
    vals = (params_safe @ basis_flat.T).reshape(B, P, 6)
    w = vals[..., 0]
    wdx = vals[..., 1]
    wdy = vals[..., 2]

    A = {kl: torch.zeros((B, P), dtype=dtype, device=params.device)
         for kl in _SYM_PAIRS}
    b = [torch.zeros((B, P), dtype=dtype, device=params.device)
         for _ in range(6)]

    num_subs = vis_f.sum(-1)  # [B]
    num_diffs = (num_subs * (num_subs + 1.0) / 2.0)[:, None]  # [B, 1]
    okw = patch_ok[:, None]

    def accum_sparse(rx, ry, dwx, dwy, S, wt_x, wt_y):
        """Data/pair channels: J rows (dwx, S, 0, ...) and (dwy, 0, S, ...)."""
        A[(0, 0)] += wt_x * dwx * dwx + wt_y * dwy * dwy
        A[(0, 1)] += wt_x * dwx * S
        A[(1, 1)] += wt_x * S * S
        A[(0, 2)] += wt_y * dwy * S
        A[(2, 2)] += wt_y * S * S
        b[0] += wt_x * rx * dwx + wt_y * ry * dwy
        b[1] += wt_x * rx * S
        b[2] += wt_y * ry * S

    # --- data terms ---------------------------------------------------------
    terms = [_data_term_analytic(view.M[n], view.t[n], view.sub_gh[n],
                                 pix_u, pix_v, w, wdx, wdy)
             for n in range(n_sub)]
    jg = [_nan0(tr[0]) for tr in terms]
    djg_dw = [_nan0(tr[1]) for tr in terms]
    S = [_nan0(tr[2]) for tr in terms]

    for n in range(n_sub):
        rx = jg[n][..., 0] - gm[..., 0]
        ry = jg[n][..., 1] - gm[..., 1]
        vn = vis_f[:, n][:, None] * okw
        accum_sparse(rx, ry, djg_dw[n][..., 0], djg_dw[n][..., 1], S[n],
                     vn / (R_FACTOR + torch.abs(rx)),
                     vn / (R_FACTOR + torch.abs(ry)))

    for a in range(n_sub):
        for c in range(a + 1, n_sub):
            rx = jg[a][..., 0] - jg[c][..., 0]
            ry = jg[a][..., 1] - jg[c][..., 1]
            pv = (vis_f[:, a] * vis_f[:, c])[:, None] * okw
            accum_sparse(rx, ry,
                         djg_dw[a][..., 0] - djg_dw[c][..., 0],
                         djg_dw[a][..., 1] - djg_dw[c][..., 1],
                         S[a] - S[c],
                         pv / (R_FACTOR + torch.abs(rx)),
                         pv / (R_FACTOR + torch.abs(ry)))

    # --- regularizer: 6 divergence components, dense 6x6 value Jacobian ----
    xc = pix_u - width / 2.0
    yc = pix_v - height / 2.0

    def div_of(v):
        return nrm.normal_divergence(xc, yc, view.flen, v[..., 0], v[..., 1],
                                     v[..., 2], v[..., 3], v[..., 4],
                                     v[..., 5])

    jdiv = []
    for k in range(6):
        tangent = torch.zeros_like(vals)
        tangent[..., k] = 1.0
        div, col = torch.func.jvp(div_of, (vals,), (tangent,))
        jdiv.append(_nan0(col))  # column k of d(div)/d(vals): [B, P, 6]
    div = _nan0(div)

    gm_abs = torch.abs(gm).sum(-1)  # [B, P]
    basic_w = opts.regularization * 0.005 / torch.clamp(gm_abs, min=0.03)
    basic_w = basic_w * num_diffs
    reg_gate = 0.0 if opts.regularization <= 0.0 else 1.0
    for i in range(6):
        wi = reg_gate * basic_w / (R_FACTOR + torch.abs(div[..., i]))
        wi = wi * okw
        for (k, l) in _SYM_PAIRS:
            A[(k, l)] += wi * jdiv[k][..., i] * jdiv[l][..., i]
        for k in range(6):
            b[k] += wi * div[..., i] * jdiv[k][..., i]

    # --- basis contraction: two matrix products ----------------------------
    A_packed = torch.stack([A[kl] for kl in _SYM_PAIRS], dim=-1)  # [B, P, 21]
    b_packed = torch.stack(b, dim=-1)  # [B, P, 6]
    H = (A_packed.reshape(B, P * len(_SYM_PAIRS)) @ gsym).reshape(B, 16, 16)
    g = b_packed.reshape(B, P * 6) @ basis_flat
    return g, H


# Grids at least this large assemble only the patches that touch an active
# node (the JAX package's capacity tiers start at the same size).
_COMPACT_MIN_PATCHES = 4096


def assemble(surf: Surface, view: ViewSet, vis: torch.Tensor,
             active: torch.Tensor, opts: GNOptions):
    """Stencil normal equations for one Newton step
    (reference `GaussNewtonStep::construct`, :33-143).

    vis [ny, nx, N] per patch/neighbor; active [ny+1, nx+1] bool. Returns
    (g [4, ny+1, nx+1], Hb [3, 3, 4, 4, ny+1, nx+1]). On large grids only
    patches touching an active node are assembled — exact, since the
    others contribute nothing (`stencil.scatter_patch_systems` zeroes
    inactive rows and columns); `torch.nonzero` takes the place of the JAX
    package's fixed-capacity tiers.
    """
    ny, nx = surf.num_patches_y, surf.num_patches_x
    dtype = surf.nodes.dtype
    sampling = _sampling_for_scale(surf.scale)
    px, py = _patch_pixel_coords(surf, sampling)

    B = ny * nx
    params = patch_params(surf).reshape(B, 16)
    gm = extract_patch_pixels(view.grad_main, surf, sampling).reshape(
        B, -1, 2)
    pix_u = px.reshape(B, -1) + 0.5
    pix_v = py.reshape(B, -1) + 0.5
    vis_f = vis.to(dtype).reshape(B, -1)
    patch_ok = (surf.patch_valid.reshape(-1)
                & (vis.reshape(B, -1).sum(-1) > 0)).to(dtype)

    def run(sel):
        return _assemble_flat(params[sel], pix_u[sel], pix_v[sel], gm[sel],
                              vis_f[sel], patch_ok[sel], view,
                              surf.patchsize, sampling, opts, surf.width,
                              surf.height)

    if B >= _COMPACT_MIN_PATCHES:
        ca = (active[:-1, :-1] | active[:-1, 1:]
              | active[1:, :-1] | active[1:, 1:]) & surf.patch_valid
        idx = torch.nonzero(ca.reshape(-1)).squeeze(1)
        gs, Hs = run(idx)
        g_flat = torch.zeros((B, 16), dtype=dtype, device=gs.device)
        H_flat = torch.zeros((B, 16, 16), dtype=dtype, device=gs.device)
        g_flat[idx] = gs
        H_flat[idx] = Hs
    else:
        g_flat, H_flat = run(slice(None))

    g_patch = g_flat.T.reshape(16, ny, nx)
    H_patch = H_flat.reshape(B, 256).T.reshape(16, 16, ny, nx)
    return stencil.scatter_patch_systems(g_patch, H_patch, active,
                                         surf.patch_valid)
