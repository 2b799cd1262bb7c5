"""Batched Gauss-Newton normal-equation assembly (port of
`smvs_tpu/solver/gn.py`, reference `lib/gauss_newton_step.cc`).

The default, analytic assembly: per (patch, pixel) the data terms (warped
neighbor gradient against the main gradient, IRLS-L1 weighted) get
closed-form value-space Jacobian columns; the normal-divergence
regularizer's columns come from forward-mode AD (`torch.func.jvp`, the
counterpart of JAX's `jax.linearize`); with a lighting, the SH shading term
gets closed-form columns too (the span ``opt.shading``). The per-pixel
quadratic forms are contracted to per-patch 16x16 systems with two matrix
products and scattered into the 9-point stencil.

The autodiff oracle (`GNOptions(analytic=False)`) checks those closed
forms independently: the residual vector of a patch is written as a plain
function of its pixels' six surface values (`_patch_residuals`), and
`torch.func` derives its Jacobian (`patch_grad_hessian`), with the image
sampling's derivative routed through the image Hessian
(`iops.sample_gradient_packed`). Same (g, H) up to rounding, several
times the work and memory; only checks use it.

`assemble` also takes a batch of views of one shape (a batched surface
and `ViewSet`, the counterpart of JAX's `vmap` of the assembly): the
patches of all views are assembled as one flat set, each reading its own
view's warps, images, focal length and lighting, into a stencil system
with a view axis ([4, V, ny1, nx1] and [3, 3, 4, 4, V, ny1, nx1]).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from smvs_tpu_torch.geometry import correspondence as corr
from smvs_tpu_torch.geometry import normals as nrm
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.shading import sh as shmod
from smvs_tpu_torch.solver import stencil
from smvs_tpu_torch.surface import bicubic
from smvs_tpu_torch.surface.state import Surface, patch_params, unstack_surface
from smvs_tpu_torch.utils.perview import rows_matmul, split_rows
from smvs_tpu_torch.utils.timing import host_reads, span

R_FACTOR = 1e-4  # IRLS-L1 floor, reference `lib/gauss_newton_step.cc:17`


@dataclasses.dataclass
class ViewSet:
    """Per-view data at the current scale, on the device; for a batch of
    views (`stack_viewsets`) every field has a leading view axis."""

    grad_main: torch.Tensor  # [2, H, W]
    sub_gh: torch.Tensor  # [N, H, W, 5] or bf16 [N, H, W, 10]
    M: torch.Tensor  # [N, 3, 3]
    t: torch.Tensor  # [N, 3]
    flen: torch.Tensor  # scalar, pixels
    # The shading image packed channels-last with its gradients,
    # [H, W, 3] = (gx, gy, value); None unless shading is active.
    shading_gi: torch.Tensor | None = None


def stack_viewsets(views: list[ViewSet]) -> ViewSet:
    """Batch the ViewSets of views of one shape on a leading view axis."""
    def stack(name):
        vals = [getattr(v, name) for v in views]
        return None if vals[0] is None else torch.stack(vals)

    return ViewSet(**{f.name: stack(f.name)
                      for f in dataclasses.fields(ViewSet)})


def viewset_at(view: ViewSet, i: int | slice) -> ViewSet:
    """View ``i`` of a batched ViewSet (a batch of the views of a slice)."""
    return ViewSet(**{f.name: (None if getattr(view, f.name) is None
                               else getattr(view, f.name)[i])
                      for f in dataclasses.fields(ViewSet)})


@dataclasses.dataclass(frozen=True)
class GNOptions:
    regularization: float = 0.01
    # Weight of the normal-divergence regularizer under shading (x 1/100);
    # 0 turns it off there (`smvs_tpu/solver/gn.py:554-561`).
    light_surf_regularization: float = 0.0
    # The autodiff oracle's slab: at most this many patches, and about
    # chunk * 16 pixels, per pass (its Jacobian is [slab, P, C, 6]). Read
    # by the oracle only.
    chunk: int = 16384
    # Closed-form value-space Jacobians (the default); False assembles
    # through the autodiff oracle instead (same math, several times the
    # work), which checks them.
    analytic: bool = True


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


def _gather_image_at(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor
                     ) -> torch.Tensor:
    """img [..., H, W] at integer pixel coords [ny, nx, P] -> [ny, nx, P, ...]."""
    out = img[..., py, px]  # [..., ny, nx, P]
    lead = img.ndim - 2
    return torch.movedim(out, tuple(range(lead)), tuple(range(-lead, 0)))


def _residual_weights(diffs, subdiffs, div, grad_main, vis, opts: GNOptions,
                      dtype, n_pix, pair_idx, lighting=None, shading=None,
                      lin_grad=None, lin_val=None, shading_res=None):
    """IRLS / term weights of one patch, or of a slab of patches on leading
    axes (reference `lib/gauss_newton_step.cc:334-418`, and :420-516 for
    the shading term).

    diffs [N, (S,) P, 2], subdiffs [(S,) P, pairs, 2] or None,
    div [(S,) P, 6], grad_main [(S,) P, 2], vis [(S,) N]
    -> [(S,) P, 2N + 2*pairs + 6 + 2]. With ``lighting``, the shading
    term's weights from the rendered shading [(S,) P], the shading image's
    gradient [(S,) P, 2] and value [(S,) P] and the shading residual
    [(S,) P, 2]; without, the shading columns weigh 0.
    """
    n_sub = diffs.shape[0]
    num_subs = vis.sum(-1)
    num_diffs = num_subs * (num_subs + 1.0) / 2.0
    wts = []
    data_w = vis[..., None, :, None] / (R_FACTOR + torch.abs(
        torch.movedim(diffs, 0, -2)))  # [(S,) P, N, 2]
    wts.append(data_w.reshape(*data_w.shape[:-2], 2 * n_sub))
    if pair_idx:
        pv = torch.stack([vis[..., a] * vis[..., b] for a, b in pair_idx],
                         dim=-1)
        pair_w = pv[..., None, :, None] / (R_FACTOR + torch.abs(subdiffs))
        wts.append(pair_w.reshape(*pair_w.shape[:-2], 2 * len(pair_idx)))

    gm_abs = torch.abs(grad_main).sum(-1)  # [(S,) P]
    basic_w = opts.regularization * 0.005 / torch.clamp(gm_abs, min=0.03)
    basic_w = basic_w * num_diffs[..., None]
    reg_num = basic_w[..., None]
    if lighting is not None:
        reg_num = reg_num * (opts.light_surf_regularization / 100.0)
    reg_w = reg_num / (R_FACTOR + torch.abs(div))
    if opts.regularization <= 0.0 or (
            lighting is not None and opts.light_surf_regularization <= 0.0):
        reg_w = torch.zeros_like(reg_w)
    wts.append(reg_w)

    if lighting is not None:
        lin_grad_abs = torch.abs(lin_grad).sum(-1)
        shading_weight = 0.001 * num_diffs[..., None] / (
            R_FACTOR + lin_grad_abs)
        gate = ((lin_grad_abs**2 >= 1e-20).to(dtype)
                * (shading**2 >= 1e-10).to(dtype)
                * (lin_val**2 >= 1e-10).to(dtype))
        if opts.regularization <= 0.0:
            gate = gate * 0.0
        wts.append(gate[..., None] * shading_weight[..., None] / (
            R_FACTOR + torch.abs(shading_res)))
    else:
        wts.append(torch.zeros((*div.shape[:-2], n_pix, 2), dtype=dtype,
                               device=div.device))
    return torch.cat(wts, dim=-1)


def _nan0(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _patch_residuals(vals, pix_u, pix_v, grad_main, vis, view: ViewSet,
                     lighting, opts: GNOptions, width: int, height: int,
                     want_weights: bool):
    """Residual vector (and IRLS weights) of one patch, or of a slab of
    patches on leading axes, as a plain function of its pixels' surface
    values: the autodiff oracle's input.

    vals [(S,) P, 6] per pixel (w, dx, dy, dxy, dxx, dyy); pix_u, pix_v
    [(S,) P] pixel centers; grad_main [(S,) P, 2]; vis [(S,) N] (0/1);
    lighting [16] or None. Each residual depends only on its own pixel's
    values, and the values are linear in the node parameters, so the
    Jacobian in the parameters is the one in the values times the basis
    (reference `lib/gauss_newton_step.cc:43-51`).

    Returns residuals [(S,) P, C] (and the weights, the same shape, with
    ``want_weights``), C = 2N (data) + N(N-1) (pairs) + 6 (regularizer)
    + 2 (shading; weight 0 without a lighting). The weights fold in the
    visibility and are constants of the Gauss-Newton step: the caller
    takes no derivative of them.
    """
    n_sub = view.M.shape[0]
    dtype = vals.dtype
    w, wdx, wdy, dxy, dxx, dyy = vals.unbind(-1)

    # --- data terms: warped neighbor gradient against the main gradient ---
    jg = []
    for n in range(n_sub):
        M, t = view.M[n], view.t[n]
        proj, _ = corr.warp(M, t, pix_u, pix_v, w)
        jac = corr.warp_jacobian(M, t, pix_u, pix_v, w, wdx, wdy)
        gs = iops.sample_gradient_packed(view.sub_gh[n], proj[..., 0] - 0.5,
                                         proj[..., 1] - 0.5)
        # J^T grad: the neighbor's gradient in main pixel coordinates,
        # reference `lib/gauss_newton_step.cc:200`.
        jg.append(torch.einsum("...ij,...i->...j", jac, gs))
    jg = torch.stack(jg)  # [N, (S,) P, 2]
    diffs = jg - grad_main[None]
    lead = diffs.shape[1:-1]  # ((S,) P)

    res = [torch.movedim(diffs, 0, -2).reshape(*lead, 2 * n_sub)]
    pair_idx = [(a, b) for a in range(n_sub) for b in range(a + 1, n_sub)]
    subdiffs = None
    if pair_idx:
        subdiffs = torch.stack([jg[a] - jg[b] for a, b in pair_idx], dim=-2)
        res.append(subdiffs.reshape(*lead, 2 * len(pair_idx)))

    # --- regularizer: normal divergence ------------------------------------
    xc = pix_u - width / 2.0
    yc = pix_v - height / 2.0
    div = nrm.normal_divergence(xc, yc, view.flen, w, wdx, wdy, dxy, dxx, dyy)
    res.append(div)  # [(S,) P, 6]

    # --- shading term -------------------------------------------------------
    shading = lin_grad = lin_val = shading_res = None
    if lighting is not None:
        normal = nrm.normal(xc, yc, 1.0 / view.flen, w, wdx, wdy)
        # The SH derivative at the current normal, held constant in the
        # node parameters (the reference's Gauss-Newton approximation,
        # `lib/gauss_newton_step.cc:480-495`); by forward mode, not the
        # closed form (`shmod.eval_4_band_jac`) that the analytic
        # assembly uses and this checks.
        # Each normal enters as [1, 3], not [3]: on 0-d values jacfwd
        # promotes the tangent of a product with a Python float to float64.
        n_rows = normal.detach().reshape(-1, 1, 3)
        sh_jac = torch.func.vmap(torch.func.jacfwd(shmod.eval_4_band))(
            n_rows).reshape(*normal.shape[:-1], 16, 3)
        shading = shmod.eval_4_band(normal) @ lighting  # [(S,) P]
        # d(shading)/d(pixel xy) through the surface: lam . dSH/dn . dn/dxy,
        # band 0 masked.
        lam0 = torch.cat([torch.zeros_like(lighting[:1]), lighting[1:]])
        coef = torch.einsum("l,...lk->...k", lam0, sh_jac)  # [(S,) P, 3]
        shading_grad = torch.stack([(coef * div[..., 0:3]).sum(-1),
                                    (coef * div[..., 3:6]).sum(-1)], dim=-1)
        shading_safe = torch.where(torch.abs(shading) < 1e-10, 1.0, shading)
        render_grad = shading_grad / shading_safe[..., None]

        gi = iops.sample_window(view.shading_gi, pix_u - 0.5, pix_v - 0.5)
        lin_grad = _nan0(gi[..., :2])
        lin_val = gi[..., 2]
        lin_safe = torch.where(torch.abs(lin_val) < 1e-10, 1.0, lin_val)
        shading_res = render_grad - lin_grad / lin_safe[..., None]
        res.append(shading_res)  # [(S,) P, 2]
    else:
        res.append(torch.zeros((*lead, 2), dtype=dtype, device=vals.device))

    residuals = torch.cat(res, dim=-1)
    if not want_weights:
        return residuals
    weights = _residual_weights(
        diffs, subdiffs, div, grad_main, vis, opts, dtype, lead[-1],
        pair_idx, lighting=lighting, shading=shading, lin_grad=lin_grad,
        lin_val=lin_val, shading_res=shading_res)
    return residuals, weights


def patch_grad_hessian(params16, pix_u, pix_v, grad_main, vis, patch_ok,
                       view: ViewSet, basis, lighting, opts: GNOptions,
                       width: int, height: int):
    """(g [(S,) 16], H [(S,) 16, 16]) of one patch, or of a slab of
    patches on a leading axis, by autodiff: the oracle of the closed-form
    assembly.

    params16 [(S,) 16], patch_ok [(S,)] (0/1), basis [P, 6, 16], the rest
    as `_patch_residuals`. The six value-space Jacobian columns come from
    forward mode, `torch.func.vmap` over one-hot seeds of
    `torch.func.jvp`, which evaluates the residuals once and pushes the
    six tangents together (`torch.func.linearize` traces through the
    sampler's `jvp` too, but retraces the residual graph on every call);
    the weights are its auxiliary output and carry no tangent. Then
    H = sum_p basis_p^T (J6^T W J6)_p basis_p and g = sum_p basis_p^T
    (J6^T W r)_p (reference `lib/gauss_newton_step.cc:88-122`).
    """
    safe = torch.zeros_like(params16)
    safe[..., 0::4] = 1.0
    params_safe = torch.where(patch_ok[..., None] > 0, params16, safe)
    vals = torch.einsum("pkm,...m->...pk", basis, params_safe)  # [(S,) P, 6]

    def res_fn(v):
        return _patch_residuals(v, pix_u, pix_v, grad_main, vis, view,
                                lighting, opts, width, height,
                                want_weights=True)

    seeds = torch.eye(6, dtype=vals.dtype, device=vals.device).reshape(
        6, *([1] * (vals.ndim - 1)), 6).expand(6, *vals.shape)
    residuals, cols, weights = torch.func.vmap(
        lambda s: torch.func.jvp(res_fn, (vals,), (s,), has_aux=True))(seeds)
    J6 = _nan0(torch.movedim(cols, 0, -1))  # [(S,) P, C, 6]
    residuals = _nan0(residuals[0])
    weights = weights[0] * patch_ok[..., None, None]

    A = torch.einsum("...pck,...pc,...pcl->...pkl", J6, weights, J6)
    b = torch.einsum("...pck,...pc->...pk", J6, weights * residuals)
    H = torch.einsum("pkm,...pkl,pln->...mn", basis, A, basis)
    g = torch.einsum("pkm,...pk->...m", basis, b)
    return g, H


def _data_term_analytic(M, t, gh_img, u, v, w, wdx, wdy, base=None):
    """Warped-gradient data term for ONE neighbor with closed-form
    value-space derivatives (reference `lib/correspondence.cc:53-187`,
    consumed at `lib/gauss_newton_step.cc:183-207`). M [..., 3, 3] and
    t [..., 3] broadcast against u; with ``base``, gh_img is a stack of
    images and each pixel samples image ``base`` (`iops.sample_gh`).

    Returns (jg [..., 2], d_jg/dw [..., 2], S [...]) with jg = J^T grad_sub
    and S = d jg_x/d wdx = d jg_y/d wdy.
    """
    p = M[..., 0, 0] * u + M[..., 0, 1] * v + M[..., 0, 2]
    q = M[..., 1, 0] * u + M[..., 1, 1] * v + M[..., 1, 2]
    r = M[..., 2, 0] * u + M[..., 2, 1] * v + M[..., 2, 2]
    a = w * p + t[..., 0]
    b = w * q + t[..., 1]
    d = w * r + t[..., 2]
    e = 1.0 / d
    e2 = e * e

    vals5 = iops.sample_gh(gh_img, a * e - 0.5, b * e - 0.5,
                           base)  # [..., 5]
    gs0 = vals5[..., 0]
    gs1 = vals5[..., 1]
    hxx = vals5[..., 2]
    hxy = vals5[..., 3]
    hyy = vals5[..., 4]

    gu = (p - r * a * e) * e
    gv = (q - r * b * e) * e

    A_u = wdx * p + w * M[..., 0, 0]
    A_v = wdy * p + w * M[..., 0, 1]
    B_u = wdx * q + w * M[..., 1, 0]
    B_v = wdy * q + w * M[..., 1, 1]
    D_u = wdx * r + w * M[..., 2, 0]
    D_v = wdy * r + w * M[..., 2, 1]
    j00 = (A_u - a * D_u * e) * e
    j01 = (A_v - a * D_v * e) * e
    j10 = (B_u - b * D_u * e) * e
    j11 = (B_v - b * D_v * e) * e

    jg0 = j00 * gs0 + j10 * gs1
    jg1 = j01 * gs0 + j11 * gs1

    dj00 = (M[..., 0, 0] - (A_u * r + p * D_u + a * M[..., 2, 0]) * e
            + 2.0 * a * r * D_u * e2) * e
    dj01 = (M[..., 0, 1] - (A_v * r + p * D_v + a * M[..., 2, 1]) * e
            + 2.0 * a * r * D_v * e2) * e
    dj10 = (M[..., 1, 0] - (B_u * r + q * D_u + b * M[..., 2, 0]) * e
            + 2.0 * b * r * D_u * e2) * e
    dj11 = (M[..., 1, 1] - (B_v * r + q * D_v + b * M[..., 2, 1]) * e
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
                   width: int, height: int,
                   lighting: torch.Tensor | None = None,
                   vidx: torch.Tensor | None = None,
                   counts: list[int] | None = None):
    """Whole-grid GN assembly: accumulate the per-pixel quadratic form
    A = J6^T W J6 (21 symmetric entries) and b = J6^T W r elementwise,
    then contract to per-patch systems with two matrix products.

    params [B, 16], pix_u/v [B, P], gm [B, P, 2], vis_f [B, N],
    patch_ok [B], lighting [16] or None -> (g [B, 16], H [B, 16, 16]).
    With ``vidx`` [B], the view of each patch (the patches view-major,
    ``counts`` of them per view), ``view`` is a batched ViewSet and
    ``lighting`` [V, 16]; the matrix products then run view by view
    (`utils.perview`), each as it runs for the view alone.
    """
    dtype = params.dtype
    B, P = pix_u.shape
    n_sub = view.M.shape[-3]
    if vidx is None:  # per neighbor: (M, t, sampling image, image index)
        warps = [(view.M[n], view.t[n], view.sub_gh[n], None)
                 for n in range(n_sub)]
        flen = view.flen
    else:  # per patch; sub_gh [V, N, ...] is read as V*N images
        Mp = view.M[vidx][:, None]  # [B, 1, N, 3, 3]
        tp = view.t[vidx][:, None]
        warps = [(Mp[:, :, n], tp[:, :, n], view.sub_gh,
                  (vidx * n_sub + n)[:, None]) for n in range(n_sub)]
        flen = view.flen[vidx][:, None]

    safe = torch.zeros_like(params)
    safe[:, 0::4] = 1.0
    params_safe = torch.where(patch_ok[:, None] > 0, params, safe)
    basis_flat, gsym = _contraction_tensors(patchsize, sampling, dtype,
                                            params.device)
    vals = rows_matmul(params_safe, basis_flat.T, counts).reshape(B, P, 6)
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
    terms = [_data_term_analytic(M, t, gh, pix_u, pix_v, w, wdx, wdy, base)
             for M, t, gh, base in warps]
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
        return nrm.normal_divergence(xc, yc, flen, v[..., 0], v[..., 1],
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
    # Under shading the regularizer is weighted by light_surf_regularization
    # and is off where that is 0 (the flagship's setting).
    shading = lighting is not None
    geom = opts.light_surf_regularization / 100.0 if shading else 1.0
    reg_gate = 0.0 if (opts.regularization <= 0.0 or (
        shading and opts.light_surf_regularization <= 0.0)) else 1.0
    for i in range(6):
        wi = reg_gate * basic_w * geom / (R_FACTOR + torch.abs(div[..., i]))
        wi = wi * okw
        for (k, l) in _SYM_PAIRS:
            A[(k, l)] += wi * jdiv[k][..., i] * jdiv[l][..., i]
        for k in range(6):
            b[k] += wi * div[..., i] * jdiv[k][..., i]

    if shading:
        with span("opt.shading", views=1 if vidx is None else len(counts)):
            _accumulate_shading(A, b, lighting, view, pix_u, pix_v, xc, yc,
                                vals, div, jdiv, num_diffs, okw, opts, vidx,
                                counts)

    # --- basis contraction: two matrix products ----------------------------
    A_packed = torch.stack([A[kl] for kl in _SYM_PAIRS], dim=-1)  # [B, P, 21]
    b_packed = torch.stack(b, dim=-1)  # [B, P, 6]
    H = rows_matmul(A_packed.reshape(B, P * len(_SYM_PAIRS)), gsym,
                    counts).reshape(B, 16, 16)
    g = rows_matmul(b_packed.reshape(B, P * 6), basis_flat, counts)
    return g, H


def _accumulate_shading(A, b, lighting, view: ViewSet, pix_u, pix_v, xc, yc,
                        vals, div, jdiv, num_diffs, okw, opts: GNOptions,
                        vidx=None, counts=None):
    """Add the SH shading term's per-pixel quadratic form to ``A`` / ``b``
    (reference `lib/gauss_newton_step.cc:420-516`).

    Residual, per axis c in {x, y}: r_c = (coef . dn_c) / sh - lin_c with
    sh = lighting . SH(n), coef = lighting . dSH/dn (frozen with respect to
    the node parameters, the reference's GN approximation, :480-495), dn_c
    the normal's derivative along c (the regularizer's ``div`` columns) and
    lin_c the shading image's log-gradient. Its value-space columns are in
    closed form: d(dn_c)/d(vals) reuses ``jdiv``, and d sh/d(vals) flows
    through the unit normal, whose only nonzero columns are (w, dx, dy).
    With ``vidx`` (the view of each patch) the view data are batched and
    ``lighting`` is [V, 16], applied view by view (``counts`` patches
    each).
    """
    dtype = vals.dtype
    w, wdx, wdy = vals[..., 0], vals[..., 1], vals[..., 2]
    if vidx is None:
        inv_flen = 1.0 / view.flen
        base = None
    else:
        inv_flen = 1.0 / view.flen[vidx][:, None]
        base = vidx[:, None]
    # float32 bilinear sample of the 3-channel image (not the bf16 gather).
    gi = iops.sample_window(view.shading_gi, pix_u - 0.5, pix_v - 0.5, base)
    lin_grad = _nan0(gi[..., :2])
    lin_val = gi[..., 2]
    lin_safe = torch.where(torch.abs(lin_val) < 1e-10, 1.0, lin_val)
    lin_term = lin_grad / lin_safe[..., None]

    u1 = wdx
    u2 = -wdy
    u3 = (xc * wdx + yc * wdy + w) * inv_flen
    norm_u = torch.sqrt(u1 * u1 + u2 * u2 + u3 * u3)
    inv_nu = 1.0 / norm_u
    n1, n2, n3 = u1 * inv_nu, u2 * inv_nu, u3 * inv_nu
    normal = torch.stack([n1, n2, n3], dim=-1)  # [B, P, 3]
    basis = shmod.eval_4_band(normal)
    jac = shmod.eval_4_band_jac(normal)

    def shade(light, basis, jac):
        # Row 0 of the SH jacobian is zero: the reference's band-0-masked
        # coef.
        return basis @ light, torch.einsum("l,...lk->...k", light, jac)

    if vidx is None:
        sh_val, coef = shade(lighting, basis, jac)  # [B, P], [B, P, 3]
    else:
        parts = [shade(light, x, j) for light, x, j in zip(
            lighting, split_rows(basis, counts), split_rows(jac, counts))]
        sh_val = torch.cat([p[0] for p in parts])
        coef = torch.cat([p[1] for p in parts])
    sgrad = torch.stack([(coef * div[..., 0:3]).sum(-1),
                         (coef * div[..., 3:6]).sum(-1)], dim=-1)
    safe = torch.where(torch.abs(sh_val) < 1e-10, 1.0, sh_val)
    inv_safe = 1.0 / safe
    sh_res = _nan0(sgrad * inv_safe[..., None] - lin_term)

    # d sh/d val_j = coef . dn/d val_j with dn_j = (du_j - n (n . du_j)) / |u|
    # and du/dw = (0, 0, 1/f), du/ddx = (1, 0, xc/f), du/ddy = (0, -1, yc/f).
    cn = coef[..., 0] * n1 + coef[..., 1] * n2 + coef[..., 2] * n3
    dsh_dval = (
        (coef[..., 2] * inv_flen - cn * (n3 * inv_flen)) * inv_nu,
        (coef[..., 0] + coef[..., 2] * xc * inv_flen
         - cn * (n1 + n3 * xc * inv_flen)) * inv_nu,
        (-coef[..., 1] + coef[..., 2] * yc * inv_flen
         - cn * (-n2 + n3 * yc * inv_flen)) * inv_nu,
    )
    # The 1e-10 floor makes `safe` piecewise: zero derivative on the floor
    # (those pixels are weight-gated anyway).
    live = (torch.abs(sh_val) >= 1e-10).to(dtype)
    quot = live * inv_safe * inv_safe

    lin_grad_abs = torch.abs(lin_grad).sum(-1)
    shading_weight = 0.001 * num_diffs / (R_FACTOR + lin_grad_abs)
    gate = ((lin_grad_abs**2 >= 1e-20).to(dtype)
            * (sh_val**2 >= 1e-10).to(dtype)
            * (lin_val**2 >= 1e-10).to(dtype))
    if opts.regularization <= 0.0:
        gate = gate * 0.0
    for c in range(2):
        sg = sgrad[..., c]
        jsh_c = []
        for k in range(6):
            jc = (coef * jdiv[k][..., 3 * c:3 * c + 3]).sum(-1) * inv_safe
            if k < 3:
                jc = jc - sg * dsh_dval[k] * quot
            jsh_c.append(_nan0(jc))
        wc = gate * shading_weight / (
            R_FACTOR + torch.abs(sh_res[..., c])) * okw
        for (k, l) in _SYM_PAIRS:
            A[(k, l)] += wc * jsh_c[k] * jsh_c[l]
        for k in range(6):
            b[k] += wc * sh_res[..., c] * jsh_c[k]


def _assemble_oracle(params, pix_u, pix_v, gm, vis_f, patch_ok,
                     view: ViewSet, basis, opts: GNOptions, width: int,
                     height: int, lighting=None):
    """`patch_grad_hessian` over the patches in slabs of at most
    ``opts.chunk`` patches and about ``opts.chunk * 16`` pixels, which
    bound the Jacobian's memory. Arguments as `_assemble_flat` (one view)
    -> (g [B, 16], H [B, 16, 16])."""
    nb, n_pix = pix_u.shape
    slab = max(1, min(opts.chunk, nb, (opts.chunk * 16) // max(n_pix, 1)))
    parts = [patch_grad_hessian(params[lo:lo + slab], pix_u[lo:lo + slab],
                                pix_v[lo:lo + slab], gm[lo:lo + slab],
                                vis_f[lo:lo + slab], patch_ok[lo:lo + slab],
                                view, basis, lighting, opts, width, height)
             for lo in range(0, nb, slab)]
    if not parts:
        return params.new_zeros((0, 16)), params.new_zeros((0, 16, 16))
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


# Grids at least this large assemble only the patches that touch an active
# node (the JAX package's capacity tiers start at the same size).
_COMPACT_MIN_PATCHES = 4096


def assemble(surf: Surface, view: ViewSet, vis: torch.Tensor,
             active: torch.Tensor, opts: GNOptions,
             lighting: torch.Tensor | None = None):
    """Stencil normal equations for one Newton step
    (reference `GaussNewtonStep::construct`, :33-143).

    vis [ny, nx, N] per patch/neighbor; active [ny+1, nx+1] bool; lighting
    [16] SH coefficients (adds the shading term; needs
    ``view.shading_gi``) or None. Returns
    (g [4, ny+1, nx+1], Hb [3, 3, 4, 4, ny+1, nx+1]). On large grids only
    patches touching an active node are assembled — exact, since the
    others contribute nothing (`stencil.scatter_patch_systems` zeroes
    inactive rows and columns); `torch.nonzero` takes the place of the JAX
    package's fixed-capacity tiers.

    For a batched surface and ViewSet (a leading view axis V on every
    input, lighting [V, 16]), the systems of all views in one pass:
    (g [4, V, ny+1, nx+1], Hb [3, 3, 4, 4, V, ny+1, nx+1]).

    ``opts.analytic=False`` assembles through the autodiff oracle
    (`patch_grad_hessian`, in slabs of ``opts.chunk``), with the same
    compaction; a batch then runs view by view, each view as it runs
    alone.
    """
    if not opts.analytic and surf.batched:
        outs = [assemble(unstack_surface(surf, i), viewset_at(view, i),
                         vis[i], active[i], opts,
                         None if lighting is None else lighting[i])
                for i in range(surf.nodes.shape[0])]
        return (torch.stack([o[0] for o in outs], dim=1),
                torch.stack([o[1] for o in outs], dim=4))
    ny, nx = surf.num_patches_y, surf.num_patches_x
    dtype = surf.nodes.dtype
    sampling = _sampling_for_scale(surf.scale)
    px, py = _patch_pixel_coords(surf, sampling)

    B = ny * nx
    lead = tuple(surf.patch_valid.shape[:-2])  # (V,) for a batch
    BT = B * int(np.prod(lead))
    params = patch_params(surf).reshape(BT, 16)
    gm = extract_patch_pixels(view.grad_main, surf, sampling)
    if lead:  # [ny, nx, P, V, 2] -> view-major patches
        gm = torch.movedim(gm, -2, 0)
        px, py = (torch.broadcast_to(a, (*lead, *a.shape)) for a in (px, py))
        vidx = torch.arange(lead[0], device=params.device).repeat_interleave(B)
    else:
        vidx = None
    gm = gm.reshape(BT, -1, 2)
    pix_u = px.reshape(BT, -1) + 0.5
    pix_v = py.reshape(BT, -1) + 0.5
    vis_f = vis.to(dtype).reshape(BT, -1)
    patch_ok = (surf.patch_valid.reshape(-1)
                & (vis.reshape(BT, -1).sum(-1) > 0)).to(dtype)

    def run(sel, counts):
        if not opts.analytic:
            basis = bicubic.pixel_basis(surf.patchsize, sampling, dtype=dtype,
                                        device=params.device)
            return _assemble_oracle(params[sel], pix_u[sel], pix_v[sel],
                                    gm[sel], vis_f[sel], patch_ok[sel], view,
                                    basis, opts, surf.width, surf.height,
                                    lighting)
        return _assemble_flat(params[sel], pix_u[sel], pix_v[sel], gm[sel],
                              vis_f[sel], patch_ok[sel], view,
                              surf.patchsize, sampling, opts, surf.width,
                              surf.height, lighting,
                              None if vidx is None else vidx[sel], counts)

    if B >= _COMPACT_MIN_PATCHES:
        ca = (active[..., :-1, :-1] | active[..., :-1, 1:]
              | active[..., 1:, :-1] | active[..., 1:, 1:]) & surf.patch_valid
        idx = torch.nonzero(ca.reshape(-1)).squeeze(1)
        counts = (ca.reshape(lead[0], B).sum(1).tolist() if lead else None)
        host_reads["assemble"] += 2 if lead else 1
        gs, Hs = run(idx, counts)
        g_flat = torch.zeros((BT, 16), dtype=dtype, device=gs.device)
        H_flat = torch.zeros((BT, 16, 16), dtype=dtype, device=gs.device)
        g_flat[idx] = gs
        H_flat[idx] = Hs
    else:
        g_flat, H_flat = run(slice(None), [B] * lead[0] if lead else None)

    g_patch = g_flat.T.reshape(16, *lead, ny, nx)
    H_patch = H_flat.reshape(BT, 256).T.reshape(16, 16, *lead, ny, nx)
    return stencil.scatter_patch_systems(g_patch, H_patch, active,
                                         surf.patch_valid)
