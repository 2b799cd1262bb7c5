"""Per-view coarse-to-fine depth optimization controller (port of
`smvs_tpu/pipeline/optimizer.py`, reference `lib/depth_optimizer.cc`).

The scale loop, Newton iterations with a reprojection-delta working set,
visibility and boundary cutting run as tensor programs on the view's
device; host loops replace JAX's `lax.while_loop`s with the same exit
rules, reading a few scalars back per iteration. The optimizer runs in
float32 with the bf16 x-paired assembly gather, like the JAX package.

Both init modes are ported: from an SGM depth (`use_sgm=True`, one or
more neighbors) and from a sparse depth prior (`use_sgm=False`: the
bundle's feature splats, a scale coarser, with the visibility pass's NCC
occlusion test and the surface grown by `Surface.expand` after every
boundary cut), each in base mode and shading-aware (`use_shading`: the SH
lighting is refit from the surface's normals at the start of every scale
below 4, and the Newton systems there carry the shading term and the
multigrid's constant damping), with the working-set Newton loop or the
full optimization of every node (`full_optimization`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.geometry import correspondence as corr
from smvs_tpu_torch.image import bilateral
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.pipeline.views import StereoViewState
from smvs_tpu_torch.shading import lighting as L
from smvs_tpu_torch.shading.lighting import fit_lighting
from smvs_tpu_torch.solver import cg, gn, mg, stencil
from smvs_tpu_torch.surface import bicubic
from smvs_tpu_torch.surface import state as S
from smvs_tpu_torch.utils import timing
from smvs_tpu_torch.utils.perview import per_view, rows_matmul
from smvs_tpu_torch.utils.timing import host_reads, span

_F32 = np.float32  # host-side scalar tests round like the device's float32


@dataclasses.dataclass(frozen=True)
class OptimizerOptions:
    """`DepthOptimizer::Options` (reference `lib/depth_optimizer.h:30-42`)
    with the JAX package's Newton-step knobs."""

    regularization: float = 0.001
    # Under shading: the normal-divergence regularizer's weight (x 1/100),
    # 0 = off (the CLI's -R).
    light_surf_regularization: float = 0.0
    num_iterations: int = 10
    min_scale: int = 1
    use_shading: bool = False
    use_sgm: bool = False
    # Keep every node active in every Newton step, and leave the loop when
    # the average reprojection delta drops below 0.01 (the CLI's
    # --full-opt).
    full_optimization: bool = False
    debug_lvl: int = 0
    output_name: str = "smvs"
    max_newton_steps: int = 200
    # CG preconditioner: "mg" (the multigrid V-cycle, solver/mg.py) or
    # "jacobi" (the inverted block diagonal, reference
    # `lib/block_sparse_matrix.h:300-316`).
    precond: str = "mg"
    # Newton steps without active-set or reprojection-delta improvement
    # before the inner loop exits.
    stall_limit: int = 8
    # bf16 x-paired assembly gather (`iops.pack_gradhess_pair10`), float32
    # runs only; False keeps the float32 gather.
    bf16_gather: bool = True
    # Run exactly max_newton_steps per inner loop (equality harnesses).
    fixed_newton_steps: bool = False


def initial_scale(width: int, height: int) -> int:
    """Reference `lib/depth_optimizer.cc:37-39`."""
    return int(max(np.ceil(np.log2(width * height / 1.7e6) / 2) + 4, 4))


def _build_viewset(main: StereoViewState, subs: list[StereoViewState],
                   scale: int, dtype, bf16_gather: bool = False,
                   use_shading: bool = False) -> gn.ViewSet:
    mi = main.at_scale(scale)
    pack = (iops.pack_gradhess_pair10
            if bf16_gather and dtype == torch.float32 else iops.pack_gradhess)
    sub_gh = torch.stack([
        pack(s.at_scale(scale).grad.to(dtype), s.at_scale(scale).hess.to(dtype))
        for s in subs])
    Ms, ts = [], []
    for s in subs:
        M, t = main.camera.fill_reprojection(
            s.camera, main.width, main.height, s.width, s.height)
        Ms.append(M)
        ts.append(t)
    dev = main.device
    shading_gi = None
    if use_shading:
        shading_image, shading_grad = main.shading_images()
        shading_gi = torch.movedim(
            torch.cat([shading_grad, shading_image[None]], dim=0),
            0, -1).to(dtype).contiguous()  # [H, W, 3] = (gx, gy, value)
    return gn.ViewSet(
        grad_main=mi.grad.to(dtype),
        sub_gh=sub_gh,
        M=torch.as_tensor(np.stack(Ms), dtype=dtype, device=dev),
        t=torch.as_tensor(np.stack(ts), dtype=dtype, device=dev),
        flen=torch.as_tensor(main.flen(), dtype=dtype, device=dev),
        shading_gi=shading_gi,
    )


# ---------------------------------------------------------------------------
# geometry helpers on the patch grid


def _patch_pixel_grids_sub(surf: S.Surface, sampling: int = 1):
    """Pixel centers (u, v) per patch, each [ny, nx, P]."""
    px, py = gn._patch_pixel_coords(surf, sampling=sampling)
    return px + 0.5, py + 0.5


def _patch_depths_and_derivs_sub(surf: S.Surface, sampling: int = 1):
    """(w, wdx, wdy) per (subsampled) patch pixel, each [(V,) ny, nx, P]."""
    basis = bicubic.pixel_basis(surf.patchsize, sampling,
                                dtype=surf.nodes.dtype,
                                device=surf.nodes.device)
    b2 = basis[:, :3, :].reshape(-1, 16)  # [P*3, 16]
    params = S.patch_params(surf).reshape(-1, 16)
    vals = _patch_matmul(surf, params, b2.T).reshape(
        *surf.patch_valid.shape, -1, 3)
    return vals[..., 0], vals[..., 1], vals[..., 2]


def _patch_matmul(surf: S.Surface, a: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """``a @ b`` for per-patch rows ``a``; for a batched surface one
    product per view, each as the view's own rows alone give it."""
    counts = None
    if surf.batched:
        counts = [surf.num_patches_y * surf.num_patches_x] * \
            surf.nodes.shape[0]
    return rows_matmul(a, b, counts)


# ---------------------------------------------------------------------------
# visibility (create_subview_surfaces)


def zbuffer_scatter(view: gn.ViewSet, src: torch.Tensor) -> torch.Tensor:
    """Min-depth z-buffer of a full-res depth source in each neighbor:
    [N, (sub_h+1)*(sub_w+1)] center splats (1e4 = empty). Min is
    order-independent, so the scatter is exact on any device."""
    H, W = src.shape
    dtype = src.dtype
    sub_h, sub_w = view.sub_gh.shape[1:3]
    u_img = torch.arange(W, device=src.device).to(dtype)[None, :] + 0.5
    v_img = torch.arange(H, device=src.device).to(dtype)[:, None] + 0.5
    valid = src > 0
    big = 1e4
    out = []
    for n in range(view.M.shape[0]):
        proj, d = corr.warp(view.M[n], view.t[n], u_img, v_img, src)
        pxl = proj[..., 0] - 0.5
        pyl = proj[..., 1] - 0.5
        ok = valid & (pxl >= 3.0) & (pxl < sub_w - 3.0) & \
            (pyl >= 3.0) & (pyl < sub_h - 3.0)
        cx = torch.clamp(pxl.to(torch.int64), 1, sub_w - 2)
        cy = torch.clamp(pyl.to(torch.int64), 1, sub_h - 2)
        vals = torch.where(ok, d, big).reshape(-1)
        idx = (cy * (sub_w + 1) + cx).reshape(-1)
        buf = torch.full(((sub_h + 1) * (sub_w + 1),), big, dtype=dtype,
                         device=src.device)
        out.append(buf.scatter_reduce_(0, idx, vals, "amin",
                                       include_self=True))
    return torch.stack(out)


def _min_pool3(c: torch.Tensor) -> torch.Tensor:
    """3x3 min-pool of [N, h, w] with +inf borders."""
    cp = torch.nn.functional.pad(c, (0, 0, 1, 1), value=torch.inf)
    c = torch.minimum(torch.minimum(cp[:, :-2], cp[:, 1:-1]), cp[:, 2:])
    cp = torch.nn.functional.pad(c, (1, 1), value=torch.inf)
    return torch.minimum(torch.minimum(cp[:, :, :-2], cp[:, :, 1:-1]),
                         cp[:, :, 2:])


def compute_visibility(surf: S.Surface, view: gn.ViewSet,
                       sgm_zbuffer: torch.Tensor | None,
                       ncc_images: tuple | None = None
                       ) -> tuple[S.Surface, torch.Tensor]:
    """Per-(patch, neighbor) visibility; deletes patches visible nowhere
    (reference `lib/depth_optimizer.cc:433-604`): z-buffer with 0.95
    tolerance and the warp-anisotropy test (sigma ratio <= 8), and, given
    ``ncc_images`` (the main image [H, W] and the neighbors' [N, H, W] at
    the surface's scale; the optimizer gives them without SGM), the NCC
    occlusion test. ``sgm_zbuffer`` is `zbuffer_scatter` of the SGM depth.
    Returns (surface, vis [ny, nx, N])."""
    N = view.M.shape[0]
    sub_h, sub_w = view.sub_gh.shape[1:3]

    # Pass 1: min-depth z-buffer; each point splats a 3x3 footprint, done
    # as a center scatter plus a 3x3 min-pool (the second pool folds in the
    # patch test's own 3x3 window).
    cache = zbuffer_scatter(view, S.depth_map(surf))
    if sgm_zbuffer is not None:
        cache = torch.minimum(cache, sgm_zbuffer.to(cache.dtype))
    cache = _min_pool3(_min_pool3(cache.reshape(N, sub_h + 1, sub_w + 1)))

    # Pass 2: per-patch tests.
    u, v = _patch_pixel_grids_sub(surf)
    w, wdx, wdy = _patch_depths_and_derivs_sub(surf)
    cutoff = 0.03 * max(sub_w, sub_h)
    if ncc_images is not None:
        # (u, v) are exact pixel centers: the main-view values are slices.
        main_vals = gn.extract_patch_pixels(ncc_images[0], surf)  # [.., P]
        m0 = main_vals - main_vals.mean(dim=-1, keepdim=True)
        n0 = torch.linalg.vector_norm(m0, dim=-1)
    vis = []
    for n in range(N):
        M, t = view.M[n], view.t[n]
        proj, d = corr.warp(M, t, u, v, w)  # [ny, nx, P, 2]
        pxl = proj[..., 0] - 0.5
        pyl = proj[..., 1] - 0.5
        inb = (pxl >= cutoff) & (pxl < sub_w - cutoff) & \
            (pyl >= cutoff) & (pyl < sub_h - cutoff)
        in_bounds = inb.all(dim=-1)
        cx = torch.clamp(pxl.to(torch.int64), 1, sub_w - 2)
        cy = torch.clamp(pyl.to(torch.int64), 1, sub_h - 2)
        nb_min = cache[n][cy, cx]
        occluded = (d * 0.95 > nb_min).any(dim=-1)
        jac = corr.warp_jacobian(M, t, u, v, w, wdx, wdy)
        aniso = corr.jacobian_condition(jac).amax(dim=-1) <= 8.0
        ok = in_bounds & ~occluded & aniso
        if ncc_images is not None:
            # NCC of main vs warped neighbor intensities over the patch
            # (reference :577-580).
            sub_vals = iops.bilinear_packed4(
                iops.pack_window4(ncc_images[1][n]), pxl, pyl)
            m1 = sub_vals - sub_vals.mean(dim=-1, keepdim=True)
            n1 = torch.linalg.vector_norm(m1, dim=-1)
            ncc = torch.sum(m0 * m1, dim=-1) / torch.clamp(n0 * n1,
                                                           min=1e-20)
            textureless = (n0 + n1) < 0.001 * u.shape[-1]
            ok = ok & (textureless | (ncc >= 0))
        vis.append(ok)
    vis = torch.stack(vis, dim=-1) & surf.patch_valid[..., None]

    surf = S.delete_patches(surf, ~vis.any(dim=-1) & surf.patch_valid)
    surf = S.remove_nodes_without_patch(surf)
    return surf, vis & surf.patch_valid[..., None]


# ---------------------------------------------------------------------------
# boundary cutting


def cut_boundaries_loop(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                        inv_flen_cal: torch.Tensor):
    """Repeat boundary cutting while it deletes > 10 patches
    (reference `lib/depth_optimizer.cc:192-194, 326-328`)."""
    while True:
        surf, deleted = cut_boundaries(surf, view, vis, inv_flen_cal)
        vis = vis & surf.patch_valid[..., None]
        if deleted <= 10:
            return surf, vis


def cut_boundaries(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                   inv_flen_cal: torch.Tensor) -> tuple[S.Surface, int]:
    """One sweep of boundary cutting (reference `lib/depth_optimizer.cc:360-431`):
    depth discontinuities over a patch's corner nodes, and the photometric
    error of border patches. ``inv_flen_cal`` is the main view's 3x3
    inverse calibration in float64 (as the JAX package holds it).
    Returns (surface, number deleted)."""
    ny, nx, _ = vis.shape
    ps = surf.patchsize
    n = surf.nodes
    dev = n.device

    corners = torch.stack([n[:-1, :-1, 0], n[:-1, 1:, 0], n[1:, :-1, 0],
                           n[1:, 1:, 0]], dim=-1)  # [ny, nx, 4]
    dmin = corners.amin(-1)
    dmax = corners.amax(-1)
    amin = corners.argmin(-1)
    amax = corners.argmax(-1)
    f64 = torch.float64
    dd_factor = torch.where(amin + amax == 3,
                            torch.tensor(5.0 * np.sqrt(2.0), dtype=f64,
                                         device=dev),
                            torch.tensor(5.0, dtype=f64, device=dev))

    inv = inv_flen_cal.to(f64)
    bx = torch.as_tensor(surf.start_x + np.arange(nx) * ps, dtype=f64,
                         device=dev)
    by = torch.as_tensor(surf.start_y + np.arange(ny) * ps, dtype=f64,
                         device=dev)
    vx = inv[0, 0] * (bx + 0.5) + inv[0, 2]
    vy = inv[1, 1] * (by + 0.5) + inv[1, 2]
    vnorm = torch.sqrt(vx[None, :] ** 2 + vy[:, None] ** 2 + 1.0)
    threshold = dd_factor * dmin * inv[0, 0] * ps / vnorm
    cut_depth = (dmax - dmin) > threshold

    nvp = S._pad2(surf.node_valid, 1, 1, 1, 1)
    ny1, nx1 = surf.node_valid.shape
    invalid_count = torch.zeros((ny1, nx1), dtype=torch.int32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            invalid_count = invalid_count + (
                ~nvp[1 + dy : 1 + dy + ny1, 1 + dx : 1 + dx + nx1]
            ).to(torch.int32)
    node_border = invalid_count > 1
    patch_border = (node_border[:-1, :-1] | node_border[:-1, 1:]
                    | node_border[1:, :-1] | node_border[1:, 1:])
    B = ny * nx
    cap = B // 4 if B >= 4096 else None
    mse = patch_mse(surf, view, vis, select=patch_border & surf.patch_valid,
                    capacity=cap)
    cut_border = patch_border & (mse > 0.05)

    delete = (cut_depth | cut_border) & surf.patch_valid
    deleted = int(delete.sum())
    host_reads["cut"] += 1
    surf = S.delete_patches(surf, delete)
    return S.remove_nodes_without_patch(surf), deleted


def patch_mse(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
              select: torch.Tensor | None = None,
              capacity: int | None = None) -> torch.Tensor:
    """Mean photometric-gradient error per patch (reference :747-790).

    With `select`/`capacity`, only the first ``capacity`` selected patches
    (in grid order, as the JAX package's fixed-size compaction takes them)
    are evaluated; the rest get 0 (never cut).
    """
    u, v = _patch_pixel_grids_sub(surf)
    w, wdx, wdy = _patch_depths_and_derivs_sub(surf)
    gm = gn.extract_patch_pixels(view.grad_main, surf)  # [ny, nx, P, 2]
    ny, nx = surf.num_patches_y, surf.num_patches_x
    B = ny * nx
    P = u.shape[-1]

    compact = capacity is not None and capacity < B
    if compact:
        idx = torch.nonzero(select.reshape(-1)).squeeze(1)[:capacity]
        host_reads["cut"] += 1
        u, v, w, wdx, wdy = (a.reshape(B, P)[idx]
                             for a in (u, v, w, wdx, wdy))
        gm = gm.reshape(B, P, 2)[idx]
        vis_sel = vis.reshape(B, -1)[idx]
    else:
        vis_sel = vis

    errs = []
    for n in range(view.M.shape[0]):
        M, t = view.M[n], view.t[n]
        proj, _ = corr.warp(M, t, u, v, w)
        jac = corr.warp_jacobian(M, t, u, v, w, wdx, wdy)
        gs = iops.sample_gh(view.sub_gh[n], proj[..., 0] - 0.5,
                            proj[..., 1] - 0.5)[..., :2]
        jg = torch.einsum("...ij,...i->...j", jac, gs)
        errs.append(torch.linalg.vector_norm(gm - jg, dim=-1))  # [..., P]
    err = torch.stack(errs, dim=-1)  # [..., P, N]
    mask = vis_sel[..., None, :].to(err.dtype)
    total = (err * mask).sum((-1, -2))
    count = mask.sum(-1).sum(-1) * err.shape[-2]
    mse = torch.where(count > 0, total / torch.clamp(count, min=1.0), 1.0)
    if compact:
        out = torch.zeros((B,), dtype=mse.dtype, device=mse.device)
        out[idx] = mse
        return out.reshape(ny, nx)
    if select is not None:
        mse = torch.where(select, mse, 0.0)
    return mse


def patch_tex_score(surf: S.Surface, main_image: torch.Tensor) -> torch.Tensor:
    """Mean absolute deviation of patch intensities, 0 for patches darker
    than the 0.05 mean gate (reference `tex_score_for_patch`, :914-955)."""
    vals = gn.extract_patch_pixels(main_image, surf)  # [ny, nx, P]
    mean = vals.mean(dim=-1, keepdim=True)
    score = torch.abs(vals - mean).mean(dim=-1)
    return torch.where(mean[..., 0] >= 0.05, score, 0.0)


# ---------------------------------------------------------------------------
# Newton iterations


@dataclasses.dataclass
class _StepResult:
    nodes: torch.Tensor
    active: torch.Tensor
    bad: bool
    avg: np.floating  # average reprojection delta, in the surface's dtype
    rel_step: np.floating  # largest relative depth step
    n_active: int
    cg_iters: int


def _step_motion(s: S.Surface, s2: S.Surface, view: gn.ViewSet,
                 vis: torch.Tensor, act: torch.Tensor):
    """The step s -> s2's average reprojection delta, first order
    |dproj/dw| * |dw| on a 2x2 pixel subsample per patch, over the
    visible pixels of patches with an active corner, and the next working
    set: the valid nodes of the patches it moved by more than 0.15 px.
    For a batch of views, one average per view [V], each summed as the
    view alone sums it, and the sets [V, ny1, nx1]."""
    samp = max(1, s.patchsize // 2)
    u, v = _patch_pixel_grids_sub(s, samp)
    w, _, _ = _patch_depths_and_derivs_sub(s, samp)
    w = torch.where(s.patch_valid[..., None], w, 1.0)
    basis_f = bicubic.pixel_basis(s.patchsize, samp, dtype=s.nodes.dtype,
                                  device=s.nodes.device)[:, 0, :]
    dparams = (S.patch_params(s2) - S.patch_params(s)).reshape(-1, 16)
    dw = torch.abs(_patch_matmul(s, dparams, basis_f.T)).reshape(
        *s.patch_valid.shape, -1)

    dproj_dw = []
    for n in range(view.M.shape[-3]):
        if s.batched:  # [V, 1, 1, 1, 3, (3)] against [V, ny, nx, P]
            M = view.M[:, n, None, None, None]
            t = view.t[:, n, None, None, None]
        else:
            M, t = view.M[n], view.t[n]
        gd = corr.warp_depth_gradient(M, t, u, v, w)
        dproj_dw.append(torch.sqrt(gd[..., 0] ** 2 + gd[..., 1] ** 2))
    diff = torch.stack(dproj_dw, dim=-1) * dw[..., None]  # [.., P, N]

    corner_active = (act[..., :-1, :-1] | act[..., :-1, 1:]
                     | act[..., 1:, :-1] | act[..., 1:, 1:])
    mask = torch.broadcast_to(
        vis[..., None, :] & corner_active[..., None, None]
        & s.patch_valid[..., None, None], diff.shape)
    diff = torch.where(mask, diff, 0.0)
    maskf = mask.to(diff.dtype)

    def average(dm, m):
        return torch.sum(dm) / torch.clamp(torch.sum(m), min=1.0)

    dm = diff * maskf
    avg = per_view(average, dm, maskf) if s.batched else average(dm, maskf)

    moved = (diff > 0.15).any(dim=-1).any(dim=-1)  # [(V,) ny, nx]
    new_active = torch.zeros_like(s.node_valid)
    new_active[..., :-1, :-1] |= moved
    new_active[..., :-1, 1:] |= moved
    new_active[..., 1:, :-1] |= moved
    new_active[..., 1:, 1:] |= moved
    return avg, new_active & s.node_valid


def _newton_step(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                 active: torch.Tensor, opts: OptimizerOptions,
                 lighting: torch.Tensor | None = None) -> _StepResult:
    """One Newton step: assembly, PCG solve, node update, and the next
    working set (reference inner-loop body, `lib/depth_optimizer.cc:219-304`).
    With a ``lighting`` the system carries the shading term, and the
    multigrid smoother keeps a constant damping (`mg.build`)."""
    s = surf
    act = active & s.node_valid
    gn_opts = gn.GNOptions(
        regularization=opts.regularization,
        light_surf_regularization=opts.light_surf_regularization)
    with span("opt.assemble"):
        g, Hb = gn.assemble(s, view, vis, act, gn_opts, lighting)
    with span("opt.mg_build"):
        if opts.precond == "mg":
            levels = mg.build(Hb, act, damp_rows=lighting is None)
            precond = lambda x: mg.apply(levels, x)  # noqa: E731
        elif opts.precond == "jacobi":
            P = stencil.block_jacobi_inverse(Hb, act)
            precond = lambda x: stencil.apply_block_diag(P, x)  # noqa: E731
        else:
            raise ValueError("precond is 'mg' or 'jacobi', not "
                             f"{opts.precond!r}")
    gnorm = torch.linalg.vector_norm(g.reshape(-1))
    res = cg.solve(lambda x: stencil.spmv(Hb, x), -g, precond=precond,
                   max_iterations=200, error_tolerance=gnorm * 0.01,
                   q_tolerance=1e-3)
    with span("opt.update"):
        delta = torch.movedim(res.x, 0, -1)  # [ny1, nx1, 4]
        bad = ~torch.isfinite(delta).all()
        delta = torch.where(bad, 0.0, delta)

        s2 = S.update_nodes(s, delta)
        avg, new_active = _step_motion(s, s2, view, vis, act)

        f_safe = torch.clamp(torch.abs(s.nodes[..., 0]), min=1e-6)
        rel_step = torch.amax(torch.where(
            s.node_valid, torch.abs(delta[..., 0]) / f_safe, 0.0))
        # One read-back for the loop's scalars (float64 holds each
        # exactly).
        bad_h, avg_h, rel_h, n_act = torch.stack([
            bad.to(torch.float64), avg.to(torch.float64),
            rel_step.to(torch.float64), new_active.sum().to(torch.float64),
        ]).tolist()
        host_reads["newton"] += 1
    real = np.float64 if s.nodes.dtype == torch.float64 else _F32
    return _StepResult(s2.nodes, new_active, bool(bad_h), real(avg_h),
                       real(rel_h), int(n_act), res.iterations)


def _newton_loop(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                 active: torch.Tensor, opts: OptimizerOptions, lighting):
    """Newton inner loop (reference `lib/depth_optimizer.cc:219-304`): up to
    ``max_newton_steps`` while > 5% of nodes are active (in full mode with
    every node active, until the average reprojection delta drops below
    0.01), with the JAX package's convergence, stall and non-finite exits.
    Returns (nodes, active, steps_taken, cg_iters_total)."""
    max_steps = opts.max_newton_steps
    full = opts.full_optimization
    num_initial = int((active & surf.node_valid).sum())
    nodes, active_ = surf.nodes, active
    n_active = int(active_.sum())
    host_reads["active"] += 2
    steps = 0
    done = False
    best_act = num_initial + 1
    best_avg = _F32(np.inf)
    stall = 0
    cg_total = 0
    while steps < max_steps and not done:
        if not (opts.fixed_newton_steps or full) and \
                n_active <= num_initial // 20:
            break
        with span("opt.newton_step"):
            st = _newton_step(dataclasses.replace(surf, nodes=nodes), view,
                              vis, active_, opts, lighting)
        converged = st.rel_step < _F32(1e-4)  # depth changed by < 0.01%
        improved = (st.n_active < best_act) or (st.avg < _F32(0.9) * best_avg)
        stall = 0 if improved else stall + 1
        best_act = min(best_act, st.n_active)
        best_avg = min(best_avg, st.avg)
        stalled = stall >= opts.stall_limit
        floor = _F32(0.01) if full else _F32(0.002)
        done = st.bad or st.avg < floor or converged or stalled
        if opts.fixed_newton_steps:
            done = st.bad
        nodes, n_active = st.nodes, st.n_active
        if not full:  # full mode keeps every node active
            active_ = st.active
        steps += 1
        cg_total += st.cg_iters
    return nodes, active_, steps, cg_total


def _cleanup_view(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                  inv_cal: torch.Tensor, opts: OptimizerOptions,
                  ncc_images: tuple | None):
    """A view's boundary cuts and cleanup after its Newton loop; without
    SGM also the expansion, its visibility and a second cut."""
    surf, vis = cut_boundaries_loop(surf, view, vis, inv_cal)
    if not opts.use_sgm:
        surf = S.expand(surf)
        surf, vis = compute_visibility(surf, view, None, ncc_images)
        surf, vis = cut_boundaries_loop(surf, view, vis, inv_cal)
    surf = S.remove_isolated_patches(surf)
    return surf, vis & surf.patch_valid[..., None]


def scale_program(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                  inv_cal: torch.Tensor, opts: OptimizerOptions, lighting,
                  ncc_images: tuple | None = None):
    """A scale's outer iteration loop (reference `run_newton_iterations`,
    :164-358): Newton inner loop, then boundary cutting and isolated-patch
    cleanup, until the patch count is stable. Without SGM the cleanup also
    expands the surface, recomputes its visibility (with the NCC test on
    ``ncc_images``) and cuts again.
    Returns (surface, stats [[steps, patches, cg_iters] per iteration])."""
    stats = []
    prev_count = int(surf.patch_valid.sum())
    host_reads["patches"] += 1
    for _ in range(opts.num_iterations):
        nodes, _, steps, cg_total = _newton_loop(surf, view, vis,
                                                 surf.node_valid, opts,
                                                 lighting)
        with span("opt.cleanup"):
            surf, vis = _cleanup_view(dataclasses.replace(surf, nodes=nodes),
                                      view, vis, inv_cal, opts, ncc_images)
            new_count = int(surf.patch_valid.sum())
            host_reads["patches"] += 1
        lo = min(new_count, prev_count)
        hi = max(new_count, prev_count, 1)
        change = _F32(1.0) - _F32(lo) / _F32(hi)
        stats.append((steps, new_count, cg_total))
        # Patch-count stability (reference :346-356): stop right after the
        # cleanup of the converged iteration.
        if new_count <= prev_count or change < _F32(0.05 * surf.scale):
            break
        prev_count = new_count
    return surf, stats


def run_newton_iterations(surf: S.Surface, main: StereoViewState,
                          view: gn.ViewSet, opts: OptimizerOptions,
                          sgm_zbuffer: torch.Tensor | None, log=None,
                          sync: torch.device | None = None,
                          lighting: torch.Tensor | None = None,
                          ncc_images: tuple | None = None) -> S.Surface:
    """Reference `DepthOptimizer::run_newton_iterations` (:164-358):
    initial visibility and boundary cutting, then the outer loop.
    ``ncc_images`` (main [H, W], neighbors [N, H, W] at the surface's
    scale) turn on the visibility's NCC test, as the optimizer does
    without SGM. ``sync``: the device each stage waits for at its end."""
    inv_cal = torch.as_tensor(
        main.camera.inverse_calibration(main.width, main.height),
        dtype=torch.float64, device=main.device)
    with timing.stage("opt.visibility", sync, scale=surf.scale):
        surf, vis = compute_visibility(surf, view, sgm_zbuffer, ncc_images)
        surf, vis = cut_boundaries_loop(surf, view, vis, inv_cal)
    surf, stats = scale_program(surf, view, vis, inv_cal, opts, lighting,
                                ncc_images)
    if log:
        for it, (steps, count, cg_total) in enumerate(stats):
            log(f"  iter {it}: {steps} newton steps, {count} patches, "
                f"{cg_total / max(steps, 1):.0f} cg iters/step")
    return surf


# ---------------------------------------------------------------------------
# the same iterations over a batch of views (a leading view axis)
#
# JAX runs these loops under `vmap`: a loop with a per-view predicate runs
# until every view's predicate is false, and each view's state is frozen
# from the step at which its own predicate failed, so each view follows
# the trajectory it takes alone. The port keeps that with per-view masks:
# the Newton step and the PCG carry the view axis (one launch and one
# read-back serve every view), the exit state lives on the host as numpy
# arrays, and a view that is done keeps its nodes whatever the batch
# computes afterwards. Boundary cuts, expansion, visibility and cleanup
# run view by view (`S.over_views`), each as it runs alone.
#
# The step's linear system follows a layout: `WholeGrid` (every view's
# whole node grid, the default) or `dist.viewbatch.RowBands` (each view's
# node rows split over the ranks of a 'patch' group). The surface, the
# visibility and everything after the solve stay whole on every rank;
# the layout gives the band's assembly, preconditioner, stencil product
# and sums, and puts the solution's bands together, so every rank takes
# the same exits.


class WholeGrid:
    """The Newton step's system on each view's whole node grid."""

    def for_rows(self, ny1: int) -> WholeGrid:
        """The layout of a grid of ``ny1`` node rows."""
        return self

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of a whole-grid tensor [..., ny1, nx1] the system
        holds."""
        return t

    def assemble(self, s: S.Surface, view: gn.ViewSet, vis, act, gn_opts,
                 lighting):
        return gn.assemble(s, view, vis, act, gn_opts, lighting)

    def grad_norm(self, g: torch.Tensor) -> torch.Tensor:
        """Each view's ||g|| [V]."""
        return per_view(lambda x: torch.linalg.vector_norm(x.reshape(-1)),
                        g, dim=1)

    def spmv(self, Hb: torch.Tensor):
        return lambda x: stencil.spmv(Hb, x)

    def build_mg(self, Hb: torch.Tensor, act: torch.Tensor,
                 damp_rows: bool) -> mg.Levels:
        return mg.build(Hb, act, damp_rows=damp_rows)

    reduce = None  # `cg.solve_batch`'s ``reduce``

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole grid of a vector [4, V, rows, nx1]."""
        return x


WHOLE_GRID = WholeGrid()


@dataclasses.dataclass
class _BatchStepResult:
    nodes: torch.Tensor  # [V, ny1, nx1, 4]
    active: torch.Tensor  # [V, ny1, nx1]
    bad: np.ndarray  # [V] bool
    avg: np.ndarray  # [V] average reprojection delta, surface dtype
    rel_step: np.ndarray  # [V] largest relative depth step
    n_active: np.ndarray  # [V] int
    cg_iters: np.ndarray  # [V] int


def _newton_step_batch(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                       active: torch.Tensor, opts: OptimizerOptions,
                       lighting: torch.Tensor | None,
                       running: np.ndarray,
                       layout: WholeGrid = WHOLE_GRID) -> _BatchStepResult:
    """`_newton_step` for a batch of views (surface, view, vis [V, ny, nx,
    N], active [V, ny1, nx1], lighting [V, 16]); only the ``running``
    views take part in the PCG. The system is solved in ``layout``; the
    rest of the step runs on the whole grids. One [V, 4] read-back."""
    s = surf
    lay = layout.for_rows(s.nodes.shape[1])
    act = active & s.node_valid
    gn_opts = gn.GNOptions(
        regularization=opts.regularization,
        light_surf_regularization=opts.light_surf_regularization)
    with span("opt.assemble"):
        g, Hb = lay.assemble(s, view, vis, act, gn_opts, lighting)
    with span("opt.mg_build"):
        if opts.precond == "mg":
            levels = lay.build_mg(Hb, lay.rows(act), lighting is None)
            precond = lambda x: mg.apply(levels, x)  # noqa: E731
        elif opts.precond == "jacobi":
            P = stencil.block_jacobi_inverse(Hb, lay.rows(act))
            precond = lambda x: stencil.apply_block_diag(P, x)  # noqa: E731
        else:
            raise ValueError("precond is 'mg' or 'jacobi', not "
                             f"{opts.precond!r}")
    res = cg.solve_batch(lay.spmv(Hb), -g, precond=precond,
                         max_iterations=200,
                         error_tolerance=lay.grad_norm(g) * 0.01,
                         q_tolerance=1e-3, running=running,
                         reduce=lay.reduce)
    with span("opt.update"):
        delta = torch.movedim(lay.gather(res.x), 0, -1)  # [V, ny1, nx1, 4]
        bad = ~torch.isfinite(delta).flatten(1).all(1)
        delta = torch.where(bad[:, None, None, None], 0.0, delta)

        s2 = S.update_nodes(s, delta)
        avg, new_active = _step_motion(s, s2, view, vis, act)

        f_safe = torch.clamp(torch.abs(s.nodes[..., 0]), min=1e-6)
        rel_step = torch.amax(torch.where(
            s.node_valid, torch.abs(delta[..., 0]) / f_safe, 0.0),
            dim=(1, 2))
        host = torch.stack([
            bad.to(torch.float64), avg.to(torch.float64),
            rel_step.to(torch.float64),
            new_active.sum((1, 2)).to(torch.float64),
        ], dim=1).cpu().numpy()  # [V, 4]
        host_reads["newton"] += 1
    real = np.float64 if s.nodes.dtype == torch.float64 else _F32
    return _BatchStepResult(s2.nodes, new_active, host[:, 0] > 0,
                            host[:, 1].astype(real), host[:, 2].astype(real),
                            host[:, 3].astype(np.int64), res.iterations)


def _newton_loop_batch(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                       active: torch.Tensor, opts: OptimizerOptions,
                       lighting, alive: np.ndarray,
                       layout: WholeGrid = WHOLE_GRID):
    """`_newton_loop` for a batch of views: each ``alive`` view runs its
    own loop, with its own exits, in one batched step per iteration;
    the others keep their nodes and take no step. Returns (nodes, active,
    steps [V], cg_iters_total [V])."""
    V = surf.nodes.shape[0]
    max_steps = opts.max_newton_steps
    full = opts.full_optimization
    counts = torch.stack([(active & surf.node_valid).sum((1, 2)),
                          active.sum((1, 2))]).cpu().numpy()
    host_reads["active"] += 1
    num_initial, n_active = counts[0].astype(np.int64), counts[1]
    nodes, active_ = surf.nodes, active
    steps = np.zeros(V, np.int64)
    cg_total = np.zeros(V, np.int64)
    done = ~np.asarray(alive, bool)
    best_act = num_initial + 1
    best_avg = np.full(V, np.inf, _F32)
    stall = np.zeros(V, np.int64)
    floor = _F32(0.01) if full else _F32(0.002)
    dev = surf.nodes.device
    while True:
        done |= steps >= max_steps
        if not (opts.fixed_newton_steps or full):
            done |= n_active <= num_initial // 20
        if done.all():
            break
        run = ~done
        with span("opt.newton_step"):
            st = _newton_step_batch(dataclasses.replace(surf, nodes=nodes),
                                    view, vis, active_, opts, lighting, run,
                                    layout)
        converged = st.rel_step < _F32(1e-4)
        improved = (st.n_active < best_act) | (st.avg < _F32(0.9) * best_avg)
        stall = np.where(run, np.where(improved, 0, stall + 1), stall)
        best_act = np.where(run, np.minimum(best_act, st.n_active), best_act)
        best_avg = np.where(run, np.minimum(best_avg, st.avg), best_avg)
        if opts.fixed_newton_steps:
            finished = st.bad
        else:
            finished = (st.bad | (st.avg < floor) | converged
                        | (stall >= opts.stall_limit))
        run_t = torch.as_tensor(run, device=dev)
        nodes = torch.where(run_t[:, None, None, None], st.nodes, nodes)
        if not full:  # full mode keeps every node active
            active_ = torch.where(run_t[:, None, None], st.active, active_)
        n_active = np.where(run, st.n_active, n_active)
        steps += run
        cg_total += np.where(run, st.cg_iters, 0)
        done |= run & finished
    return nodes, active_, steps, cg_total


def scale_program_batch(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                        inv_cals: list, opts: OptimizerOptions, lighting,
                        ncc_images: list | None = None,
                        layout: WholeGrid = WHOLE_GRID):
    """`scale_program` for a batch of views (``inv_cals`` and
    ``ncc_images`` one per view): each view leaves the outer loop at its
    own patch-count test, after which it keeps its surface. Returns
    (surface, stats per view)."""
    V = surf.nodes.shape[0]
    stats = [[] for _ in range(V)]
    prev = surf.patch_valid.sum((1, 2)).cpu().numpy().astype(np.int64)
    host_reads["patches"] += 1
    alive = np.ones(V, bool)
    for _ in range(opts.num_iterations):
        nodes, _, steps, cg_total = _newton_loop_batch(
            surf, view, vis, surf.node_valid, opts, lighting, alive, layout)
        with span("opt.cleanup"):
            surf = dataclasses.replace(surf, nodes=nodes)
            surfs = [S.unstack_surface(surf, i) for i in range(V)]
            viss = list(vis)
            for i in np.flatnonzero(alive):
                surfs[i], viss[i] = _cleanup_view(
                    surfs[i], gn.viewset_at(view, i), viss[i], inv_cals[i],
                    opts, None if ncc_images is None else ncc_images[i])
                new_count = int(surfs[i].patch_valid.sum())
                host_reads["patches"] += 1
                lo = min(new_count, prev[i])
                hi = max(new_count, prev[i], 1)
                change = _F32(1.0) - _F32(lo) / _F32(hi)
                stats[i].append((int(steps[i]), new_count, int(cg_total[i])))
                if new_count <= prev[i] or change < _F32(0.05 * surf.scale):
                    alive[i] = False
                else:
                    prev[i] = new_count
            surf = S.stack_surfaces(surfs)
            vis = torch.stack(viss)
        if not alive.any():
            break
    return surf, stats


def run_newton_iterations_batch(surf: S.Surface, mains: list,
                                view: gn.ViewSet, opts: OptimizerOptions,
                                sgm_zbuffers: list | None, log=None,
                                sync: torch.device | None = None,
                                lighting: torch.Tensor | None = None,
                                ncc_images: list | None = None,
                                layout: WholeGrid = WHOLE_GRID
                                ) -> S.Surface:
    """`run_newton_iterations` for a batch of views: visibility and the
    first boundary cuts view by view, then `scale_program_batch`, its
    Newton systems solved in ``layout``; ``sync`` as there."""
    V = surf.nodes.shape[0]
    inv_cals = [torch.as_tensor(
        m.camera.inverse_calibration(m.width, m.height),
        dtype=torch.float64, device=m.device) for m in mains]
    with timing.stage("opt.visibility", sync, scale=surf.scale):
        surfs, viss = [], []
        for i in range(V):
            vi = gn.viewset_at(view, i)
            si, visi = compute_visibility(
                S.unstack_surface(surf, i), vi,
                None if sgm_zbuffers is None else sgm_zbuffers[i],
                None if ncc_images is None else ncc_images[i])
            si, visi = cut_boundaries_loop(si, vi, visi, inv_cals[i])
            surfs.append(si)
            viss.append(visi)
        surf, vis = S.stack_surfaces(surfs), torch.stack(viss)
    surf, stats = scale_program_batch(surf, view, vis, inv_cals, opts,
                                      lighting, ncc_images, layout)
    if log:
        for i, rows in enumerate(stats):
            log(f"  view {mains[i].view_id} s{surf.scale}: " + " ".join(
                f"{st}st/{cg}cg" for st, _, cg in rows)
                + f" -> {rows[-1][1] if rows else 0} patches")
    return surf


# ---------------------------------------------------------------------------
# top-level per-view optimization


@dataclasses.dataclass
class DepthResult:
    depth: torch.Tensor  # [H, W] z-depth, 0 = unreconstructed
    normals: torch.Tensor  # [H, W, 3]
    surface: S.Surface
    lighting: torch.Tensor | None = None  # [16] SH, the last scale's fit


def optimize_view(main: StereoViewState, subs: list[StereoViewState],
                  opts: OptimizerOptions, sgm_depth=None,
                  device: str | torch.device | None = None,
                  log=None, init_depth=None, init_surface=None,
                  debug_sink=None) -> DepthResult:
    """Coarse-to-fine optimization of one view (reference
    `DepthOptimizer::optimize`, `lib/depth_optimizer.cc:53-162`).

    Runs on ``device`` (the GPU unless ``"cpu"`` is passed), where the
    views must live. With ``opts.use_sgm`` it starts from ``sgm_depth``
    [H, W], the SGM z-depth map (bilateral-filtered, which also feeds the
    visibility z-buffer); without, from ``init_depth`` [H, W], a sparse
    z-depth prior (the bundle's feature splats), a scale coarser. An
    ``init_surface`` (a `Surface`, e.g. `S.create_planar`) is the
    starting surface instead, and subdivision then fills no patch from a
    depth map.

    With ``opts.debug_lvl`` above 1, ``debug_sink(name, image)`` receives
    the debug images the JAX package writes: "smvs-sgm-filtered",
    "smvs-initial" and, under shading, "smvs-shaded",
    "smvs-shaded-sphere" and "smvs-implicit-albedo".
    """
    dev = resolve_device(device)
    for v in [main, *subs]:
        if v.device != dev:
            raise ValueError(f"view {v.view_id} lives on {v.device}, "
                             f"not on {dev}")
    # Under -d 1 and above the stage report reads the call's spans.
    with timing.recording(log is not None) as spans, span("opt.view"):
        result = _optimize_view(main, subs, opts, sgm_depth, dev, log,
                                init_depth, init_surface, debug_sink)
    if log:
        log(timing.report(spans))
    return result


def _optimize_view(main, subs, opts, sgm_depth, dev, log, init_depth,
                   init_surface, debug_sink) -> DepthResult:
    """`optimize_view`'s body on its resolved device."""
    if debug_sink is None or opts.debug_lvl <= 1:
        debug_sink = lambda name, img: None  # noqa: E731
    dtype = torch.float32
    scale0 = initial_scale(main.width, main.height)
    if init_surface is not None:
        surf = init_surface
        fill_src = None
        # the SGM z-buffer, if any, from the unfiltered map
        zb_src = None if sgm_depth is None else \
            torch.as_tensor(sgm_depth, device=dev).to(dtype)
    elif opts.use_sgm:
        if sgm_depth is None:
            raise ValueError("use_sgm needs an sgm_depth")
        sgm = torch.as_tensor(sgm_depth, device=dev).to(dtype)
        fill_src = bilateral.depthmap_bilateral_filter(sgm,
                                                       main.image.to(dtype))
        zb_src = fill_src
        surf = S.create_from_depth(fill_src, scale0)
        debug_sink("smvs-sgm-filtered", fill_src)
    else:
        if init_depth is None:
            raise ValueError("without use_sgm the optimizer needs an "
                             "init_depth")
        fill_src = torch.as_tensor(init_depth, device=dev).to(dtype)
        surf = S.create_from_depth(fill_src, scale0 + 1)
    sync = dev if opts.debug_lvl >= 2 else None
    sgm_zb = None
    lighting = None

    def run_scale(surf):
        nonlocal sgm_zb, lighting
        if log:
            log(f"### scale {surf.scale}: {surf.num_valid_patches()} patches")
        with timing.stage("opt.viewset", sync, scale=surf.scale):
            view = _build_viewset(main, subs, surf.scale, surf.nodes.dtype,
                                  bf16_gather=opts.bf16_gather,
                                  use_shading=opts.use_shading)
        ncc_images = None
        if not opts.use_sgm:
            ncc_images = (main.at_scale(surf.scale).image, torch.stack(
                [s.at_scale(surf.scale).image for s in subs]))
        elif sgm_zb is None and zb_src is not None:
            # Scale-invariant (blur keeps resolution and the reprojections
            # fixed): scatter the SGM z-buffer once per view.
            sgm_zb = zbuffer_scatter(view, zb_src)
        if opts.use_shading and surf.scale < 4:
            # Refit the lighting to this scale's (subdivided) surface; the
            # coarser scales run without the shading term.
            with timing.stage("opt.lighting", sync, scale=surf.scale,
                              views=1):
                shading_img, _ = main.shading_images()
                nmap = S.normal_map(surf, 1.0 / main.flen())
                lighting = fit_lighting(nmap,
                                        shading_img.to(surf.nodes.dtype))
        return run_newton_iterations(surf, main, view, opts, sgm_zb,
                                     log=log, sync=sync, lighting=lighting,
                                     ncc_images=ncc_images)

    debug_sink("smvs-initial", S.depth_map(surf))
    with timing.stage("opt.scale", sync, scale=surf.scale):
        surf = run_scale(surf)
    while surf.scale > opts.min_scale and surf.scale > 0:
        with timing.stage("opt.subdivide", sync, scale=surf.scale):
            surf = S.subdivide(surf)
            if fill_src is not None:
                surf = S.fill_patches_from_depth(surf, fill_src)
        with timing.stage("opt.scale", sync, scale=surf.scale):
            surf = run_scale(surf)

    with timing.stage("opt.extract", sync):
        depth = S.depth_map(surf)
        normals = S.normal_map(surf, 1.0 / main.flen())
    if lighting is not None:
        shaded = L.render_normal_map(lighting, normals)
        debug_sink("smvs-shaded", shaded)
        debug_sink("smvs-shaded-sphere", render_lighting_sphere(lighting))
        shading_img, _ = main.shading_images()
        debug_sink("smvs-implicit-albedo", torch.where(
            shaded > 0, shading_img.to(shaded.dtype)
            / torch.clamp(shaded, min=1e-6), 0.0))
    return DepthResult(depth=depth, normals=normals, surface=surf,
                       lighting=lighting)


def render_lighting_sphere(params: torch.Tensor, size: int = 555
                           ) -> torch.Tensor:
    """The lighting rendered on a unit sphere seen head-on, a debug image
    (reference `GlobalLighting::get_rendered_sphere`,
    `lib/global_lighting.cc:48-75`)."""
    t = (torch.arange(size, dtype=params.dtype, device=params.device)
         + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    r2 = u * u + v * v
    nz = torch.sqrt(torch.clamp(1.0 - r2, min=0.0))
    val = L.value_for_normal(params, torch.stack([u, v, -nz], dim=-1))
    return torch.where(r2 <= 1.0, val, 0.0)
