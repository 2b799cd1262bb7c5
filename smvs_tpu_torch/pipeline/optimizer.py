"""Per-view coarse-to-fine depth optimization controller, base mode
(port of `smvs_tpu/pipeline/optimizer.py`, reference `lib/depth_optimizer.cc`).

The scale loop, Newton iterations with a reprojection-delta working set,
visibility and boundary cutting run as tensor programs on the view's
device; host loops replace JAX's `lax.while_loop`s with the same exit
rules, reading a few scalars back per iteration. The optimizer runs in
float32 with the bf16 x-paired assembly gather, like the JAX package.

Ported: the SGM-initialized base mode (`use_sgm=True`, one or more
neighbors). Shading (`use_shading`) and the sparse-prior mode (which
needs `Surface.expand`) raise NotImplementedError.
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
from smvs_tpu_torch.solver import cg, gn, mg, stencil
from smvs_tpu_torch.surface import bicubic
from smvs_tpu_torch.surface import state as S
from smvs_tpu_torch.utils.timing import StageTimer

_F32 = np.float32  # host-side scalar tests round like the device's float32


@dataclasses.dataclass(frozen=True)
class OptimizerOptions:
    """The fields of `DepthOptimizer::Options` (reference
    `lib/depth_optimizer.h:30-42`) that the ported base mode reads, plus
    the JAX package's Newton-step knobs. The CG solve is always
    preconditioned by the multigrid V-cycle, and the assembly always uses
    the bf16 x-paired gather."""

    regularization: float = 0.001
    num_iterations: int = 10
    min_scale: int = 1
    use_shading: bool = False
    use_sgm: bool = False
    debug_lvl: int = 0
    max_newton_steps: int = 200
    # Run exactly max_newton_steps per inner loop (equality harnesses).
    fixed_newton_steps: bool = False


# Newton steps without active-set or reprojection-delta improvement before
# the inner loop exits (the JAX package's default).
_STALL_LIMIT = 8


def initial_scale(width: int, height: int) -> int:
    """Reference `lib/depth_optimizer.cc:37-39`."""
    return int(max(np.ceil(np.log2(width * height / 1.7e6) / 2) + 4, 4))


def _build_viewset(main: StereoViewState, subs: list[StereoViewState],
                   scale: int, dtype, bf16_gather: bool = False
                   ) -> gn.ViewSet:
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
    return gn.ViewSet(
        grad_main=mi.grad.to(dtype),
        sub_gh=sub_gh,
        M=torch.as_tensor(np.stack(Ms), dtype=dtype, device=dev),
        t=torch.as_tensor(np.stack(ts), dtype=dtype, device=dev),
        flen=torch.as_tensor(main.flen(), dtype=dtype, device=dev),
    )


# ---------------------------------------------------------------------------
# geometry helpers on the patch grid


def _patch_pixel_grids_sub(surf: S.Surface, sampling: int = 1):
    """Pixel centers (u, v) per patch, each [ny, nx, P]."""
    px, py = gn._patch_pixel_coords(surf, sampling=sampling)
    return px + 0.5, py + 0.5


def _patch_depths_and_derivs_sub(surf: S.Surface, sampling: int = 1):
    """(w, wdx, wdy) per (subsampled) patch pixel, each [ny, nx, P]."""
    ny, nx = surf.num_patches_y, surf.num_patches_x
    basis = bicubic.pixel_basis(surf.patchsize, sampling,
                                dtype=surf.nodes.dtype,
                                device=surf.nodes.device)
    b2 = basis[:, :3, :].reshape(-1, 16)  # [P*3, 16]
    params = S.patch_params(surf).reshape(ny * nx, 16)
    vals = (params @ b2.T).reshape(ny, nx, -1, 3)
    return vals[..., 0], vals[..., 1], vals[..., 2]


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
                       sgm_zbuffer: torch.Tensor | None
                       ) -> tuple[S.Surface, torch.Tensor]:
    """Per-(patch, neighbor) visibility; deletes patches visible nowhere
    (reference `lib/depth_optimizer.cc:433-604`): z-buffer with 0.95
    tolerance and the warp-anisotropy test (sigma ratio <= 8). The NCC
    occlusion test of the JAX package applies only without SGM, which
    this port does not run. ``sgm_zbuffer`` is `zbuffer_scatter` of the
    SGM depth. Returns (surface, vis [ny, nx, N])."""
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
        vis.append(in_bounds & ~occluded & aniso)
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
        gs = iops.sample_gradient_packed(view.sub_gh[n], proj[..., 0] - 0.5,
                                         proj[..., 1] - 0.5)
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


def _newton_step(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                 active: torch.Tensor, opts: OptimizerOptions) -> _StepResult:
    """One Newton step: assembly, PCG solve, node update, and the next
    working set (reference inner-loop body, `lib/depth_optimizer.cc:219-304`)."""
    s = surf
    act = active & s.node_valid
    g, Hb = gn.assemble(s, view, vis, act,
                        gn.GNOptions(regularization=opts.regularization))
    levels = mg.build(Hb, act)
    gnorm = torch.linalg.vector_norm(g.reshape(-1))
    res = cg.solve(lambda x: stencil.spmv(Hb, x), -g,
                   precond=lambda x: mg.apply(levels, x),
                   max_iterations=200, error_tolerance=gnorm * 0.01,
                   q_tolerance=1e-3)
    delta = torch.movedim(res.x, 0, -1)  # [ny1, nx1, 4]
    bad = ~torch.isfinite(delta).all()
    delta = torch.where(bad, 0.0, delta)

    # Reprojection delta of the step, first order |dproj/dw| * |dw|, on a
    # 2x2 pixel subsample per patch.
    s2 = S.update_nodes(s, delta)
    ny, nx = s.num_patches_y, s.num_patches_x
    samp = max(1, s.patchsize // 2)
    u, v = _patch_pixel_grids_sub(s, samp)
    w, _, _ = _patch_depths_and_derivs_sub(s, samp)
    w = torch.where(s.patch_valid[..., None], w, 1.0)
    basis_f = bicubic.pixel_basis(s.patchsize, samp, dtype=s.nodes.dtype,
                                  device=s.nodes.device)[:, 0, :]
    dparams = (S.patch_params(s2) - S.patch_params(s)).reshape(ny * nx, 16)
    dw = torch.abs(dparams @ basis_f.T).reshape(ny, nx, -1)  # [ny, nx, P]

    dproj_dw = []
    for n in range(view.M.shape[0]):
        gd = corr.warp_depth_gradient(view.M[n], view.t[n], u, v, w)
        dproj_dw.append(torch.sqrt(gd[..., 0] ** 2 + gd[..., 1] ** 2))
    diff = torch.stack(dproj_dw, dim=-1) * dw[..., None]  # [ny, nx, P, N]

    corner_active = (act[:-1, :-1] | act[:-1, 1:]
                     | act[1:, :-1] | act[1:, 1:])
    mask = torch.broadcast_to(
        vis[:, :, None, :] & corner_active[:, :, None, None]
        & s.patch_valid[:, :, None, None], diff.shape)
    diff = torch.where(mask, diff, 0.0)
    maskf = mask.to(diff.dtype)
    avg = torch.sum(diff * maskf) / torch.clamp(torch.sum(maskf), min=1.0)

    moved = (diff > 0.15).any(dim=-1).any(dim=-1)  # [ny, nx]
    new_active = torch.zeros_like(s.node_valid)
    new_active[:-1, :-1] |= moved
    new_active[:-1, 1:] |= moved
    new_active[1:, :-1] |= moved
    new_active[1:, 1:] |= moved
    new_active = new_active & s.node_valid

    f_safe = torch.clamp(torch.abs(s.nodes[..., 0]), min=1e-6)
    rel_step = torch.amax(torch.where(s.node_valid,
                                      torch.abs(delta[..., 0]) / f_safe, 0.0))
    # One read-back for the loop's scalars (float64 holds each exactly).
    bad_h, avg_h, rel_h, n_act = torch.stack([
        bad.to(torch.float64), avg.to(torch.float64),
        rel_step.to(torch.float64), new_active.sum().to(torch.float64),
    ]).tolist()
    real = np.float64 if s.nodes.dtype == torch.float64 else _F32
    return _StepResult(s2.nodes, new_active, bool(bad_h), real(avg_h),
                       real(rel_h), int(n_act), res.iterations)


def _newton_loop(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                 active: torch.Tensor, opts: OptimizerOptions):
    """Newton inner loop (reference `lib/depth_optimizer.cc:219-304`): up to
    ``max_newton_steps`` while > 5% of nodes are active, with the JAX
    package's convergence, stall and non-finite exits.
    Returns (nodes, active, steps_taken, cg_iters_total)."""
    max_steps = opts.max_newton_steps
    num_initial = int((active & surf.node_valid).sum())
    nodes, active_ = surf.nodes, active
    n_active = int(active_.sum())
    steps = 0
    done = False
    best_act = num_initial + 1
    best_avg = _F32(np.inf)
    stall = 0
    cg_total = 0
    while steps < max_steps and not done:
        if not opts.fixed_newton_steps and n_active <= num_initial // 20:
            break
        st = _newton_step(dataclasses.replace(surf, nodes=nodes), view, vis,
                          active_, opts)
        converged = st.rel_step < _F32(1e-4)  # depth changed by < 0.01%
        improved = (st.n_active < best_act) or (st.avg < _F32(0.9) * best_avg)
        stall = 0 if improved else stall + 1
        best_act = min(best_act, st.n_active)
        best_avg = min(best_avg, st.avg)
        stalled = stall >= _STALL_LIMIT
        done = st.bad or st.avg < _F32(0.002) or converged or stalled
        if opts.fixed_newton_steps:
            done = st.bad
        nodes, active_, n_active = st.nodes, st.active, st.n_active
        steps += 1
        cg_total += st.cg_iters
    return nodes, active_, steps, cg_total


def scale_program(surf: S.Surface, view: gn.ViewSet, vis: torch.Tensor,
                  inv_cal: torch.Tensor, opts: OptimizerOptions):
    """A scale's outer iteration loop (reference `run_newton_iterations`,
    :164-358): Newton inner loop, then boundary cutting and isolated-patch
    cleanup, until the patch count is stable.
    Returns (surface, stats [[steps, patches, cg_iters] per iteration])."""
    stats = []
    prev_count = int(surf.patch_valid.sum())
    for _ in range(opts.num_iterations):
        nodes, _, steps, cg_total = _newton_loop(surf, view, vis,
                                                 surf.node_valid, opts)
        surf = dataclasses.replace(surf, nodes=nodes)
        surf, vis = cut_boundaries_loop(surf, view, vis, inv_cal)
        surf = S.remove_isolated_patches(surf)
        vis = vis & surf.patch_valid[..., None]
        new_count = int(surf.patch_valid.sum())
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
                          timer: StageTimer | None = None) -> S.Surface:
    """Reference `DepthOptimizer::run_newton_iterations` (:164-358):
    initial visibility and boundary cutting, then the outer loop."""
    inv_cal = torch.as_tensor(
        main.camera.inverse_calibration(main.width, main.height),
        dtype=torch.float64, device=main.device)
    timer = timer or StageTimer()
    with timer.stage(f"visibility@s{surf.scale}"):
        surf, vis = compute_visibility(surf, view, sgm_zbuffer)
        surf, vis = cut_boundaries_loop(surf, view, vis, inv_cal)
    with timer.stage(f"iterations@s{surf.scale}"):
        surf, stats = scale_program(surf, view, vis, inv_cal, opts)
    if log:
        for it, (steps, count, cg_total) in enumerate(stats):
            log(f"  iter {it}: {steps} newton steps, {count} patches, "
                f"{cg_total / max(steps, 1):.0f} cg iters/step")
    return surf


# ---------------------------------------------------------------------------
# top-level per-view optimization


@dataclasses.dataclass
class DepthResult:
    depth: torch.Tensor  # [H, W] z-depth, 0 = unreconstructed
    normals: torch.Tensor  # [H, W, 3]
    surface: S.Surface


def optimize_view(main: StereoViewState, subs: list[StereoViewState],
                  opts: OptimizerOptions, sgm_depth,
                  device: str | torch.device | None = None,
                  log=None) -> DepthResult:
    """Coarse-to-fine optimization of one view from its SGM depth
    (reference `DepthOptimizer::optimize`, `lib/depth_optimizer.cc:53-162`).

    Runs on ``device`` (the GPU unless ``"cpu"`` is passed), where the
    views must live. ``sgm_depth`` [H, W] is the SGM z-depth map.
    """
    dev = resolve_device(device)
    if opts.use_shading:
        raise NotImplementedError(
            "shading-aware optimization is not ported yet (ROADMAP.md)")
    if not opts.use_sgm:
        raise NotImplementedError(
            "optimization from a sparse depth prior needs Surface.expand, "
            "which is not ported yet (ROADMAP.md)")
    for v in [main, *subs]:
        if v.device != dev:
            raise ValueError(f"view {v.view_id} lives on {v.device}, "
                             f"not on {dev}")
    dtype = torch.float32
    sgm = torch.as_tensor(sgm_depth, device=dev).to(dtype)
    filt = bilateral.depthmap_bilateral_filter(sgm, main.image.to(dtype))
    surf = S.create_from_depth(filt, initial_scale(main.width, main.height))
    timer = StageTimer(sync_device=dev if opts.debug_lvl >= 2 else None)
    sgm_zb = None

    def run_scale(surf):
        nonlocal sgm_zb
        if log:
            log(f"### scale {surf.scale}: {surf.num_valid_patches()} patches")
        with timer.stage(f"viewset@s{surf.scale}"):
            view = _build_viewset(main, subs, surf.scale, surf.nodes.dtype,
                                  bf16_gather=True)
        if sgm_zb is None:
            # Scale-invariant (blur keeps resolution and the reprojections
            # fixed): scatter the SGM z-buffer once per view.
            sgm_zb = zbuffer_scatter(view, filt)
        return run_newton_iterations(surf, main, view, opts, sgm_zb,
                                     log=log, timer=timer)

    surf = run_scale(surf)
    while surf.scale > opts.min_scale and surf.scale > 0:
        with timer.stage(f"subdivide@s{surf.scale}"):
            surf = S.subdivide(surf)
            surf = S.fill_patches_from_depth(surf, filt)
        surf = run_scale(surf)

    with timer.stage("extract"):
        depth = S.depth_map(surf)
        normals = S.normal_map(surf, 1.0 / main.flen())
    if log:
        log(timer.report())
    return DepthResult(depth=depth, normals=normals, surface=surf)
