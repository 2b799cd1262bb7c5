"""View batching for the per-view pipeline: a frozen copy of the port's
`pipeline/batch.py` on one card (its path over a mesh of ranks left out).

Views are grouped into buckets keyed by (height, width, n_neighbors), so
that every view of a batch shares every shape; the view axis is carried
through the Newton loop and the PCG (`optimizer._newton_loop_batch`,
`cg.solve_batch`). Each view still follows the trajectory it takes alone.
"""

from __future__ import annotations

from typing import Sequence

import torch

from benchmarks.reference.opt.device import resolve_device
from benchmarks.reference.opt.image import bilateral
from benchmarks.reference.opt.pipeline import optimizer as O
from benchmarks.reference.opt.pipeline.views import StereoViewState
from benchmarks.reference.opt.shading.lighting import fit_lighting
from benchmarks.reference.opt.solver import gn
from benchmarks.reference.opt.surface import state as S
from benchmarks.reference.opt.utils.timing import StageTimer


def bucket_key(main: StereoViewState, subs: Sequence[StereoViewState]):
    """Views with equal keys share every shape of the pipeline."""
    return (main.height, main.width, len(subs))


def optimize_view_batch(
    mains: Sequence[StereoViewState],
    subs_list: Sequence[Sequence[StereoViewState]],
    opts: O.OptimizerOptions,
    sgm_depths: Sequence | None = None,
    init_depths: Sequence | None = None,
    log=None,
    device: str | torch.device | None = None,
) -> list[O.DepthResult]:
    """Batched counterpart of :func:`optimizer.optimize_view`: the same
    coarse-to-fine pipeline over views that share a bucket key, returning
    one DepthResult per view, each what `optimize_view` returns for it.

    With ``opts.use_sgm`` each view starts from its ``sgm_depths`` entry
    (bilateral-filtered), else from its ``init_depths`` entry, a scale
    coarser, as `optimize_view` does. Runs on ``device`` (the GPU unless
    ``"cpu"`` is passed), where the views must live.
    """
    V = len(mains)
    if len(subs_list) != V or V == 0:
        raise ValueError("one list of neighbors per main view")
    return _optimize_batch(mains, subs_list, opts, sgm_depths, init_depths,
                           log, device, O.WHOLE_GRID)


def _optimize_batch(mains, subs_list, opts, sgm_depths, init_depths, log,
                    device, layout) -> list[O.DepthResult]:
    """`optimize_view_batch`, its Newton systems solved in ``layout``."""
    V = len(mains)
    keys = {bucket_key(m, s) for m, s in zip(mains, subs_list)}
    if len(keys) != 1:
        raise ValueError(f"views of several buckets in one batch: {keys}")
    dev = resolve_device(device)
    for v in [*mains, *(s for subs in subs_list for s in subs)]:
        if v.device != dev:
            raise ValueError(f"view {v.view_id} lives on {v.device}, "
                             f"not on {dev}")
    dtype = torch.float32
    scale0 = O.initial_scale(mains[0].width, mains[0].height)

    # Initial surfaces (reference `lib/depth_optimizer.cc:36-51`).
    fill_srcs, surfs = [], []
    for i, m in enumerate(mains):
        if opts.use_sgm:
            if sgm_depths is None:
                raise ValueError("use_sgm needs sgm_depths")
            sgm = torch.as_tensor(sgm_depths[i], device=dev).to(dtype)
            src = bilateral.depthmap_bilateral_filter(sgm, m.image.to(dtype))
            surfs.append(S.create_from_depth(src, scale0))
        else:
            if init_depths is None:
                raise ValueError("without use_sgm the optimizer needs "
                                 "init_depths")
            src = torch.as_tensor(init_depths[i], device=dev).to(dtype)
            surfs.append(S.create_from_depth(src, scale0 + 1))
        fill_srcs.append(src)
    bsurf = S.stack_surfaces(surfs)
    layout.for_rows(bsurf.nodes.shape[1])  # a grid too small raises here
    bfill = torch.stack(fill_srcs)
    inv_flens = [1.0 / m.flen() for m in mains]
    timer = StageTimer(sync_device=dev if opts.debug_lvl >= 2 else None)
    sgm_zbs = None
    lighting = None

    def run_scale(bsurf):
        nonlocal sgm_zbs, lighting
        scale = bsurf.scale
        if log:
            log(f"### batch of {V}: scale {scale}: "
                f"{bsurf.patch_valid.sum((1, 2)).tolist()} patches")
        with timer.stage(f"viewset@s{scale}"):
            views = [O._build_viewset(m, list(subs), scale, dtype,
                                      bf16_gather=opts.bf16_gather,
                                      use_shading=opts.use_shading)
                     for m, subs in zip(mains, subs_list)]
        ncc_images = None
        if not opts.use_sgm:
            ncc_images = [(m.at_scale(scale).image, torch.stack(
                [s.at_scale(scale).image for s in subs]))
                for m, subs in zip(mains, subs_list)]
        elif sgm_zbs is None:  # scale-invariant: once per view
            sgm_zbs = [O.zbuffer_scatter(v, src)
                       for v, src in zip(views, fill_srcs)]
        if opts.use_shading and scale < 4:
            with timer.stage(f"lighting@s{scale}"):
                shading = torch.stack([m.shading_images()[0].to(dtype)
                                       for m in mains])
                lighting = fit_lighting(S.normal_map(bsurf, inv_flens),
                                        shading)
        return O.run_newton_iterations_batch(
            bsurf, list(mains), gn.stack_viewsets(views), opts, sgm_zbs,
            log=log, timer=timer, lighting=lighting, ncc_images=ncc_images,
            layout=layout)

    bsurf = run_scale(bsurf)
    while bsurf.scale > opts.min_scale and bsurf.scale > 0:
        with timer.stage(f"subdivide@s{bsurf.scale}"):
            bsurf = S.subdivide(bsurf)
            bsurf = S.fill_patches_from_depth(bsurf, bfill)
        bsurf = run_scale(bsurf)

    with timer.stage("extract"):
        depth = S.depth_map(bsurf)
        normals = S.normal_map(bsurf, inv_flens)
    if log:
        log(timer.report())
    return [O.DepthResult(depth=depth[i], normals=normals[i],
                          surface=S.unstack_surface(bsurf, i),
                          lighting=None if lighting is None else lighting[i])
            for i in range(V)]


def group_views(ids: Sequence[int], key: tuple, batch_views: int,
                batch_mp: float) -> list[list[int]]:
    """Split a bucket's views into groups of at most ``batch_views``, and
    at most ``batch_mp`` working megapixels in all (the JAX CLI's cap;
    key = (height, width, n_neighbors))."""
    mp = key[0] * key[1] / 1e6
    fit = max(1, int(batch_mp // mp))
    size = max(1, min(batch_views, fit))
    return [list(ids[lo:lo + size]) for lo in range(0, len(ids), size)]
