"""View batching for the per-view pipeline (port of
`smvs_tpu/pipeline/batch.py`).

The reference's parallelism is one thread-pool task per view
(`app/smvsrecon.cc:558, 652-735`). The JAX package stacks views of one
shape on a leading axis and runs its per-scale programs under `vmap`;
the port carries the same view axis through the Newton loop and the PCG
(`optimizer._newton_loop_batch`, `cg.solve_batch`), where the launches
and the host read-backs are: one launch and one read-back serve every
view of a batch. Each view still follows the trajectory it takes alone.

Views are grouped into buckets keyed by (height, width, n_neighbors), so
that every view of a batch shares every shape. The JAX module's
`prewarm_async` has no counterpart (it loads XLA's compiled programs in
the background; eager PyTorch compiles nothing, and the CUDA kernels are
built at their first use).

Over a ('views', 'patch') mesh of ranks (`make_view_mesh`) each
``views`` row optimizes its share of the views (`dist.mesh.view_share`)
and then receives every other view's result from the first rank of the
row that computed it. A view's result does not depend on the views
batched with it, so with a ``patch`` axis of 1 the results are the
unsharded batch's bit for bit.

With a ``patch`` axis above 1 the ranks of a row split each view's node
rows (`dist.mesh.row_band`) in the Newton step's linear system
(`dist.viewbatch.RowBands`): each assembles, preconditions (the band
multigrid) and solves its band, with one row of halo from its
neighbors and the PCG's sums over the row, and the solution's bands are
gathered whole after the solve. Everything else (the surface, the
visibility and its z-buffer, the boundary cuts and cleanup, subdivision,
the lighting fit, the extraction and every exit test) runs on the whole
grid, the same on every rank of the row, as XLA runs a scatter it cannot
partition. The PCG's sums then add band by band, so the results are not
the unsharded batch's bit for bit (`dist.dryrun` holds them to the JAX
dry run's bars).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.dist.mesh import make_mesh as make_view_mesh  # noqa: F401
from smvs_tpu_torch.dist.mesh import check_mesh, split, view_share
from smvs_tpu_torch.dist.viewbatch import RowBands
from smvs_tpu_torch.image import bilateral
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.pipeline.views import StereoViewState
from smvs_tpu_torch.shading.lighting import fit_lighting
from smvs_tpu_torch.solver import gn
from smvs_tpu_torch.surface import state as S
from smvs_tpu_torch.utils import timing


def bucket_key(main: StereoViewState, subs: Sequence[StereoViewState]):
    """Views with equal keys share every shape of the pipeline."""
    return (main.height, main.width, len(subs))


def optimize_view_batch(
    mains: Sequence[StereoViewState],
    subs_list: Sequence[Sequence[StereoViewState]],
    opts: O.OptimizerOptions,
    sgm_depths: Sequence | None = None,
    init_depths: Sequence | None = None,
    mesh=None,
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

    With ``mesh`` (`make_view_mesh`) every rank passes every view and
    gets every view's result: its ``views`` row optimizes a share of them,
    with each view's node rows split over the row's ranks when the
    ``patch`` axis is above 1, and it receives the others from their
    rows. A view whose grid at its first (coarsest) scale has fewer node
    rows than the ``patch`` axis raises `ValueError`.
    """
    V = len(mains)
    if len(subs_list) != V or V == 0:
        raise ValueError("one list of neighbors per main view")
    if mesh is None:
        return _optimize_batch(mains, subs_list, opts, sgm_depths,
                               init_depths, log, device, O.WHOLE_GRID)
    check_mesh(mesh)
    share = view_share(V, mesh)
    sl = slice(share.start, share.stop)
    layout = O.WHOLE_GRID if mesh.size(1) == 1 else \
        RowBands(mesh.get_group("patch"))
    mine = [] if not share else _optimize_batch(
        mains[sl], subs_list[sl], opts,
        None if sgm_depths is None else sgm_depths[sl],
        None if init_depths is None else init_depths[sl], log, device,
        layout)
    return _share_results(mine, V, (mains[0].height, mains[0].width), mesh,
                          resolve_device(device))


def _optimize_batch(mains, subs_list, opts, sgm_depths, init_depths, log,
                    device, layout) -> list[O.DepthResult]:
    """`optimize_view_batch` on one rank, or one ``views`` row of ranks,
    its Newton systems solved in ``layout``; under -d 1 and above the
    stage report reads the call's spans."""
    with timing.recording(log is not None) as spans, \
            timing.span("opt.batch"):
        results = _run_batch(mains, subs_list, opts, sgm_depths,
                             init_depths, log, device, layout)
    if log:
        log(timing.report(spans))
    return results


def _run_batch(mains, subs_list, opts, sgm_depths, init_depths, log,
               device, layout) -> list[O.DepthResult]:
    """`_optimize_batch`'s body."""
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
    sync = dev if opts.debug_lvl >= 2 else None
    sgm_zbs = None
    lighting = None

    def run_scale(bsurf):
        nonlocal sgm_zbs, lighting
        scale = bsurf.scale
        if log:
            log(f"### batch of {V}: scale {scale}: "
                f"{bsurf.patch_valid.sum((1, 2)).tolist()} patches")
        with timing.stage("opt.viewset", sync, scale=scale):
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
            with timing.stage("opt.lighting", sync, scale=scale,
                              views=len(mains)):
                shading = torch.stack([m.shading_images()[0].to(dtype)
                                       for m in mains])
                lighting = fit_lighting(S.normal_map(bsurf, inv_flens),
                                        shading)
        return O.run_newton_iterations_batch(
            bsurf, list(mains), gn.stack_viewsets(views), opts, sgm_zbs,
            log=log, sync=sync, lighting=lighting, ncc_images=ncc_images,
            layout=layout)

    with timing.stage("opt.scale", sync, scale=bsurf.scale):
        bsurf = run_scale(bsurf)
    while bsurf.scale > opts.min_scale and bsurf.scale > 0:
        with timing.stage("opt.subdivide", sync, scale=bsurf.scale):
            bsurf = S.subdivide(bsurf)
            bsurf = S.fill_patches_from_depth(bsurf, bfill)
        with timing.stage("opt.scale", sync, scale=bsurf.scale):
            bsurf = run_scale(bsurf)

    with timing.stage("opt.extract", sync):
        depth = S.depth_map(bsurf)
        normals = S.normal_map(bsurf, inv_flens)
    return [O.DepthResult(depth=depth[i], normals=normals[i],
                          surface=S.unstack_surface(bsurf, i),
                          lighting=None if lighting is None else lighting[i])
            for i in range(V)]


def _share_results(mine: list, V: int, hw: tuple, mesh,
                   dev: torch.device) -> list[O.DepthResult]:
    """Every view's DepthResult on every rank of a ('views', 'patch')
    mesh, each broadcast from the first rank of the ``views`` row whose
    share (``mine``) holds it; ``hw`` is the views' (height, width)."""
    owners = [row[0] for row in mesh.mesh.tolist()]
    # The grid of the last scale as the first rank has it (its share is
    # never empty); every view of a batch ends on it.
    meta = torch.zeros(8, dtype=torch.int64, device=dev)
    if dist.get_rank() == owners[0]:
        s = mine[0].surface
        meta.copy_(torch.tensor([s.scale, s.width, s.height, s.start_x,
                                 s.start_y, s.num_patches_y, s.num_patches_x,
                                 mine[0].lighting is not None]))
    dist.broadcast(meta, src=owners[0])
    scale, width, height, sx, sy, ny, nx, lit = meta.tolist()
    h, w = hw
    fshapes = [(h, w), (h, w, 3), (ny + 1, nx + 1, 4)] + [(16,)] * lit
    mshapes = [(ny + 1, nx + 1), (ny, nx)]
    out = []
    for i, owner in enumerate(owners):
        n = len(split(V, len(owners), i))
        if not n:
            continue
        if dist.get_rank() == owner:
            rs = [(r.depth, r.normals, r.surface.nodes) + (
                (r.lighting,) if lit else ()) for r in mine]
            floats = torch.cat([t.reshape(-1) for r in rs for t in r])
            masks = torch.cat([t.reshape(-1).to(torch.uint8) for r in mine
                               for t in (r.surface.node_valid,
                                         r.surface.patch_valid)])
        else:
            floats = torch.empty(n * sum(map(math.prod, fshapes)),
                                 dtype=torch.float32, device=dev)
            masks = torch.empty(n * sum(map(math.prod, mshapes)),
                                dtype=torch.uint8, device=dev)
        dist.broadcast(floats, src=owner)
        dist.broadcast(masks, src=owner)
        if dist.get_rank() == owner:
            out.extend(mine)
            continue
        fs = _split_as(floats, fshapes * n)
        ms = _split_as(masks.to(torch.bool), mshapes * n)
        k = len(fshapes)
        for j in range(n):
            depth, normals, nodes, *light = fs[j * k:(j + 1) * k]
            surf = S.Surface(nodes=nodes, node_valid=ms[2 * j],
                             patch_valid=ms[2 * j + 1], scale=scale,
                             width=width, height=height, start_x=sx,
                             start_y=sy)
            out.append(O.DepthResult(depth=depth, normals=normals,
                                     surface=surf,
                                     lighting=light[0] if light else None))
    return out


def _split_as(flat: torch.Tensor, shapes: list) -> list:
    """``flat`` cut into consecutive tensors of ``shapes``."""
    parts = torch.split(flat, [math.prod(sh) for sh in shapes])
    return [p.reshape(sh) for p, sh in zip(parts, shapes)]


def group_views(ids: Sequence[int], key: tuple, batch_views: int,
                batch_mp: float) -> list[list[int]]:
    """Split a bucket's views into groups of at most ``batch_views``, and
    at most ``batch_mp`` working megapixels in all (the JAX CLI's cap;
    key = (height, width, n_neighbors))."""
    mp = key[0] * key[1] / 1e6
    fit = max(1, int(batch_mp // mp))
    size = max(1, min(batch_views, fit))
    return [list(ids[lo:lo + size]) for lo in range(0, len(ids), size)]
