"""One Newton step over a stacked batch of views, on one device or split
over a ('views', 'patch') mesh of ranks (port of
`smvs_tpu/dist/viewbatch.py`).

`batched_newton_step` is the single-device compute: block-Jacobi PCG of
200 iterations at most on every view's system, each view with its own
exits (`cg.solve_batch`). `training_step_fn` runs it over a mesh, data
parallel over views and split over node rows: each rank takes a share of
the views (`mesh.view_share`) and, along ``patch``, a band of their node
rows (`mesh.row_band`). XLA's partitioner inserted the collectives of the
JAX step; here they are written out:

- the band's own assembly (`assemble_band`): the patches that touch the
  band's rows, on a surface whose grid starts at the first of them, give
  the band's rows of g and H as the whole grid's assembly gives them;
- block-Jacobi per band (it is local);
- the stencil product with a 1-row halo exchange (`rows.spmv`) and the
  PCG's dot products, and the gradient norm, summed over the band's
  ``patch`` group (`rows.sum_over`), so that every rank of a group takes
  the same exits.

With a ``patch`` axis of 1 the step is `batched_newton_step` on the
rank's views, bit-equal to the single-process step.

`RowBands` is the same split for the optimizer's own Newton step
(`optimizer._newton_step_batch`'s layout, under `optimize_view_batch` on
a mesh with a ``patch`` axis above 1): the band's assembly, the band
multigrid (`solver.mg.build`'s ``split``), the halo stencil product and
the sums over the group, and the solution's bands gathered whole.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from smvs_tpu_torch.dist import rows
from smvs_tpu_torch.dist.mesh import row_band, split, view_share
from smvs_tpu_torch.solver import cg, gn, mg, stencil
from smvs_tpu_torch.surface.state import Surface
from smvs_tpu_torch.utils.perview import per_view


def _update(nodes, node_valid, res_x):
    delta = torch.movedim(res_x, 0, -1)  # [V, ny1, nx1, 4]
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    return torch.where(node_valid[..., None], nodes + delta, nodes)


def batched_newton_step(template: Surface, gn_opts: gn.GNOptions,
                        lighting: torch.Tensor | None = None):
    """Returns step(nodes, node_valid, patch_valid, vis, active, view) ->
    nodes', every argument with a leading view axis (``view`` a batched
    `gn.ViewSet`; ``lighting`` [V, 16] or None)."""

    def step(nodes, node_valid, patch_valid, vis, active, view):
        surf = dataclasses.replace(template, nodes=nodes,
                                   node_valid=node_valid,
                                   patch_valid=patch_valid)
        act = active & node_valid
        g, Hb = gn.assemble(surf, view, vis, act, gn_opts, lighting)
        Pinv = stencil.block_jacobi_inverse(Hb, act)
        gnorm = per_view(lambda x: torch.linalg.vector_norm(x.reshape(-1)),
                         g, dim=1)
        res = cg.solve_batch(
            lambda x: stencil.spmv(Hb, x), -g,
            precond=lambda x: stencil.apply_block_diag(Pinv, x),
            max_iterations=200, error_tolerance=gnorm * 0.01,
            q_tolerance=1e-3)
        return _update(nodes, node_valid, res.x)

    return step


def assemble_band(template: Surface, nodes, node_valid, patch_valid, vis,
                  active, view: gn.ViewSet, band: range, gn_opts,
                  lighting: torch.Tensor | None = None):
    """Rows ``band`` = [r0, r1) of the batch's stencil system (g [4, V,
    r1 - r0, nx1], Hb [3, 3, 4, 4, V, r1 - r0, nx1]) from the whole
    grid's inputs, assembling only the patch rows [r0 - 1, r1) that touch
    them (within the grid).

    Each node row sums the same patches in the same order as the whole
    grid's assembly, so the rows are the whole grid's bit for bit where
    the per-patch contraction's matrix product gives a patch's row
    whatever the number of rows beside it (a BLAS may block a product of
    few rows otherwise: MKL's does below about 190 rows at the 1344-long
    contraction of scale 4).
    """
    ny = patch_valid.shape[-2]
    r0, r1 = band.start, band.stop
    p0, p1 = max(r0 - 1, 0), min(r1, ny)
    surf = dataclasses.replace(
        template, nodes=nodes[:, p0:p1 + 1],
        node_valid=node_valid[:, p0:p1 + 1],
        patch_valid=patch_valid[:, p0:p1],
        start_y=template.start_y + p0 * template.patchsize)
    g, Hb = gn.assemble(surf, view, vis[:, p0:p1], active[:, p0:p1 + 1],
                        gn_opts, lighting)
    lo, hi = r0 - p0, r1 - p0
    return (g[..., lo:hi, :].contiguous(),
            Hb[..., lo:hi, :].contiguous())


class RowBands:
    """The layout of `optimizer.WholeGrid` with each view's node rows split
    over the ranks of a ``patch`` group (`for_rows` binds it to a grid's
    `rows.RowSplit`)."""

    def __init__(self, group, split: rows.RowSplit | None = None):
        self.group = group
        self.split = split

    def for_rows(self, ny1: int) -> RowBands:
        return RowBands(self.group, rows.RowSplit.of(ny1, self.group))

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return self.split.rows(t)

    def assemble(self, s: Surface, view: gn.ViewSet, vis, act, gn_opts,
                 lighting):
        return assemble_band(s, s.nodes, s.node_valid, s.patch_valid, vis,
                             act, view, self.split.band, gn_opts, lighting)

    def grad_norm(self, g: torch.Tensor) -> torch.Tensor:
        sq = per_view(lambda x: cg._dot(x, x), g, dim=1)
        return torch.sqrt(self.split.sum(sq))

    def spmv(self, Hb: torch.Tensor):
        return lambda x: self.split.spmv(Hb, x)

    def build_mg(self, Hb: torch.Tensor, act: torch.Tensor,
                 damp_rows: bool) -> mg.Levels:
        return mg.build(Hb, act, damp_rows=damp_rows, split=self.split)

    @property
    def reduce(self):
        return self.split.sum

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.split.gather(x)


def _band_step(template, gn_opts, nodes, node_valid, patch_valid, vis,
               active, view, group):
    surf = dataclasses.replace(template, nodes=nodes, node_valid=node_valid,
                               patch_valid=patch_valid)
    lay = RowBands(group).for_rows(nodes.shape[1])
    act = active & node_valid
    g, Hb = lay.assemble(surf, view, vis, act, gn_opts, None)
    Pinv = stencil.block_jacobi_inverse(Hb, lay.rows(act))
    res = cg.solve_batch(
        lay.spmv(Hb), -g, precond=lambda x: stencil.apply_block_diag(Pinv, x),
        max_iterations=200, error_tolerance=lay.grad_norm(g) * 0.01,
        q_tolerance=1e-3, reduce=lay.reduce)
    band = lay.split.band
    return _update(nodes[:, band.start:band.stop],
                   node_valid[:, band.start:band.stop], res.x)


def training_step_fn(template: Surface, gn_opts: gn.GNOptions,
                     mesh: DeviceMesh):
    """The sharded step: step(nodes, node_valid, patch_valid, vis, active,
    view) on the whole batch (every rank passes the same inputs, as the
    JAX step takes global arrays) -> this rank's shard of the new nodes,
    [len(view_share), len(row_band), nx1, 4]. `gather_nodes` puts the
    shards together."""
    local = batched_newton_step(template, gn_opts)
    group = mesh.get_group("patch")

    def step(nodes, node_valid, patch_valid, vis, active, view):
        share = view_share(nodes.shape[0], mesh)
        band = row_band(nodes.shape[1], mesh)
        sl = slice(share.start, share.stop)
        args = (nodes[sl], node_valid[sl], patch_valid[sl], vis[sl],
                active[sl], gn.viewset_at(view, sl))
        if not share:  # a 'views' row beyond the batch: nothing to do
            return nodes[sl, band.start:band.stop]
        if mesh.size(1) == 1:
            return local(*args)
        return _band_step(template, gn_opts, *args, group)

    return step


def gather_nodes(shard: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's shard of `training_step_fn`'s output put together:
    the batch's nodes [V, ny1, nx1, 4], on every rank."""
    dev = shard.device
    n = dist.get_world_size()
    sizes = torch.tensor(shard.shape[:2], device=dev)
    all_sizes = [torch.empty_like(sizes) for _ in range(n)]
    dist.all_gather(all_sizes, sizes)
    layout = mesh.mesh.tolist()  # [views][patch] -> rank
    V = sum(int(all_sizes[r[0]][0]) for r in layout)
    ny1 = sum(int(all_sizes[r][1]) for r in layout[0])
    vmax = max(int(s[0]) for s in all_sizes)
    rmax = max(int(s[1]) for s in all_sizes)
    pad = shard.new_zeros((vmax, rmax, *shard.shape[2:]))
    pad[:shard.shape[0], :shard.shape[1]] = shard
    parts = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad)
    out = shard.new_empty((V, ny1, *shard.shape[2:]))
    for i, ranks_of_row in enumerate(layout):
        vs = split(V, len(layout), i)
        for j, r in enumerate(ranks_of_row):
            rs = split(ny1, len(ranks_of_row), j)
            out[vs.start:vs.stop, rs.start:rs.stop] = \
                parts[r][:len(vs), :len(rs)]
    return out
