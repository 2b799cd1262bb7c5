"""Rank functions of the port's multi-process tests, run by
`smvs_tpu_torch.dist.launch.spawn` in spawned processes.

A spawned rank imports the module of the function it runs, so these live
apart from the test files, which import JAX: a rank imports torch and the
port only. Each returns plain data with its tensors on the CPU.
"""

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.dist import mesh as M
from smvs_tpu_torch.dist import rows, viewbatch
from smvs_tpu_torch.dist.testing import make_view_batch, plane_view_problem
from smvs_tpu_torch.pipeline import batch as B
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.solver import gn, mg

ARGS = ("nodes", "node_valid", "patch_valid", "vis", "active", "view")

# tests/test_batch.py:43-46
BATCH_OPTS = dict(regularization=0.01, num_iterations=2, min_scale=4,
                  use_sgm=False, full_optimization=True, max_newton_steps=8,
                  fixed_newton_steps=True)


def mesh_layout(rank, world, dev, patch_axes, V, ny1):
    """Per mesh: its shape, names, this rank's coordinate, view share and
    row band."""
    out = {}
    for p in patch_axes:
        mesh = M.make_mesh(world, patch_axis=p, device=dev)
        out[p] = dict(shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
                      coord=tuple(mesh.get_coordinate()),
                      share=M.view_share(V, mesh), band=M.row_band(ny1, mesh))
    return out


def mesh_errors(rank, world, dev):
    """The messages of the mesh's refusals on two ranks."""
    out = {}
    for key, fn in (
            ("patch_3", lambda: M.make_mesh(2, patch_axis=3, device=dev)),
            ("size", lambda: M.make_mesh(3, device=dev)),
            ("band", lambda: M.row_band(1, M.make_mesh(2, patch_axis=2,
                                                       device=dev)))):
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def halo_spmv(rank, world, dev, path):
    """`rows.exchange_halo` and `rows.spmv` on this rank's band of a
    seeded stencil system saved at ``path``."""
    data = torch.load(path)
    mesh = M.make_mesh(world, patch_axis=world, device=dev)
    band = M.row_band(data["x"].shape[-2], mesh)
    group = mesh.get_group("patch")
    xb = data["x"][..., band.start:band.stop, :]
    Hb = data["Hb"][..., band.start:band.stop, :].contiguous()
    return dict(band=band, halo=rows.exchange_halo(xb, band, group),
                y=rows.spmv(Hb, xb, band, group))


def training_step(rank, world, dev, patch_axis):
    """The sharded step on `make_view_batch(4, dim=116, scale=4)` in
    float64 (tests/test_dist.py's problem): this rank's shard, its view
    share and row band, and the shards put together."""
    template, batch = make_view_batch(4, dim=116, scale=4,
                                      dtype=torch.float64, device=dev)
    mesh = M.make_mesh(world, patch_axis=patch_axis, device=dev)
    step = viewbatch.training_step_fn(template, gn.GNOptions(), mesh)
    shard = step(*(batch[k] for k in ARGS))
    return dict(shard=shard, share=M.view_share(4, mesh),
                band=M.row_band(batch["nodes"].shape[1], mesh),
                full=viewbatch.gather_nodes(shard, mesh))


def batch_on_mesh(rank, world, dev, patch_axis, dim=96, min_scale=4):
    """`optimize_view_batch` over a ('views', patch_axis) mesh on the two
    mains of tests/test_batch.py's problem (at ``dim``, down to
    ``min_scale``): this rank's view share and every view's result."""
    mains, subs, inits = plane_view_problem(2, dim=dim, device=dev)
    mesh = B.make_view_mesh(world, patch_axis=patch_axis, device=dev)
    opts = O.OptimizerOptions(**{**BATCH_OPTS, "min_scale": min_scale})
    out = B.optimize_view_batch(mains, subs, opts, init_depths=inits,
                                mesh=mesh, device=dev)
    return {"share": M.view_share(2, mesh),
            "results": [(r.depth, r.normals, r.surface.nodes,
                         r.surface.node_valid, r.surface.patch_valid,
                         (r.surface.scale, r.surface.start_x,
                          r.surface.start_y, r.surface.width,
                          r.surface.height), r.lighting) for r in out]}


def batches_on_mesh(rank, world, dev, patch_axis, problems):
    """`batch_on_mesh` at each (dim, min_scale) of ``problems``."""
    return [batch_on_mesh(rank, world, dev, patch_axis, dim, min_scale)
            for dim, min_scale in problems]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN where NaN, -0.0 where -0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = a.view(bits[a.dtype]), b.view(bits[b.dtype])
    return torch.equal(a, b)


def seeded_system(V: int, ny1: int, nx1: int, seed: int = 0) -> dict:
    """A seeded stencil system [3, 3, 4, 4, V, ny1, nx1] and vector
    [4, V, ny1, nx1] in float64."""
    rng = np.random.default_rng(seed)
    return dict(Hb=torch.as_tensor(rng.normal(size=(3, 3, 4, 4, V, ny1,
                                                    nx1))),
                x=torch.as_tensor(rng.normal(size=(4, V, ny1, nx1))))


def band_multigrid(rank, world, dev, path, min_size):
    """`mg.build` and one `mg.apply` on this rank's band of the seeded
    system saved at ``path``, over a 'patch' axis of ``world``: each
    level's band (None for a gathered level), operator, inverted
    diagonal, damping map, and the apply's rows."""
    data = torch.load(path)
    mesh = M.make_mesh(world, patch_axis=world, device=dev)
    split = rows.RowSplit.of(data["x"].shape[-2], mesh.get_group("patch"))
    levels = mg.build(split.rows(data["Hb"]).contiguous(),
                      split.rows(data["active"]), min_size=min_size,
                      split=split)
    z = mg.apply(levels, split.rows(data["x"]))
    return dict(bands=[None if sp is None else sp.band
                       for sp in levels.splits],
                ops=levels.ops, pinvs=levels.pinvs, omegas=levels.omegas,
                shapes=levels.shapes, z=z)


def band_newton_step(rank, world, dev, dim, scale):
    """`optimizer._newton_step_batch` (multigrid PCG) with each view's
    node rows split over a 'patch' axis of ``world`` on
    `make_view_batch(2, dim, scale)` in float64: the step's result."""
    template, batch = make_view_batch(2, dim=dim, scale=scale,
                                      dtype=torch.float64, device=dev)
    mesh = M.make_mesh(world, patch_axis=world, device=dev)
    surf = dataclasses.replace(template, nodes=batch["nodes"],
                               node_valid=batch["node_valid"],
                               patch_valid=batch["patch_valid"])
    st = O._newton_step_batch(surf, batch["view"], batch["vis"],
                              batch["active"], O.OptimizerOptions(), None,
                              np.ones(2, bool),
                              viewbatch.RowBands(mesh.get_group("patch")))
    return dataclasses.asdict(st)
