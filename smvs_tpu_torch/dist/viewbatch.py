"""One Newton step over a stacked batch of views (port of
`smvs_tpu/dist/viewbatch.py`'s `batched_newton_step`).

The JAX module also builds the ('views', 'patch') device mesh and the
sharded training step over it; those are ROADMAP.md queue 1, item 6.
This is their single-device compute: block-Jacobi PCG of 200 iterations
at most on every view's system, each view with its own exits
(`cg.solve_batch`).
"""

from __future__ import annotations

import dataclasses

import torch

from smvs_tpu_torch.solver import cg, gn, stencil
from smvs_tpu_torch.surface.state import Surface
from smvs_tpu_torch.utils.perview import per_view


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
        delta = torch.movedim(res.x, 0, -1)  # [V, ny1, nx1, 4]
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        return torch.where(node_valid[..., None], nodes + delta, nodes)

    return step
