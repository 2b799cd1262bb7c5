"""Synthetic stacked view-batch problems (port of
`smvs_tpu/dist/testing.py`), from the same numpy seed."""

from __future__ import annotations

import numpy as np
import torch

from smvs_tpu_torch.core.synthetic import make_two_view_scene
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.pipeline.views import make_view
from smvs_tpu_torch.solver import gn
from smvs_tpu_torch.surface import state as S


def make_single_view_problem(dim: int = 120, scale: int = 4,
                             dtype=torch.float32, device=None):
    """One synthetic view problem: (surface, viewset, vis, active)."""
    scene = make_two_view_scene(dim=dim, rotate=True)
    main = make_view(scene.cameras[1], scene.images[1], view_id=1,
                     device=device, dtype=dtype)
    sub = make_view(scene.cameras[0], scene.images[0], view_id=0,
                    device=device, dtype=dtype)
    surf = S.create_planar(5.5, main.width, main.height, scale, dtype=dtype,
                           device=main.device)
    view = O._build_viewset(main, [sub], scale, dtype)
    ny, nx = surf.num_patches_y, surf.num_patches_x
    vis = torch.ones((ny, nx, 1), dtype=torch.bool, device=main.device)
    return surf, view, vis, surf.node_valid


def make_view_batch(n_views: int, dim: int = 120, scale: int = 4,
                    dtype=torch.float32, device=None):
    """``n_views`` copies of the synthetic problem stacked on a leading
    view axis, each view's nodes perturbed by seeded noise (sigma 0.01).
    Returns (template surface, dict of the batched step's inputs)."""
    surf, view, vis, active = make_single_view_problem(dim, scale, dtype,
                                                       device)
    rng = np.random.default_rng(0)

    def stack(x, noise=0.0):
        out = torch.stack([x] * n_views)
        if noise:
            out = out + torch.as_tensor(
                rng.normal(scale=noise, size=tuple(out.shape)), dtype=dtype,
                device=out.device)
        return out

    batch = dict(
        nodes=stack(surf.nodes, noise=0.01),
        node_valid=stack(surf.node_valid),
        patch_valid=stack(surf.patch_valid),
        vis=stack(vis),
        active=stack(active),
        view=gn.stack_viewsets([view] * n_views),
    )
    return surf, batch
