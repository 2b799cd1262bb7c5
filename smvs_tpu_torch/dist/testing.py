"""Synthetic stacked view-batch problems (port of
`smvs_tpu/dist/testing.py`), from the same numpy seed, and the plane-scene
views of the JAX dry run and scaling harness."""

from __future__ import annotations

import numpy as np
import torch

from smvs_tpu_torch.core.synthetic import make_plane_scene, \
    make_two_view_scene
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


def plane_view_problem(n_views: int, dim: int = 96, device=None):
    """The JAX dry run's and scaling harness's views
    (`__graft_entry__.py:86-97`): the ``n_views`` mains of an
    (n_views + 1)-view plane scene, each seeing the center view, and
    their dense inits 2% too deep. Returns (mains, subs_list, inits)."""
    scene = make_plane_scene(n_views=n_views + 1, dim=dim)
    views = [make_view(scene.cameras[i], scene.images[i], view_id=i,
                       device=device) for i in range(n_views + 1)]
    center = n_views // 2
    others = [i for i in range(n_views + 1) if i != center][:n_views]
    return ([views[i] for i in others], [[views[center]] for _ in others],
            [(scene.depths[i] * 1.02).astype(np.float32) for i in others])
