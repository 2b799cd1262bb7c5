"""Carry JAX-side state into the port's objects.

The system has no learned weights; its state is the scene (cameras,
images) and the surface being optimized. The JAX package's values arrive
here as numpy arrays and plain dicts (the caller extracts them), so this
module imports nothing of the JAX package. bf16 arrays may come as numpy
arrays of the ``bfloat16`` extension dtype; their bits are kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.pipeline.views import StereoViewState, make_view
from smvs_tpu_torch.solver.gn import ViewSet
from smvs_tpu_torch.surface.state import Surface


def tensor(arr, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy (bf16 included) -> tensor on ``device``."""
    a = np.array(arr)  # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def camera(d: dict) -> Camera:
    """{"flen", "rot", "trans", "ppoint"?, "paspect"?} -> Camera."""
    return Camera(flen=float(d["flen"]), rot=np.asarray(d["rot"]),
                  trans=np.asarray(d["trans"]),
                  ppoint=tuple(d.get("ppoint", (0.5, 0.5))),
                  paspect=float(d.get("paspect", 1.0)))


def view(cam: dict | Camera, image, view_id: int = 0,
         device: str | torch.device | None = None) -> StereoViewState:
    """A view from camera parameters and a gray image."""
    c = cam if isinstance(cam, Camera) else camera(cam)
    return make_view(c, np.asarray(image), view_id=view_id, device=device)


def surface(nodes, node_valid, patch_valid, meta: dict, device) -> Surface:
    """A Surface from its arrays and metadata
    {"scale", "width", "height", "start_x", "start_y"}."""
    return Surface(
        nodes=tensor(nodes, device),
        node_valid=tensor(node_valid, device, torch.bool),
        patch_valid=tensor(patch_valid, device, torch.bool),
        scale=int(meta["scale"]), width=int(meta["width"]),
        height=int(meta["height"]), start_x=int(meta["start_x"]),
        start_y=int(meta["start_y"]))


def viewset(grad_main, sub_gh, M, t, flen, device) -> ViewSet:
    """A ViewSet from its arrays (``sub_gh`` f32 [N,H,W,5] or bf16 [N,H,W,10])."""
    g = tensor(grad_main, device)
    return ViewSet(grad_main=g, sub_gh=tensor(sub_gh, device),
                   M=tensor(M, device, g.dtype), t=tensor(t, device, g.dtype),
                   flen=torch.as_tensor(float(flen), dtype=g.dtype,
                                        device=device))


def options(cls, d: dict):
    """An option dataclass of the port (`SGMOptions`, `GNOptions`,
    `OptimizerOptions`) from a dict of its fields; unknown keys raise."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**d)
