"""Per-view image state (port of `smvs_tpu/pipeline/views.py`,
reference `lib/stereo_view.h/.cc`).

Caches the float image and, per scale, its blur (scale space by blur, not
downsampling, reference `lib/stereo_view.cc:27-31`) with the quadratic-fit
gradients and Hessian. The shading images wait for the shading port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.image import gradients as igrad
from smvs_tpu_torch.image import ops as iops


@dataclasses.dataclass
class ScaleImages:
    image: torch.Tensor  # blurred gray [H, W]
    grad: torch.Tensor  # [2, H, W]
    hess: torch.Tensor  # [3, H, W]


@dataclasses.dataclass
class StereoViewState:
    """One view: camera + image scale space (by blur)."""

    camera: Camera
    image: torch.Tensor  # gray float [H, W] in [0, 1]
    view_id: int = 0
    _scales: dict = dataclasses.field(default_factory=dict)

    @property
    def width(self) -> int:
        return self.image.shape[1]

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def device(self) -> torch.device:
        return self.image.device

    def flen(self) -> float:
        return self.camera.flen_pixels(self.width, self.height)

    def at_scale(self, scale: int) -> ScaleImages:
        """Blur to the scale's sigma and differentiate
        (reference `StereoView::set_scale`, `lib/stereo_view.cc:24-46`)."""
        if scale not in self._scales:
            blurred = iops.gaussian_blur(self.image,
                                         iops.scale_space_sigma(scale))
            grad, hess = igrad.gradients_and_hessian(blurred)
            self._scales[scale] = ScaleImages(blurred, grad, hess)
        return self._scales[scale]


def make_view(camera: Camera, image, view_id: int = 0,
              device: str | torch.device | None = None,
              dtype=torch.float32) -> StereoViewState:
    """A view from a gray [H, W] image on ``device`` (the GPU unless
    ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    if isinstance(image, torch.Tensor):
        img = image.to(device=dev, dtype=dtype)
    else:
        img = torch.as_tensor(np.asarray(image), dtype=dtype, device=dev)
    if img.ndim != 2:
        raise NotImplementedError(
            "color views (luminance and the shading image) are not ported "
            "yet (ROADMAP.md queue 1)")
    return StereoViewState(camera=camera, image=img, view_id=view_id)
