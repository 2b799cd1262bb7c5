"""Per-view image state (port of `smvs_tpu/pipeline/views.py`,
reference `lib/stereo_view.h/.cc`).

Caches the float gray image (a color view's luminance) and, per scale,
its blur (scale space by blur, not downsampling, reference
`lib/stereo_view.cc:27-31`) with the quadratic-fit gradients and Hessian,
and the linear shading image with its gradients.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.image import gradients as igrad
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.utils.timing import span


@dataclasses.dataclass
class ScaleImages:
    image: torch.Tensor  # blurred gray [H, W]
    grad: torch.Tensor  # [2, H, W]
    hess: torch.Tensor  # [3, H, W]


@dataclasses.dataclass
class StereoViewState:
    """One view: camera + image scale space (by blur) + shading image."""

    camera: Camera
    image: torch.Tensor  # gray float [H, W] in [0, 1]
    color: torch.Tensor | None = None  # [H, W, 3] for a color view
    view_id: int = 0
    gamma_correction: bool = False
    _scales: dict = dataclasses.field(default_factory=dict)
    _shading: tuple | None = None

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

    def shading_images(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(shading image [H, W], its gradients [2, H, W]), cached: the
        luminance of the color image, or the gray image, sRGB-decoded
        first under ``gamma_correction`` (reference
        `StereoView::initialize_linear`, `lib/stereo_view.cc:64-84`)."""
        if self._shading is None:
            if self.color is not None:
                lin = self.color
                if self.gamma_correction:
                    lin = iops.srgb_to_linear(lin)
                shading = iops.luminance(lin)
            else:
                shading = (iops.srgb_to_linear(self.image)
                           if self.gamma_correction else self.image)
            grad, _ = igrad.gradients_and_hessian(shading)
            self._shading = (shading, grad)
        return self._shading


def make_view(camera: Camera, image, view_id: int = 0,
              device: str | torch.device | None = None,
              dtype=torch.float32, gamma_correction: bool = False
              ) -> StereoViewState:
    """A view from a gray [H, W] or color [H, W, 3] image on ``device``
    (the GPU unless ``"cpu"`` is passed); a color view's gray image is its
    luminance. ``gamma_correction`` sRGB-decodes the shading image. The
    build is the command line's ``cli.views`` stage, a span a view."""
    dev = resolve_device(device)
    with span("cli.views"):
        if isinstance(image, torch.Tensor):
            img = image.to(device=dev, dtype=dtype)
        else:
            img = torch.as_tensor(np.asarray(image), dtype=dtype, device=dev)
        color = None
        if img.ndim == 3:
            color, img = img, iops.luminance(img)
    return StereoViewState(camera=camera, image=img, color=color,
                           view_id=view_id,
                           gamma_correction=gamma_correction)
