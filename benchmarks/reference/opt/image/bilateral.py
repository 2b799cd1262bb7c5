"""Joint bilateral filtering of sparse depth maps (port of
`smvs_tpu/image/bilateral.py`, reference `lib/depth_optimizer.cc:957-1004`).

Smooths and densifies the SGM depth guided by the image. Zero depths are
holes and carry no weight; a sum of (2k+1)^2 shifted contributions.
"""

from __future__ import annotations

import math

import torch


def depthmap_bilateral_filter(
    depth: torch.Tensor,
    guide: torch.Tensor,
    sigma: float = 5.0,
    kernel_size: int = 5,
    color_sigma: float = 0.1,
) -> torch.Tensor:
    """Filter depth [H, W] guided by guide [H, W] (or [H, W, C]).

    Spatial Gaussian times per-channel Gaussian on guide differences,
    skipping zero-depth taps; 0 where the total weight is 0.
    """
    if guide.ndim == 2:
        guide = guide[..., None]
    h, w = depth.shape
    k = kernel_size
    dp = torch.nn.functional.pad(depth, (k, k, k, k))
    rows = torch.arange(-k, h + k, device=guide.device).clamp(0, h - 1)
    cols = torch.arange(-k, w + k, device=guide.device).clamp(0, w - 1)
    gp = guide[rows][:, cols]  # edge-padded guide

    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    inv_2c2 = 1.0 / (2.0 * color_sigma * color_sigma)
    for ky in range(-k, k + 1):
        for kx in range(-k, k + 1):
            d_tap = dp[k + ky : k + ky + h, k + kx : k + kx + w]
            g_tap = gp[k + ky : k + ky + h, k + kx : k + kx + w]
            w_sp = math.exp(-(kx * kx + ky * ky) * inv_2s2)
            w_col = torch.exp(-torch.sum((g_tap - guide) ** 2, dim=-1)
                              * inv_2c2)
            wgt = torch.where(d_tap > 0, w_sp * w_col, 0.0)
            num = num + wgt * d_tap
            den = den + wgt
    return torch.where(den > 0, num / torch.clamp(den, min=1e-20), 0.0)
