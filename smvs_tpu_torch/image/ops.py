"""Image operations for the stereo pipeline (port of `smvs_tpu/image/ops.py`).

Scale space by Gaussian blur (not downsampling, reference
`lib/stereo_view.cc:27-31`), luminance desaturation and the inverse sRGB
curve of color views, the bilinear samplers of the SGM warps and the
Gauss-Newton assembly, and the half-size rescales of the CLI's input and
SGM scales. Functions take [..., H, W] tensors and run
on whatever device the tensor lives on.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def scale_space_sigma(scale: int | float) -> float:
    """Blur sigma for a pyramid scale; reference `lib/stereo_view.cc:29`."""
    return 0.12 * (2.0**scale) + 0.2


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Desaturate [..., H, W, 3] -> [..., H, W] (MVE DESATURATE_LUMINANCE,
    ITU-R BT.601 weights), as used at reference `lib/stereo_view.cc:51-53`.

    XLA's CPU code computes the JAX version's einsum as two fused
    multiply-adds, ``fma(b, w2, fma(g, w1, r * w0))``; in float32 the port
    rounds the same way on every device (float64 holds each float32
    product exactly), so a view's gray image equals the JAX package's.
    """
    w = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype,
                     device=rgb.device)
    if rgb.dtype != torch.float32:
        return rgb[..., 0] * w[0] + rgb[..., 1] * w[1] + rgb[..., 2] * w[2]
    x, w = rgb.double(), w.double()
    out = (x[..., 0] * w[0]).float().double()
    out = (x[..., 1] * w[1] + out).float().double()
    return (x[..., 2] * w[2] + out).float()


def srgb_to_linear(img: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB gamma (MVE gamma_correct_inv_srgb), used for the
    shading image at reference `lib/stereo_view.cc:64-74`."""
    return torch.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4)


def gaussian_kernel(sigma: float, dtype=torch.float32, device=None
                    ) -> torch.Tensor:
    """1D Gaussian kernel with MVE's support rule (ks = ceil(sigma * 2.884))."""
    ks = int(math.ceil(sigma * 2.884))
    xs = np.arange(-ks, ks + 1, dtype=np.float64)
    w = np.exp(-(xs**2) / (2.0 * sigma**2))
    w /= w.sum()
    return torch.as_tensor(w, dtype=dtype, device=device)


def _edge_pad(x: torch.Tensor, dim: int, before: int, after: int
              ) -> torch.Tensor:
    """Edge-replicating pad of ``x`` along ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, idx)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with edge-clamp borders on [..., H, W].

    A sum of shifted slices in the order of the JAX version (no
    convolution library call, so no TF32 either).
    """
    if sigma <= 0:
        return img
    k = gaussian_kernel(sigma, img.dtype, img.device)
    ks = (k.shape[0] - 1) // 2

    def conv1d(x, dim):
        xp = _edge_pad(x, dim, ks, ks)
        n = x.shape[dim]
        out = torch.zeros_like(x)
        for i in range(k.shape[0]):
            out = out + k[i] * xp.narrow(dim, i, n)
        return out

    return conv1d(conv1d(img, img.ndim - 1), img.ndim - 2)


def rescale_half_size(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample (mve::image::rescale_half_size) of [..., H, W];
    odd sizes keep the partial last row/column by edge-padding.

    The four samples are summed in order, ((a + b) + c) + d. XLA's CPU
    code sums the JAX version's mean the same way at most widths, but
    pairwise, (a + b) + (c + d), at power-of-two output widths (and some
    odd sizes); there about a fifth of the pixels differ by 1-2 ulp, and
    the census turns a few of those into other SGM costs
    (tests/test_torch_scene.py, tests/test_torch_general.py).
    """
    h, w = img.shape[-2], img.shape[-1]
    if h % 2:
        img = _edge_pad(img, img.ndim - 2, 0, 1)
    if w % 2:
        img = _edge_pad(img, img.ndim - 1, 0, 1)
    a = img[..., 0::2, 0::2]
    b = img[..., 0::2, 1::2]
    c = img[..., 1::2, 0::2]
    d = img[..., 1::2, 1::2]
    return (((a + b) + c) + d) / 4


def rescale_half_size_gaussian(img: torch.Tensor,
                               sigma: float = math.sqrt(3.0) / 2.0
                               ) -> torch.Tensor:
    """Half-size rescale of [..., H, W] with 4x4 Gaussian taps
    (mve::image::rescale_half_size_gaussian, used at reference
    `app/smvsrecon.cc:637`). Output pixel centers sit at input coords
    (2i + 0.5, 2j + 0.5); taps at squared distances {0.5, 2.5, 4.5}.

    Within an ulp of the JAX version, which XLA rounds through fused
    multiply-adds; the CLI stores the result as uint8.
    """
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = (h + 1) // 2, (w + 1) // 2
    w1 = math.exp(-0.5 / (2.0 * sigma**2))
    w2 = math.exp(-2.5 / (2.0 * sigma**2))
    w3 = math.exp(-4.5 / (2.0 * sigma**2))
    kernel = np.array([[w3, w2, w2, w3], [w2, w1, w1, w2],
                       [w2, w1, w1, w2], [w3, w2, w2, w3]])
    kernel /= kernel.sum()
    xp = _edge_pad(img, img.ndim - 2, 1, 2 + h % 2)
    xp = _edge_pad(xp, img.ndim - 1, 1, 2 + w % 2)
    out = torch.zeros((*img.shape[:-2], oh, ow), dtype=img.dtype,
                      device=img.device)
    for dy in range(4):
        for dx in range(4):
            sl = xp[..., dy : dy + 2 * oh : 2, dx : dx + 2 * ow : 2]
            out = out + float(kernel[dy, dx]) * sl
    return out


def _corners(x: torch.Tensor, y: torch.Tensor, w: int, h: int):
    """Clamped base corner (x0, y0) as int64 and the blend fractions."""
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    return x0, y0, fx, fy


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """Bilinear sample img[..., H, W] at (x, y), coordinates clamped to the
    border (MVE linear_at semantics); pixel centers at integers."""
    h, w = img.shape[-2], img.shape[-1]
    x0, y0, fx, fy = _corners(x, y, w, h)
    v00 = img[..., y0, x0]
    v10 = img[..., y0, x0 + 1]
    v01 = img[..., y0 + 1, x0]
    v11 = img[..., y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v10 * fx * (1 - fy)
        + v01 * (1 - fx) * fy
        + v11 * fx * fy
    )


def pack_window4(img: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H, W, 4] with each pixel's 2x2 support (v00, v10, v01, v11).

    The rolls wrap, but wrapped entries sit at x=W-1 / y=H-1, which
    clamped sampling never addresses.
    """
    x1 = torch.roll(img, -1, dims=-1)
    y1 = torch.roll(img, -1, dims=-2)
    xy1 = torch.roll(x1, -1, dims=-2)
    return torch.stack([img, x1, y1, xy1], dim=-1)


def bilinear_packed4(img4: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """`bilinear` over a `pack_window4` image; one 4-wide row per sample."""
    h, w = img4.shape[0], img4.shape[1]
    shape = x.shape
    x0, y0, fx, fy = _corners(x.reshape(-1), y.reshape(-1), w, h)
    rows = img4.reshape(h * w, 4)[y0 * w + x0]  # [M, 4]
    top = rows[:, 0] * (1 - fx) + rows[:, 1] * fx
    bot = rows[:, 2] * (1 - fx) + rows[:, 3] * fx
    return (top * (1 - fy) + bot * fy).reshape(shape)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, like a fused multiply-add.

    XLA's CPU compile fuses some of the JAX package's products and sums
    into FMAs (the SGM sweep's shift ramp and plane blend, the warps'
    bilinear blends), and a census flips a bit on a one-ulp difference,
    so the port rounds those the same way on every device: float64 holds
    the float32 product exactly.
    """
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).to(torch.float32)


def bilinear_packed4_fma(img4: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                         ) -> torch.Tensor:
    """`bilinear_packed4` with each blend ``a * (1 - f) + b * f`` as XLA
    fuses it in a compiled warp: ``fma(b, f, a * (1 - f))``, the last one
    as ``fma(top, 1 - fy, bot * fy)``."""
    h, w = img4.shape[0], img4.shape[1]
    shape = x.shape
    x0, y0, fx, fy = _corners(x.reshape(-1), y.reshape(-1), w, h)
    rows = img4.reshape(h * w, 4)[y0 * w + x0]  # [M, 4]
    top = fma(rows[:, 1], fx, rows[:, 0] * (1 - fx))
    bot = fma(rows[:, 3], fx, rows[:, 2] * (1 - fx))
    return fma(top, 1 - fy, bot * fy).reshape(shape)


def pack_gradhess(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """Stack grad [2, H, W] + hess [3, H, W] into one [H, W, 5] image with
    channels (Ix, Iy, Ixx, Ixy, Iyy)."""
    return torch.movedim(torch.cat([grad, hess], dim=0), 0, -1).contiguous()


def _flat_index(x0, y0, w: int, h: int, base, shape):
    """Flat pixel index of (x0, y0): in one image, or with ``base`` (image
    indices broadcastable to ``shape``) in a stack [V, H, W, C]."""
    i = y0 * w + x0
    if base is None:
        return i
    return i + torch.broadcast_to(base, shape).reshape(-1) * (h * w)


def sample_window(img_c: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  base: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear sample of a channels-last image [H, W, C] at (x, y), with
    the clamp semantics of :func:`bilinear`. Returns [..., C]. With
    ``base``, img_c is a stack [V, H, W, C] and each sample reads image
    ``base`` (int, broadcastable to x)."""
    h, w, c = img_c.shape[-3:]
    shape = x.shape
    x0, y0, fx, fy = _corners(x.reshape(-1), y.reshape(-1), w, h)
    fx = fx[:, None]
    fy = fy[:, None]
    flat = img_c.reshape(-1, c)
    i00 = _flat_index(x0, y0, w, h, base, shape)
    v00 = flat[i00]
    v10 = flat[i00 + 1]
    v01 = flat[i00 + w]
    v11 = flat[i00 + w + 1]
    out = (v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy)
           + v01 * (1 - fx) * fy + v11 * fx * fy)
    return out.reshape(*shape, c)


def pack_gradhess_pair10(grad: torch.Tensor, hess: torch.Tensor
                         ) -> torch.Tensor:
    """bf16 x-paired sampling image [H, W, 10]: the 5 channels of pixel x
    and of x + 1 side by side.

    Stored in bf16 (round to nearest even, as JAX casts); the corners are
    blended in the coordinate dtype after the load
    (:func:`sample_window_pair10`).
    """
    img5 = pack_gradhess(grad, hess)
    right = torch.cat([img5[:, 1:], img5[:, -1:]], dim=1)
    return torch.cat([img5, right], dim=-1).to(torch.bfloat16)


def sample_window_pair10(img10: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor, base: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Bilinear 5-channel sample from a `pack_gradhess_pair10` image;
    returns [..., 5] in the coordinate dtype via two row gathers
    (``base``: as :func:`sample_window`)."""
    h, w, c2 = img10.shape[-3:]
    c = c2 // 2
    shape = x.shape
    x0, y0, fx, fy = _corners(x.reshape(-1), y.reshape(-1), w, h)
    fx = fx[:, None]
    fy = fy[:, None]
    flat = img10.reshape(-1, c2)
    i00 = _flat_index(x0, y0, w, h, base, shape)
    r0 = flat[i00].to(x.dtype)  # [M, 2c]
    r1 = flat[i00 + w].to(x.dtype)
    out = ((r0[:, :c] * (1 - fx) + r0[:, c:] * fx) * (1 - fy)
           + (r1[:, :c] * (1 - fx) + r1[:, c:] * fx) * fy)
    return out.reshape(*shape, c)


def sample_gh(gh: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              base: torch.Tensor | None = None) -> torch.Tensor:
    """Sample a packed (Ix, Iy, Ixx, Ixy, Iyy) image in either format:
    [H, W, 5] (`pack_gradhess`) or [H, W, 10] bf16 (`pack_gradhess_pair10`)
    (``base``: as :func:`sample_window`)."""
    if gh.shape[-1] == 10:
        return sample_window_pair10(gh, x, y, base)
    return sample_window(gh, x, y, base)


def sample_gradient_packed(gh: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Bilinear (Ix, Iy) from a packed image at (x, y) -> (..., 2)."""
    return sample_gh(gh, x, y)[..., :2]
