"""Color views and the sRGB decode of the shading image (the CLI's `-g`)
against the JAX package, on the CPU, in float64 against JAX x64.

A color view keeps its RGB image and optimizes on its luminance; its
shading image is the luminance of the (sRGB-decoded, under
``gamma_correction``) RGB image, and a gray view's is the (decoded) gray
image. In float32 the port's luminance rounds as XLA's two fused
multiply-adds do, so the gray image of a color view equals the JAX
package's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.image import ops as jops
from smvs_tpu.pipeline import views as jviews
from smvs_tpu_torch.core import synthetic as tsyn
from smvs_tpu_torch.image import ops as tops
from smvs_tpu_torch.pipeline import views as tviews
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12  # float64: the same arithmetic in another order


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _rgb(seed, shape=(23, 31, 3)):
    return np.random.default_rng(seed).random(shape)


def test_luminance_matches_jax():
    x = _rgb(0, (2, 23, 31, 3))
    _close(tops.luminance(torch.from_numpy(x)),
           jops.luminance(jnp.asarray(x)))


def test_luminance_float32_is_bit_equal():
    x = _rgb(1, (97, 61, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tops.luminance(torch.from_numpy(x)).numpy(),
        np.asarray(jops.luminance(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_srgb_to_linear_matches_jax(dtype):
    """Both branches of the curve (the knee at 0.04045), rtol 1e-12 in
    float64 and within 1 float32 ulp (the power's rounding) in float32."""
    x = np.concatenate([np.linspace(0, 0.05, 101), _rgb(2).ravel()]
                       ).astype(dtype)
    got = tops.srgb_to_linear(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.srgb_to_linear(jnp.asarray(x)))
    if dtype == np.float64:
        _close(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def _views(image, gamma):
    scene = tsyn.make_plane_scene(n_views=2, dim=48, color=True)
    cam = scene.cameras[1]
    jv = jviews.make_view(cam, image, view_id=1, gamma_correction=gamma,
                          dtype=jnp.float64)
    tv = tviews.make_view(cam, image, view_id=1, device="cpu",
                          dtype=torch.float64, gamma_correction=gamma)
    return jv, tv


def test_color_make_view_matches_jax():
    """The color branch keeps the RGB image and optimizes on its
    luminance: the gray image and its scale space."""
    image = tsyn.make_plane_scene(n_views=2, dim=48, color=True).images[1]
    jv, tv = _views(image, False)
    assert tv.color.shape == (48, 48, 3) and tv.image.shape == (48, 48)
    _close(tv.color, jv.color)
    _close(tv.image, jv.image)
    for got, want in ((tv.at_scale(2).image, jv.at_scale(2).image),
                      (tv.at_scale(2).grad, jv.at_scale(2).grad)):
        _close(got, want)


@pytest.mark.parametrize("color", [True, False], ids=["color", "gray"])
@pytest.mark.parametrize("gamma", [False, True], ids=["linear", "srgb"])
def test_shading_images_match_jax(color, gamma):
    """The shading image and its gradients, with and without the sRGB
    decode, for a color and a gray view; cached."""
    scene = tsyn.make_plane_scene(n_views=2, dim=48, color=True)
    image = scene.images[1] if color else scene.images[1][..., 0]
    jv, tv = _views(image, gamma)
    (jimg, jgrad), (timg, tgrad) = jv.shading_images(), tv.shading_images()
    _close(timg, jimg)
    _close(tgrad, jgrad)
    assert tv.shading_images()[0] is timg
    if gamma:  # the decode changes the image
        assert float((timg - tv.image).abs().max()) > 0.05
