"""The port's image, geometry and surface modules against the JAX package.

Float stages compare float64 on both sides (JAX runs with x64 on, see
conftest.py) at rtol 1e-9; the bf16 sampling image must match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.geometry import correspondence as jcorr
from smvs_tpu.geometry import normals as jnrm
from smvs_tpu.image import bilateral as jbil
from smvs_tpu.image import gradients as jgrad
from smvs_tpu.image import ops as jops
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.surface import bicubic as jbic
from smvs_tpu.surface import state as jS
from smvs_tpu_torch import convert
from smvs_tpu_torch.core import camera as tcam
from smvs_tpu_torch.geometry import correspondence as tcorr
from smvs_tpu_torch.geometry import normals as tnrm
from smvs_tpu_torch.image import bilateral as tbil
from smvs_tpu_torch.image import gradients as tgrad
from smvs_tpu_torch.image import ops as tops
from smvs_tpu_torch.pipeline import views as tviews
from smvs_tpu_torch.surface import bicubic as tbic
from smvs_tpu_torch.surface import state as tS

RTOL = 1e-9  # float64 on both sides


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _img(h, w, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (h, w))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_surface(js):
    meta = {f: getattr(js, f) for f in ("scale", "width", "height",
                                        "start_x", "start_y")}
    return convert.surface(np.asarray(js.nodes), np.asarray(js.node_valid),
                           np.asarray(js.patch_valid), meta, "cpu")


def _same_surface(ts, js):
    assert (ts.scale, ts.start_x, ts.start_y) == (js.scale, js.start_x,
                                                  js.start_y)
    np.testing.assert_array_equal(ts.node_valid.numpy(),
                                  np.asarray(js.node_valid))
    np.testing.assert_array_equal(ts.patch_valid.numpy(),
                                  np.asarray(js.patch_valid))
    _close(ts.nodes, js.nodes)


@pytest.mark.parametrize("scale", [1, 2, 5])
def test_gaussian_blur(scale):
    img = _img(23, 31, seed=scale)
    sigma = tops.scale_space_sigma(scale)
    assert sigma == jops.scale_space_sigma(scale)
    _close(tops.gaussian_blur(_t(img), sigma),
           jops.gaussian_blur(jnp.asarray(img), sigma))


def test_gradients_and_hessian():
    img = _img(19, 26, seed=3)
    tg, th = tgrad.gradients_and_hessian(_t(img))
    jg, jh = jgrad.gradients_and_hessian(jnp.asarray(img))
    _close(tg, jg)
    _close(th, jh)


def test_bilateral_filter():
    rng = np.random.default_rng(4)
    depth = rng.uniform(4.0, 6.0, (21, 27))
    depth[rng.random(depth.shape) < 0.4] = 0.0
    guide = _img(21, 27, seed=5)
    _close(tbil.depthmap_bilateral_filter(_t(depth), _t(guide)),
           jbil.depthmap_bilateral_filter(jnp.asarray(depth),
                                          jnp.asarray(guide)))


def test_bilinear_samplers():
    rng = np.random.default_rng(6)
    img = _img(17, 22, seed=7)
    x = rng.uniform(-2.0, 24.0, (5, 40))
    y = rng.uniform(-2.0, 19.0, (5, 40))
    _close(tops.bilinear(_t(img), _t(x), _t(y)),
           jops.bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    _close(tops.bilinear_packed4(tops.pack_window4(_t(img)), _t(x), _t(y)),
           jops.bilinear_packed4(jops.pack_window4(jnp.asarray(img)),
                                 jnp.asarray(x), jnp.asarray(y)))
    g = rng.normal(size=(2, 17, 22))
    h = rng.normal(size=(3, 17, 22))
    _close(tops.sample_window(tops.pack_gradhess(_t(g), _t(h)), _t(x), _t(y)),
           jops.sample_window(jops.pack_gradhess(jnp.asarray(g),
                                                 jnp.asarray(h)),
                              jnp.asarray(x), jnp.asarray(y)))


def test_pack_gradhess_pair10_bits_and_sampling():
    rng = np.random.default_rng(8)
    g = rng.normal(size=(2, 15, 18)).astype(np.float32)
    h = rng.normal(size=(3, 15, 18)).astype(np.float32)
    want = np.asarray(jops.pack_gradhess_pair10(jnp.asarray(g),
                                                jnp.asarray(h)))
    got = tops.pack_gradhess_pair10(_t(g), _t(h))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    x = rng.uniform(-1.0, 19.0, 300).astype(np.float32)
    y = rng.uniform(-1.0, 16.0, 300).astype(np.float32)
    # identical bf16 inputs, blended in float32: a few float32 ulp
    np.testing.assert_allclose(
        tops.sample_gh(got, _t(x), _t(y)).numpy(),
        np.asarray(jops.sample_gh(jnp.asarray(want), jnp.asarray(x),
                                  jnp.asarray(y))), rtol=1e-5, atol=1e-6)


def test_correspondence_and_normals():
    rng = np.random.default_rng(9)
    cam0 = tcam.Camera(flen=1.0, rot=np.eye(3), trans=np.zeros(3))
    ang = 0.1
    rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]])
    cam1 = tcam.Camera(flen=1.1, rot=rot, trans=np.array([0.3, 0.05, 0.0]))
    M, t = cam1.fill_reprojection(cam0, 64, 48, 64, 48)
    u, v = rng.uniform(0, 64, 50), rng.uniform(0, 48, 50)
    w, wdx, wdy = rng.uniform(4, 6, 50), rng.normal(size=50) * 0.1, \
        rng.normal(size=50) * 0.1
    args = (M, t, u, v, w)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    p_t, d_t = tcorr.warp(*targs)
    p_j, d_j = jcorr.warp(*jargs)
    _close(p_t, p_j)
    _close(d_t, d_j)
    jac_t = tcorr.warp_jacobian(*targs, _t(wdx), _t(wdy))
    jac_j = jcorr.warp_jacobian(*jargs, jnp.asarray(wdx), jnp.asarray(wdy))
    _close(jac_t, jac_j)
    _close(tcorr.jacobian_condition(jac_t), jcorr.jacobian_condition(jac_j))
    _close(tcorr.warp_depth_gradient(*targs),
           jcorr.warp_depth_gradient(*jargs))
    more = [rng.normal(size=50) * 0.01 for _ in range(3)]
    _close(tnrm.normal(_t(u), _t(v), 1 / 70.0, _t(w), _t(wdx), _t(wdy)),
           jnrm.normal(jnp.asarray(u), jnp.asarray(v), 1 / 70.0,
                       jnp.asarray(w), jnp.asarray(wdx), jnp.asarray(wdy)))
    _close(tnrm.normal_divergence(_t(u), _t(v), 70.0, _t(w), _t(wdx),
                                  _t(wdy), *map(_t, more)),
           jnrm.normal_divergence(jnp.asarray(u), jnp.asarray(v), 70.0,
                                  jnp.asarray(w), jnp.asarray(wdx),
                                  jnp.asarray(wdy), *map(jnp.asarray, more)))


@pytest.mark.parametrize("ps,sub", [(4, 1), (16, 2), (32, 4)])
def test_pixel_basis(ps, sub):
    _close(tbic.pixel_basis(ps, sub, dtype=torch.float64),
           jbic.pixel_basis(ps, sub, dtype=jnp.float64))


def _depth_with_holes(h, w, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 5.0 + 0.01 * xs + 0.02 * ys + 0.05 * np.sin(xs / 7.0)
    depth[rng.random((h, w)) < 0.3] = 0.0
    depth[10:30, 40:70] = 0.0  # a hole bigger than a patch
    return depth


def test_surface_from_depth_subdivide_and_rasterize():
    depth = _depth_with_holes(90, 110, seed=10)
    js = jS.create_from_depth(jnp.asarray(depth), 4)
    ts = tS.create_from_depth(_t(depth), 4)
    _same_surface(ts, js)
    # one subdivision and a refill, as the optimizer's scale step
    js2 = jS.fill_patches_from_depth(jS.subdivide(js), jnp.asarray(depth))
    ts2 = tS.fill_patches_from_depth(tS.subdivide(_port_surface(js)),
                                     _t(depth))
    _same_surface(ts2, js2)
    _close(tS.depth_map(ts2), jS.depth_map(js2))
    _close(tS.normal_map(ts2, 1 / 110.0), jS.normal_map(js2, 1 / 110.0))
    _close(tS.patch_params(ts2), jS.patch_params(js2))
    # topology edits from the same surface
    rng = np.random.default_rng(11)
    dmask = rng.random(np.asarray(js2.patch_valid).shape) < 0.2
    jd = jS.remove_isolated_patches(jS.delete_patches(js2, jnp.asarray(dmask)))
    td = tS.remove_isolated_patches(tS.delete_patches(_port_surface(js2),
                                                      _t(dmask)))
    _same_surface(td, jd)
    delta = rng.normal(size=np.asarray(js2.nodes).shape) * 0.01
    _same_surface(tS.update_nodes(_port_surface(js2), _t(delta)),
                  jS.update_nodes(js2, jnp.asarray(delta)))


def test_view_scale_space():
    img = _img(40, 52, seed=12)
    cam = tcam.Camera(flen=1.0, rot=np.eye(3), trans=np.zeros(3))
    jv = jviews.make_view(cam, img, dtype=jnp.float64)
    tv = tviews.make_view(cam, img, device="cpu", dtype=torch.float64)
    assert tv.flen() == jv.flen()
    for scale in (2, 3):
        js, ts = jv.at_scale(scale), tv.at_scale(scale)
        _close(ts.image, js.image)
        _close(ts.grad, js.grad)
        _close(ts.hess, js.hess)
