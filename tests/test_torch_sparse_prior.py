"""The sparse-prior mode (`--no-sgm`) of the port against the JAX package,
on the CPU.

Without SGM the optimizer starts a scale coarser from the bundle's
feature splats, tests visibility with the NCC occlusion test, and after
each boundary cut grows the surface (`Surface.expand`), recomputes the
visibility and cuts again. `expand`, `remove_patches_without_nodes` and
the visibility with NCC are held at float64 (masks exactly, nodes to
rtol 1e-12); `optimize_view(use_sgm=False)` from the same
splats, with fixed Newton steps, to the optimizer bar of
tests/test_torch_pipeline.py (the same mask, rtol 1.5e-3, fewer than 10%
of pixels drifting by more than 2e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.surface import state as jS
from smvs_tpu_torch import convert
from smvs_tpu_torch.pipeline import optimizer as tO
from smvs_tpu_torch.surface import state as tS
from torch_threads import one_torch_thread  # noqa: F401


def _surface(js):
    return convert.surface(
        np.asarray(js.nodes), np.asarray(js.node_valid),
        np.asarray(js.patch_valid),
        {f: getattr(js, f) for f in ("scale", "width", "height", "start_x",
                                     "start_y")}, "cpu")


def _same(ts, js, rtol):
    np.testing.assert_array_equal(ts.node_valid.numpy(),
                                  np.asarray(js.node_valid))
    np.testing.assert_array_equal(ts.patch_valid.numpy(),
                                  np.asarray(js.patch_valid))
    want = np.asarray(js.nodes)
    np.testing.assert_allclose(ts.nodes.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _sparse_depth(seed, dim=96, keep=0.03):
    """A slanted, bumpy depth sampled at a few pixels, as splats are."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:dim, 0:dim]
    depth = 5.0 + 0.01 * x - 0.006 * y + 0.2 * np.sin(x / 9.0) * np.cos(
        y / 7.0)
    depth[rng.random(depth.shape) > keep] = 0.0
    return depth


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [3, 4])
def test_expand_matches_jax(seed, scale):
    """Two expansions in a row from a sparse surface: masks exactly,
    nodes to rtol 1e-12 (float64)."""
    depth = _sparse_depth(seed, dim=160, keep=0.03 if scale == 3 else 0.01)
    js = jS.create_from_depth(jnp.asarray(depth), scale)
    ts = _surface(js)
    before = int(ts.patch_valid.sum())
    for _ in range(2):
        js, ts = jS.expand(js), tS.expand(ts)
        _same(ts, js, 1e-12)
    assert int(ts.patch_valid.sum()) > before


def test_remove_patches_without_nodes_matches_jax():
    js = jS.create_from_depth(jnp.asarray(_sparse_depth(3, keep=0.2)), 3)
    rng = np.random.default_rng(4)
    drop = rng.random(np.asarray(js.node_valid).shape) < 0.1
    js = dataclasses.replace(js, node_valid=js.node_valid & ~drop)
    ts = _surface(js)
    want = jS.remove_patches_without_nodes(js)
    got = tS.remove_patches_without_nodes(ts)
    _same(got, want, 0)
    assert int(got.patch_valid.sum()) < int(ts.patch_valid.sum())


def test_visibility_with_ncc_matches_jax():
    """The visibility pass without SGM: the z-buffer of the surface alone
    and the NCC occlusion test, float64. On the true surface every
    neighbor patch correlates with the main view's, so the test is also
    given one neighbor's image inverted (1 - image), where every textured
    patch correlates negatively and loses that neighbor."""
    scene = jsyn.make_plane_scene(n_views=3, dim=96)
    jm = [jviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                           dtype=jnp.float64) for i in (1, 0, 2)]
    tm = [convert.view(dataclasses.asdict(scene.cameras[i]),
                       scene.images[i], view_id=i, device="cpu")
          for i in (1, 0, 2)]
    for v in tm:
        v.image = v.image.double()
    js = jS.create_from_depth(jnp.asarray(scene.depths[1]), 3)
    jview = jO._build_viewset(jm[0], jm[1:], 3, False, jnp.float64)
    tview = tO._build_viewset(tm[0], tm[1:], 3, torch.float64)
    _, geo = tO.compute_visibility(_surface(js), tview, None)
    for invert in (False, True):
        jsub = jnp.stack([v.at_scale(3).image for v in jm[1:]])
        tsub = torch.stack([v.at_scale(3).image for v in tm[1:]])
        if invert:
            jsub, tsub = jsub.at[1].set(1.0 - jsub[1]), tsub.clone()
            tsub[1] = 1.0 - tsub[1]
        jsurf, jvis = jO.compute_visibility(js, jview, None, False,
                                            jm[0].at_scale(3).image, jsub)
        tsurf, tvis = tO.compute_visibility(
            _surface(js), tview, None, (tm[0].at_scale(3).image, tsub))
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
        _same(tsurf, jsurf, 1e-12)
        if invert:
            assert not tvis[..., 1].any() and tvis[..., 0].any()
            assert int(tvis.sum()) < int(geo.sum())
        else:
            np.testing.assert_array_equal(tvis.numpy(), geo.numpy())


def test_optimize_view_from_sparse_splats():
    """`optimize_view(use_sgm=False)` on the 3-view plane scene from 400
    splats of the analytic depth: 3 fixed Newton steps per iteration, 2
    iterations per scale, scales 5 to 3 (the sparse prior starts a scale
    above `initial_scale`). The optimizer bar of
    tests/test_torch_pipeline.py."""
    dim = 128
    scene = jsyn.make_plane_scene(n_views=3, dim=dim)
    rng = np.random.default_rng(5)
    prior = np.zeros((dim, dim), np.float32)
    ys, xs = rng.integers(2, dim - 2, size=(2, 400))
    prior[ys, xs] = scene.depths[1][ys, xs]
    fields = dict(regularization=0.01, num_iterations=2, min_scale=3,
                  use_sgm=False, max_newton_steps=3, fixed_newton_steps=True)
    jm = [jviews.make_view(scene.cameras[i], scene.images[i], view_id=i)
          for i in (1, 0, 2)]
    want = np.asarray(jO.optimize_view(
        jm[0], jm[1:], jO.OptimizerOptions(**fields),
        init_depth=jnp.asarray(prior)).depth)
    tm = [convert.view(dataclasses.asdict(scene.cameras[i]),
                       scene.images[i], view_id=i, device="cpu")
          for i in (1, 0, 2)]
    got = tO.optimize_view(tm[0], tm[1:],
                           convert.options(tO.OptimizerOptions, fields),
                           device="cpu", init_depth=prior).depth.numpy()
    assert (want > 0).mean() > 0.5
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1.5e-3, atol=1e-6)
    drift = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert (drift > 2e-4).mean() < 0.10, (drift > 2e-4).mean()


def test_optimize_view_needs_its_init():
    scene = jsyn.make_plane_scene(n_views=2, dim=32)
    v = convert.view(dataclasses.asdict(scene.cameras[0]), scene.images[0],
                     device="cpu")
    with pytest.raises(ValueError, match="init_depth"):
        tO.optimize_view(v, [v], tO.OptimizerOptions(use_sgm=False),
                         device="cpu")
    with pytest.raises(ValueError, match="sgm_depth"):
        tO.optimize_view(v, [v], tO.OptimizerOptions(use_sgm=True),
                         device="cpu")
