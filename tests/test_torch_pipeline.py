"""The port's main path against the JAX package, on the CPU.

The optimizer is compared from the same SGM depth (JAX's, as numpy), with a
fixed number of Newton steps so that float32 reduction order cannot flip an
iteration count; the whole `run_once` (SGM, then the optimizer) is held
to the JAX run's coverage and median error on the analytic depth.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.sgm import stereo as jst
from smvs_tpu.surface import state as jS
from smvs_tpu_torch import bench_main, convert
from smvs_tpu_torch.pipeline import optimizer as tO
from smvs_tpu_torch.pipeline import views as tviews
from torch_threads import one_torch_thread  # noqa: F401

DIM = 128


def _scene(dim=DIM):
    slope = 0.005 * 460.0 / dim
    return jsyn.make_two_view_scene(
        dim=dim, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)


def _jax_views(scene):
    return (jviews.make_view(scene.cameras[1], scene.images[1], view_id=1),
            jviews.make_view(scene.cameras[0], scene.images[0], view_id=0))


def _jax_sgm(scene, main_v, sub_v):
    return jst.reconstruct_auto(scene.cameras[1], scene.cameras[0],
                                main_v.image * 255.0, sub_v.image * 255.0,
                                range_main=(3.5, 9.5), range_nbr=(3.5, 9.5))


def _coverage_and_error(depth, gt):
    mask = depth > 0
    rel = np.abs(depth[mask] - gt[mask]) / gt[mask]
    return float(mask.mean()), float(np.median(rel))


def _close(got, want, rtol=1e-9):
    """float64 on both sides: rtol 1e-9, with atol 1e-9 of the largest
    entry for entries that cancel to ~0."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _same_surface(ts, js):
    np.testing.assert_array_equal(ts.node_valid.numpy(),
                                  np.asarray(js.node_valid))
    np.testing.assert_array_equal(ts.patch_valid.numpy(),
                                  np.asarray(js.patch_valid))
    _close(ts.nodes, js.nodes)


def test_visibility_and_boundary_cuts_float64():
    """The optimizer's visibility z-buffer, boundary cuts and patch scores
    on the same float64 surface: a noisy depth with a hole, and then a
    depth jump in the nodes, so that patches are cut."""
    scene = _scene(96)
    rng = np.random.default_rng(0)
    depth = scene.depths[1] * (1.0 + 0.002 * rng.standard_normal(
        scene.depths[1].shape))
    depth[30:50, 20:45] = 0.0
    jm, js_ = (jviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                                dtype=jnp.float64) for i in (1, 0))
    tm, ts_ = (convert.view(dataclasses.asdict(scene.cameras[i]),
                            scene.images[i], view_id=i, device="cpu")
               for i in (1, 0))
    tm.image, ts_.image = tm.image.double(), ts_.image.double()
    jsurf = jS.create_from_depth(jnp.asarray(depth), 3)
    tsurf = convert.surface(
        np.asarray(jsurf.nodes), np.asarray(jsurf.node_valid),
        np.asarray(jsurf.patch_valid),
        {f: getattr(jsurf, f) for f in ("scale", "width", "height",
                                        "start_x", "start_y")}, "cpu")
    jview = jO._build_viewset(jm, [js_], 3, False, jnp.float64)
    tview = tO._build_viewset(tm, [ts_], 3, torch.float64)

    jzb = jO.zbuffer_scatter(jview, jnp.asarray(depth))
    tzb = tO.zbuffer_scatter(tview, torch.from_numpy(depth))
    _close(tzb, jzb)

    jsurf, jvis = jO.compute_visibility(
        jsurf, jview, None, True, jm.at_scale(3).image,
        jnp.stack([js_.at_scale(3).image]), sgm_zbuffer=jzb)
    tsurf, tvis = tO.compute_visibility(tsurf, tview, tzb)
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    _same_surface(tsurf, jsurf)
    assert 0 < int(tvis.sum()) < tvis.numel()

    sel = np.asarray(jsurf.patch_valid).copy()
    sel[::2] = False
    for cap in (None, int(sel.sum()) // 2):
        _close(tO.patch_mse(tsurf, tview, tvis, select=torch.from_numpy(sel),
                            capacity=cap),
               jO.patch_mse(jsurf, jview, jvis, select=jnp.asarray(sel),
                            capacity=cap))
    _close(tO.patch_tex_score(tsurf, tm.image),
           jO.patch_tex_score(jsurf, jm.image))

    jsurf = dataclasses.replace(jsurf,
                                nodes=jsurf.nodes.at[:, 6:, 0].multiply(1.5))
    tsurf.nodes[:, 6:, 0] *= 1.5
    inv_cal = jm.camera.inverse_calibration(96, 96)
    jcut, jdel = jO.cut_boundaries(jsurf, jview, jvis, inv_cal)
    tcut, tdel = tO.cut_boundaries(tsurf, tview, tvis,
                                   torch.from_numpy(inv_cal))
    assert tdel == int(jdel) > 0
    _same_surface(tcut, jcut)


def test_optimize_view_from_the_same_sgm_depth():
    """Same SGM depth in, 3 fixed Newton steps per iteration, 2 iterations
    per scale, scales 4 and 3. Bounds of the JAX package's own
    sharded-vs-sequential harness: the same coverage mask, rtol 1.5e-3,
    and < 10% of pixels drifting by more than 2e-4 (float32 sums in another
    order, bf16 gather on both sides).

    Scale 2 is left to the `run_once` test below: there the float32 CG
    exits (the Nash test on a difference of two nearly equal quadratic
    values) fall several iterations apart between the two frameworks, and
    a weakly constrained corner patch drifts to ~1.9e-3 after 3 steps.
    """
    scene = _scene()
    jmain, jsub = _jax_views(scene)
    sgm_depth = np.asarray(_jax_sgm(scene, jmain, jsub))
    fields = dict(regularization=0.01, num_iterations=2, min_scale=3,
                  use_sgm=True, max_newton_steps=3, fixed_newton_steps=True)
    want = np.asarray(jO.optimize_view(jmain, [jsub], jO.OptimizerOptions(
        **fields), sgm_depth=jnp.asarray(sgm_depth)).depth)
    tmain, tsub = (convert.view(dataclasses.asdict(scene.cameras[i]),
                                scene.images[i], view_id=i, device="cpu")
                   for i in (1, 0))
    got = tO.optimize_view(tmain, [tsub],
                           convert.options(tO.OptimizerOptions, fields),
                           sgm_depth=sgm_depth, device="cpu").depth.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (want > 0).mean() > 0.5
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1.5e-3, atol=1e-6)
    drift = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert (drift > 2e-4).mean() < 0.10, (drift > 2e-4).mean()


def test_run_once_matches_jax_dim128():
    """The whole main path: coverage within 0.02 of JAX's and median
    relative error at most twice JAX's (JAX gives 0.810 / 3.1e-4 here)."""
    scene = _scene()
    jmain, jsub = _jax_views(scene)
    sgm_depth = _jax_sgm(scene, jmain, jsub)
    opts = jO.OptimizerOptions(regularization=0.01, num_iterations=5,
                               min_scale=2, use_sgm=True,
                               full_optimization=False)
    depth = np.asarray(jO.optimize_view(jmain, [jsub], opts,
                                        sgm_depth=sgm_depth).depth)
    j_cov, j_err = _coverage_and_error(depth, scene.depths[1])
    _, _, t_cov, t_err = bench_main.run_once(DIM, 2, device="cpu")
    assert j_cov > 0.7
    assert abs(t_cov - j_cov) <= 0.02, (t_cov, j_cov)
    assert t_err <= 2.0 * j_err, (t_err, j_err)


def test_entry_points_need_a_gpu_or_a_device(monkeypatch):
    scene = jsyn.make_two_view_scene(dim=32, texture="noise")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviews.make_view(scene.cameras[0], scene.images[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_main.run_once(32, 2)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        tviews.make_view(scene.cameras[0], scene.images[0], device="cuda")


def test_unported_modes_raise():
    """The two modes that raised before are ported and held against JAX
    here: under shading, the sRGB decode of the shading image
    (`gamma_correction`) in the view set's shading channels (float64,
    rtol 1e-9), and the sparse-prior mode (`use_sgm=False`) from a
    constant depth prior at dim 128, 2 fixed Newton steps per iteration at
    scales 5-4, to the optimizer bar (the same mask, rtol 1.5e-3, < 10% of
    pixels beyond 2e-4). Unknown option fields still raise."""
    scene = jsyn.make_plane_scene(n_views=2, dim=64)
    jv = [jviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                           dtype=jnp.float64, gamma_correction=True)
          for i in (1, 0)]
    tv = [tviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                           device="cpu", dtype=torch.float64,
                           gamma_correction=True) for i in (1, 0)]
    want = jO._build_viewset(jv[0], jv[1:], 3, True, jnp.float64)
    got = tO._build_viewset(tv[0], tv[1:], 3, torch.float64,
                            use_shading=True)
    _close(got.shading_gi, want.shading_gi)

    scene = _scene()
    jmain, jsub = _jax_views(scene)
    prior = np.full((DIM, DIM), 5.5, np.float32)
    fields = dict(regularization=0.01, num_iterations=2, min_scale=4,
                  use_sgm=False, max_newton_steps=2, fixed_newton_steps=True)
    want = np.asarray(jO.optimize_view(jmain, [jsub], jO.OptimizerOptions(
        **fields), init_depth=jnp.asarray(prior)).depth)
    tmain, tsub = (convert.view(dataclasses.asdict(scene.cameras[i]),
                                scene.images[i], view_id=i, device="cpu")
                   for i in (1, 0))
    got = tO.optimize_view(tmain, [tsub],
                           convert.options(tO.OptimizerOptions, fields),
                           device="cpu", init_depth=prior).depth.numpy()
    assert (want > 0).mean() > 0.3
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1.5e-3, atol=1e-6)
    drift = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert (drift > 2e-4).mean() < 0.10, (drift > 2e-4).mean()
    with pytest.raises(ValueError, match="no fields"):
        convert.options(tO.OptimizerOptions, {"use_lighting": True})
