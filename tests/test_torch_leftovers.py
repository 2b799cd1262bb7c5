"""The port's counterparts of the JAX package's smaller pieces off the
default path, each against the JAX package on the CPU: the cost-space
interpolated SGM cost (`SGMOptions.cost_interp`), the debug sphere
render of `-d` above 1 (the CLI's debug images are held in
tests/test_torch_cli.py), the constant-OMEGA multigrid and the flexible
PCG, `device_trace`, `degrade_scene`, `mean_curvature`, the bicubic
patch evaluation and power-basis fit, `Surface.num_valid_nodes` and the
legacy `.mve` writer.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import scene as jsc
from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.geometry import normals as jnormals
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.sgm import stereo as jst
from smvs_tpu.solver import cg as jcg
from smvs_tpu.solver import mg as jmg
from smvs_tpu.solver import stencil as jstencil
from smvs_tpu.surface import bicubic as jbic
from smvs_tpu.surface import state as jS
from smvs_tpu_torch.core import scene as tsc
from smvs_tpu_torch.core import synthetic as tsyn
from smvs_tpu_torch.geometry import normals as tnormals
from smvs_tpu_torch.image import ops as tops
from smvs_tpu_torch.pipeline import optimizer as tO
from smvs_tpu_torch.pipeline.views import make_view
from smvs_tpu_torch.sgm import rectify as tR
from smvs_tpu_torch.sgm import stereo as tstereo
from smvs_tpu_torch.solver import cg as tcg
from smvs_tpu_torch.solver import mg as tmg
from smvs_tpu_torch.solver import stencil as tstencil
from smvs_tpu_torch.surface import bicubic as tbic
from smvs_tpu_torch.surface import state as tS
from smvs_tpu_torch.utils.timing import device_trace
from test_torch_solver import _close, _problem, _t
from torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# (a) SGMOptions.cost_interp


@pytest.fixture(scope="module")
def plane_half():
    """The 5-view 160 px plane scene of tests/test_torch_cli_batch.py at
    its SGM scale (80 px)."""
    scene = tsyn.make_plane_scene(n_views=5, dim=160)
    imgs = [torch.as_tensor(np.clip(im * 255.0, 0, 255).astype(np.uint8)
                            .astype(np.float32)) for im in scene.images]
    return scene, [tops.rescale_half_size(im) for im in imgs]


@pytest.mark.parametrize("pair", [(1, 2), (1, 0)])
def test_cost_interp_volume_equals_jax(plane_half, pair):
    """Both directions' cost volumes bit-equal to the jitted JAX
    `_disparity_cost_interp` on the same rectified images (the rotated
    pair (1, 2) and the pair (1, 0), whose neighbor canvas is widened)."""
    scene, half = plane_half
    a, b = pair
    rp = tR.rectify_pair(scene.cameras[a], scene.cameras[b], 80, 80,
                         (3.4, 25.8), (3.4, 25.6))
    assert rp.valid
    P = torch.as_tensor(tstereo._pair_params(rp, 128))
    main_r = tR.warp_homography(half[a], P[0:9].reshape(3, 3))
    nbr_r = tR.warp_homography(half[b], P[9:18].reshape(3, 3),
                               out_width=80 + 2 * rp.nbr_pad)
    shifts = tops.fma(P[33], torch.arange(128, dtype=torch.float32), P[32])
    jcost = jax.jit(lambda m, n, s: jst._disparity_cost_interp(
        *jst.census_transform(m), n, s))
    for m, n, s in ((main_r, nbr_r, shifts), (nbr_r, main_r, -shifts)):
        got = tstereo._disparity_cost_interp(tstereo.census_transform(m), n,
                                             s)
        want = jcost(jnp.asarray(m.numpy()), jnp.asarray(n.numpy()),
                     jnp.asarray(s.numpy()))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reconstruct_auto_cost_interp_matches_jax_dim96():
    """`reconstruct_auto` with `cost_interp` against JAX's at dim 96, by
    the bars of `test_reconstruct_auto_matches_jax_dim96` for the default
    cost (tests/test_torch_sgm.py)."""
    dim = 96
    slope = 0.005 * 460.0 / dim
    scene = jsyn.make_two_view_scene(
        dim=dim, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    main = scene.images[1] * np.float32(255.0)
    nbr = scene.images[0] * np.float32(255.0)
    want = np.asarray(jst.reconstruct_auto(
        scene.cameras[1], scene.cameras[0], jnp.asarray(main),
        jnp.asarray(nbr), (3.5, 9.5), (3.5, 9.5),
        jst.SGMOptions(cost_interp=True)))
    got = tstereo.reconstruct_auto(
        scene.cameras[1], scene.cameras[0], torch.from_numpy(main),
        torch.from_numpy(nbr), (3.5, 9.5), (3.5, 9.5),
        tstereo.SGMOptions(cost_interp=True), device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (want > 0).mean() > 0.5
    assert ((got > 0) == (want > 0)).mean() >= 0.995
    both = (got > 0) & (want > 0)
    close = np.abs(got[both] - want[both]) <= 1e-4 * np.abs(want[both])
    assert close.mean() >= 0.99


# ---------------------------------------------------------------------------
# (b) the debug sphere render of -d above 1


def test_render_lighting_sphere_matches_jax():
    params = np.random.default_rng(5).normal(size=16) * 0.3
    want = np.asarray(jO.render_lighting_sphere(jnp.asarray(params)))
    got = tO.render_lighting_sphere(torch.from_numpy(params)).numpy()
    assert got.shape == want.shape == (555, 555)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == 0, want == 0)


# ---------------------------------------------------------------------------
# (c) SMVS_MG_OMEGA=const and the flexible PCG, float64 as
# tests/test_torch_solver.py holds the default ones


@pytest.fixture(scope="module")
def system64():
    js, _, jview, _, vis, active = _problem(scale=2)
    from smvs_tpu.solver import gn as jgn
    g, Hb = jgn.assemble(js, jview, jnp.asarray(vis), jnp.asarray(active),
                         jgn.GNOptions())
    return np.asarray(g), np.asarray(Hb), active


def test_mg_constant_omega_matches_jax(system64, monkeypatch):
    g, Hb, active = system64
    monkeypatch.setattr(jmg, "_OMEGA_POLICY", "const")
    monkeypatch.setattr(tmg, "_OMEGA_POLICY", "const")
    tl = tmg.build(_t(Hb), _t(active))
    jl = jmg.build(jnp.asarray(Hb), jnp.asarray(active))
    assert len(tl.omegas) == len(jl.omegas) >= 2
    for a, b in zip(tl.omegas, jl.omegas):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(a.max()) == float(a.min()) == tmg.OMEGA
    r = np.random.default_rng(2).normal(size=g.shape)
    _close(tmg.apply(tl, _t(r)), jmg.apply(jl, jnp.asarray(r)))


@pytest.mark.parametrize("policy", ["rel", "const"])
def test_cg_flexible_matches_jax(system64, monkeypatch, policy):
    g, Hb, active = system64
    monkeypatch.setattr(jmg, "_OMEGA_POLICY", policy)
    monkeypatch.setattr(tmg, "_OMEGA_POLICY", policy)
    jH, tH = jnp.asarray(Hb), _t(Hb)
    jl, tl = jmg.build(jH, jnp.asarray(active)), tmg.build(tH, _t(active))
    gnorm = float(np.linalg.norm(g))
    want = jcg.solve(lambda x: jstencil.spmv(jH, x), -jnp.asarray(g),
                     precond=lambda x: jmg.apply(jl, x),
                     error_tolerance=gnorm * 1e-4, q_tolerance=1e-6,
                     flexible=True)
    got = tcg.solve(lambda x: tstencil.spmv(tH, x), -_t(g),
                    precond=lambda x: tmg.apply(tl, x),
                    error_tolerance=gnorm * 1e-4, q_tolerance=1e-6,
                    flexible=True)
    assert got.iterations == int(want.iterations) > 1
    _close(got.x, want.x)
    _close(got.residual, want.residual)


# ---------------------------------------------------------------------------
# (d) device_trace


def test_device_trace(tmp_path):
    with device_trace(None):
        x = torch.ones(4) * 2
    assert float(x.sum()) == 8.0
    out = tmp_path / "trace"
    with device_trace(str(out)):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# (e) degrade_scene


def test_degrade_scene_equals_jax():
    for kw in (dict(noise_std=0.01, seed=3),
               dict(exposure_delta=0.04, gamma_err=0.05, seed=4),
               dict(noise_std=0.01, exposure_delta=0.03, seed=5)):
        want = jsyn.degrade_scene(jsyn.make_plane_scene(n_views=3, dim=48),
                                  **kw)
        got = tsyn.degrade_scene(tsyn.make_plane_scene(n_views=3, dim=48),
                                 **kw)
        for a, b in zip(got.images, want.images):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_base_under_exposure_and_gamma():
    """tests/test_robustness.py's exposure/gamma case through the port's
    optimizer, under that test's bars (coverage > 0.3, median relative
    error < 1.5%): the planar start at scale 5, full optimization to
    scale 4, float64."""
    scene = tsyn.degrade_scene(tsyn.make_two_view_scene(dim=232,
                                                        rotate=True),
                               exposure_delta=0.04, gamma_err=0.05, seed=4)
    main = make_view(scene.cameras[1], scene.images[1], view_id=1,
                     device="cpu", dtype=torch.float64)
    sub = make_view(scene.cameras[0], scene.images[0], view_id=0,
                    device="cpu", dtype=torch.float64)
    surf = tS.create_planar(6.0, main.width, main.height, 5,
                            dtype=torch.float64)
    opts = tO.OptimizerOptions(regularization=0.001, num_iterations=10,
                               min_scale=4, use_sgm=False,
                               full_optimization=True, max_newton_steps=50)
    depth = tO.optimize_view(main, [sub], opts, device="cpu",
                             init_surface=surf).depth.numpy()
    mask = depth > 0
    gt = scene.depths[1]
    assert mask.mean() > 0.3
    assert np.median(np.abs(depth[mask] - gt[mask]) / gt[mask]) < 0.015


# ---------------------------------------------------------------------------
# (f) mean_curvature, (g) the bicubic patch, (h) num_valid_nodes


def test_mean_curvature_matches_jax():
    d = np.random.default_rng(6).normal(size=(5, 40))
    want = jnormals.mean_curvature(*(jnp.asarray(x) for x in d))
    got = tnormals.mean_curvature(*(torch.from_numpy(x) for x in d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_bicubic_evaluate_matches_jax():
    rng = np.random.default_rng(7)
    p = rng.normal(size=(3, 16))
    x, y = rng.uniform(size=3), rng.uniform(size=3)
    want = jbic.evaluate(jnp.asarray(p), jnp.asarray(x), jnp.asarray(y))
    got = tbic.evaluate(torch.from_numpy(p), torch.from_numpy(x),
                        torch.from_numpy(y))
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_fit_to_data_recovers_patch():
    """tests/test_bicubic.py's recovery case (reference
    gtest_bicubic_patch.cc:617-717) through the port, and the fitted
    values against JAX's fit."""
    rng = np.random.default_rng(3)
    xs = rng.uniform(size=64)
    ys = rng.uniform(size=64)
    for alpha_true in [
        np.concatenate([[2.0], np.zeros(15)]),
        np.concatenate([[1.0, 0.5], np.zeros(13), [0.25]]),
        rng.normal(size=16),
    ]:
        tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
        data = tbic.evaluate_power(torch.from_numpy(alpha_true), tx, ty)
        np.testing.assert_allclose(
            data.numpy(), np.asarray(jbic.evaluate_power(
                jnp.asarray(alpha_true), jnp.asarray(xs), jnp.asarray(ys))),
            rtol=1e-12)
        alpha = tbic.fit_to_data(tx, ty, data)
        recon = tbic.evaluate_power(alpha, tx, ty).numpy()
        np.testing.assert_allclose(recon, data.numpy(), atol=1e-5)
        jalpha = jbic.fit_to_data(jnp.asarray(xs), jnp.asarray(ys),
                                  jnp.asarray(data.numpy()))
        jrecon = np.asarray(jbic.evaluate_power(jalpha, jnp.asarray(xs),
                                                jnp.asarray(ys)))
        np.testing.assert_allclose(recon, jrecon, atol=1e-9)


def test_num_valid_nodes_matches_jax():
    depth = np.full((96, 96), 5.0, np.float32)
    depth[:30, :40] = 0.0
    js = jS.create_from_depth(jnp.asarray(depth), 3)
    ts = tS.create_from_depth(torch.from_numpy(depth), 3)
    assert ts.num_valid_nodes() == int(js.num_valid_nodes()) > 0
    assert ts.num_valid_nodes() < ts.node_valid.numel()


# ---------------------------------------------------------------------------
# (i) the legacy .mve writer


def test_save_legacy_mve_equals_jax(tmp_path):
    path = str(tmp_path / "scene")
    tsyn.save_as_mve_scene(tsyn.make_plane_scene(n_views=2, dim=24), path)
    jview = jsc.Scene.load(path).views[1]
    tview = tsc.Scene.load(path).views[1]
    for v in (jview, tview):
        v.set_image("depth", np.linspace(1, 2, 24 * 24, dtype=np.float32)
                    .reshape(24, 24))
    jsc.save_legacy_mve(jview, str(tmp_path / "j.mve"))
    tsc.save_legacy_mve(tview, str(tmp_path / "t.mve"))
    with open(tmp_path / "j.mve", "rb") as a, open(tmp_path / "t.mve",
                                                   "rb") as b:
        assert a.read() == b.read()
    for load in (jsc.View.load_legacy, tsc.View.load_legacy):
        back = load(str(tmp_path / "t.mve"))
        assert back.view_id == 1
        assert back.embedding_names() == tview.embedding_names()
        for name in tview.embedding_names():
            np.testing.assert_array_equal(np.asarray(back.get_image(name)),
                                          np.asarray(tview.get_image(name)))
        np.testing.assert_array_equal(back.camera.rot, tview.camera.rot)
