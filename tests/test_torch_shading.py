"""The shading-aware flagship (`-S`) of the port against the JAX package,
on the CPU.

The stages are held tightly at float64 (SH bases, the lighting fit, the
shading term of the Gauss-Newton assembly, the multigrid with constant
damping, one Newton step); the optimizer at scale 3 with fixed Newton
steps against JAX's own sensitivity (see that test for why the ROADMAP's
pixel bar cannot hold there). The whole flagship, whose endpoint is chaotic
(PERF_NOTES.md, r5: a 1e-7 relative change of the init flips its median
error between ~1e-5 and ~5e-3), is held by coverage and error class in
tests/test_torch_shading_flagship.py, the sphere in
tests/test_torch_shading_sphere.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.shading import lighting as jL
from smvs_tpu.shading import sh as jsh
from smvs_tpu.sgm import stereo as jst
from smvs_tpu.solver import gn as jgn
from smvs_tpu.solver import mg as jmg
from smvs_tpu.surface import state as jS
from smvs_tpu_torch import convert
from smvs_tpu_torch.pipeline import optimizer as tO
from smvs_tpu_torch.pipeline import views as tviews
from smvs_tpu_torch.shading import lighting as tL
from smvs_tpu_torch.shading import sh as tsh
from smvs_tpu_torch.solver import gn as tgn
from smvs_tpu_torch.solver import mg as tmg
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    """rtol, with atol rtol x the largest entry for entries that cancel."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit_normals(shape, rng):
    v = rng.normal(size=(*shape, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[..., 2] = -np.abs(v[..., 2])  # camera-facing, like real normal maps
    return v


# ---------------------------------------------------------------------------
# SH bases and the lighting fit


@pytest.mark.parametrize("fn", ["eval_3_band_exact", "eval_3_band",
                                "eval_4_band", "eval_4_band_jac"])
def test_sh_matches_jax(fn):
    """float64, atol 1e-12, on unit and non-unit vectors."""
    rng = np.random.default_rng(0)
    n = np.concatenate([_unit_normals((6, 9), rng),
                        rng.normal(size=(6, 9, 3)) * 1.5], axis=0)
    got = getattr(tsh, fn)(torch.from_numpy(n))
    want = np.asarray(getattr(jsh, fn)(jnp.asarray(n)))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-12)


def test_sh_jacobian_is_the_derivative():
    """The hand-derived table equals forward-mode AD of `eval_4_band`."""
    rng = np.random.default_rng(1)
    n = torch.from_numpy(_unit_normals((20,), rng))
    auto = torch.func.vmap(torch.func.jacfwd(tsh.eval_4_band))(n)
    np.testing.assert_allclose(_np(tsh.eval_4_band_jac(n)), _np(auto),
                               rtol=0, atol=1e-12)


def _fit_inputs(case):
    rng = np.random.default_rng({"holes": 2, "rank_deficient": 3,
                                 "few_valid": 4}[case])
    normals = _unit_normals((48, 40), rng)
    if case == "rank_deficient":
        normals[..., 2] = 0.0  # every normal in one plane: A has rank < 16
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    params = rng.normal(size=16) * 0.05
    params[0] = 0.6
    image = tsh.eval_4_band(torch.from_numpy(normals)).numpy() @ params
    image[::7] = 0.01  # dark rows: below the 0.05 gate
    normals[5:12, 3:20] = np.nan  # unrasterized patches
    normals[20:25] = 0.0  # no surface
    normals[30, :5] *= 1.001  # not unit
    if case == "few_valid":  # 12 valid pixels: fewer than 16 unknowns
        normals[np.arange(48) % 3 != 1] = np.nan
        normals[:, 1:] = np.nan
    return normals, image


@pytest.mark.parametrize("case", ["holes", "rank_deficient", "few_valid"])
def test_fit_lighting_matches_jax(case):
    """float64, rtol 1e-8 (atol 1e-8 of the largest coefficient): NaN holes
    and dark pixels are excluded with a select, never a multiply, and the
    pseudo-inverse cuts singular values where JAX's does."""
    normals, image = _fit_inputs(case)
    want = np.asarray(jL.fit_lighting(jnp.asarray(normals),
                                      jnp.asarray(image)))
    got = tL.fit_lighting(torch.from_numpy(normals), torch.from_numpy(image))
    assert np.isfinite(want).all()
    _close(got, want, rtol=1e-8)
    if case != "holes":
        # The cases the cutoff decides: torch's default cutoff (10x lower)
        # would invert near-zero singular values the JAX fit drops.
        finite = np.isfinite(normals).all(-1)
        nm = np.where(finite[..., None], normals, 0.0)
        valid = finite & (np.abs(np.linalg.norm(nm, axis=-1) - 1) <= 1e-4) \
            & (image >= 0.05)
        basis = tsh.eval_4_band(torch.from_numpy(nm[valid])).numpy()
        assert np.linalg.matrix_rank(basis.T @ basis) < 16


def test_render_normal_map_matches_jax():
    rng = np.random.default_rng(5)
    nm = _unit_normals((12, 10), rng)
    nm[2:4] = 0.0
    nm[5, 5] = np.nan
    nm[7, :3] *= 1.01
    params = rng.normal(size=16)
    want = np.asarray(jL.render_normal_map(jnp.asarray(params),
                                           jnp.asarray(nm)))
    got = tL.render_normal_map(torch.from_numpy(params), torch.from_numpy(nm))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-12)
    assert (want[2:4] == 0).all() and want[5, 5] == 0
    assert (want[7, :3] == 0).all()
    _close(tL.value_for_normal(torch.from_numpy(params),
                               torch.from_numpy(nm[:2])),
           jL.value_for_normal(jnp.asarray(params), jnp.asarray(nm[:2])))


def test_shading_images_match_jax():
    """A gray view's shading image is the image itself, with the
    quadratic-fit gradients; cached. Under `gamma_correction` it is the
    sRGB-decoded image (color views: tests/test_torch_color.py)."""
    scene = jsyn.make_plane_scene(n_views=3, dim=64)
    jv = jviews.make_view(scene.cameras[1], scene.images[1], view_id=1,
                          dtype=jnp.float64)
    tv = tviews.make_view(scene.cameras[1], scene.images[1], view_id=1,
                          device="cpu", dtype=torch.float64)
    (jimg, jgrad), (timg, tgrad) = jv.shading_images(), tv.shading_images()
    _close(timg, jimg)
    _close(tgrad, jgrad)
    assert tv.shading_images()[1] is tgrad
    jg = jviews.make_view(scene.cameras[1], scene.images[1], view_id=1,
                          dtype=jnp.float64, gamma_correction=True)
    tg = tviews.make_view(scene.cameras[1], scene.images[1], view_id=1,
                          device="cpu", dtype=torch.float64,
                          gamma_correction=True)
    (jimg, jgrad), (timg, tgrad) = jg.shading_images(), tg.shading_images()
    _close(timg, jimg)
    _close(tgrad, jgrad)
    assert float((timg - tg.image).abs().max()) > 0.05


# ---------------------------------------------------------------------------
# the shading term of the assembly, the multigrid, one Newton step


def _shading_problem(scale, dim=96):
    """A real shading system on the 3-view plane scene: the surface from
    the analytic depth with smooth 10% bumps, the main view against both
    neighbors, float64, and JAX's lighting fit to that surface. The bumps
    tilt the normals by tens of degrees, so the 16x16 fit is conditioned
    well enough (smallest singular value 6e-8 of the largest) to compare
    coefficients at rtol 1e-8; a plane's or a gently bumped plane's
    normals leave singular values near the pseudo-inverse's cutoff, where
    a summation-order difference moves the coefficients by 1e-4."""
    scene = jsyn.make_plane_scene(n_views=3, dim=dim)
    views = [(jviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                               dtype=jnp.float64),
              tviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                               device="cpu", dtype=torch.float64))
             for i in (1, 0, 2)]
    yy, xx = np.mgrid[0:dim, 0:dim] / dim
    depth = scene.depths[1] * (1.0 + 0.1 * np.sin(3 * np.pi * xx + 0.5)
                               * np.cos(3 * np.pi * yy + 0.3))
    js = jS.create_from_depth(jnp.asarray(depth), scale)
    ts = convert.surface(np.asarray(js.nodes), np.asarray(js.node_valid),
                         np.asarray(js.patch_valid),
                         {f: getattr(js, f) for f in ("scale", "width",
                                                      "height", "start_x",
                                                      "start_y")}, "cpu")
    (jm, tm), subs = views[0], views[1:]
    jview = jO._build_viewset(jm, [v[0] for v in subs], scale, True,
                              jnp.float64)
    tview = tO._build_viewset(tm, [v[1] for v in subs], scale, torch.float64,
                              use_shading=True)
    nmap = jS.normal_map(js, 1.0 / jm.flen())
    lighting = np.asarray(jL.fit_lighting(nmap, jm.shading_images()[0]))
    vis = np.broadcast_to(np.asarray(js.patch_valid)[..., None],
                          (*np.asarray(js.patch_valid).shape, 2)).copy()
    vis[::4, ::3, 1] = False
    active = np.asarray(js.node_valid).copy()
    return dict(js=js, ts=ts, jview=jview, tview=tview, jm=jm, tm=tm,
                lighting=lighting, vis=vis, active=active, nmap=nmap,
                gt=scene.depths[1])


@pytest.fixture(scope="module")
def problem3():
    return _shading_problem(3)


def test_shading_viewset_and_lighting_fit_match(problem3):
    p = problem3
    _close(p["tview"].shading_gi, p["jview"].shading_gi)
    tnm = tO.S.normal_map(p["ts"], 1.0 / p["tm"].flen())
    _close(tnm, p["nmap"])
    got = tL.fit_lighting(tnm, p["tm"].shading_images()[0])
    _close(got, p["lighting"], rtol=1e-8)


@pytest.mark.parametrize("light_surf", [0.0, 50.0])
def test_assemble_with_lighting_matches_jax(problem3, light_surf):
    """float64, rtol 1e-9 on g and H (atol 1e-9 of the largest entry). With
    light_surf_regularization 0 the regularizer is off under shading."""
    p = problem3
    active = p["active"].copy()
    active[::3, ::2] = False  # a partial working set
    opts = dict(regularization=0.01, light_surf_regularization=light_surf)
    g, Hb = jgn.assemble(p["js"], p["jview"], jnp.asarray(p["vis"]),
                         jnp.asarray(active), jgn.GNOptions(**opts),
                         jnp.asarray(p["lighting"]))
    tg, tHb = tgn.assemble(p["ts"], p["tview"], _t(p["vis"]), _t(active),
                           tgn.GNOptions(**opts),
                           convert.lighting(p["lighting"], "cpu"))
    _close(tg, g)
    _close(tHb, Hb)
    # The shading term is in the system: without it, H moves by > 1%.
    base = tgn.assemble(p["ts"], p["tview"], _t(p["vis"]), _t(active),
                        tgn.GNOptions(**opts))[1].numpy()
    assert np.linalg.norm(base - _np(tHb)) > 0.01 * np.linalg.norm(_np(tHb))


@pytest.fixture(scope="module")
def problem2():
    return _shading_problem(2)


def test_multigrid_constant_omega_matches_jax(problem2):
    """`mg.build(damp_rows=False)`, the shading systems' constant OMEGA on
    every level, and its V-cycle, against JAX at float64 (rtol 1e-9)."""
    p = problem2
    g, Hb = jgn.assemble(p["js"], p["jview"], jnp.asarray(p["vis"]),
                         jnp.asarray(p["active"]), jgn.GNOptions(),
                         jnp.asarray(p["lighting"]))
    Hb = np.asarray(Hb)
    jl = jmg.build(jnp.asarray(Hb), jnp.asarray(p["active"]),
                   damp_rows=False)
    tl = tmg.build(_t(Hb), _t(p["active"]), damp_rows=False)
    assert len(tl.ops) == len(jl.ops) >= 2
    for a, b in zip(tl.omegas, jl.omegas):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert (_np(a) == tmg.OMEGA).all()
    for a, b in zip(tl.pinvs, jl.pinvs):
        _close(a, b)
    rng = np.random.default_rng(6)
    r = rng.normal(size=np.asarray(g).shape)
    _close(tmg.apply(tl, _t(r)), jmg.apply(jl, jnp.asarray(r)))
    _close(tmg.apply_vcycle(tl, _t(r)), jmg.apply_vcycle(jl, jnp.asarray(r)))


def test_newton_step_with_lighting_matches_jax(problem3):
    """One shading Newton step (assembly with the shading term, the
    constant-OMEGA multigrid, PCG, the working set) at float64, rtol 1e-9,
    from the analytic plane with the bumped surface's lighting and
    light_surf_regularization 50, where PCG converges (20 iterations).
    Without the regularizer (the flagship's 0) or from the bumped surface,
    this system's PCG runs to its 200-iteration cap in both packages, and
    its iterates drift apart there by summation order (1e-9 to 1e-3 of the
    depth): such steps are held by the optimizer and flagship tests below.
    """
    p = problem3
    js = jS.create_from_depth(jnp.asarray(p["gt"]), 3)
    ts = convert.surface(np.asarray(js.nodes), np.asarray(js.node_valid),
                         np.asarray(js.patch_valid),
                         {f: getattr(js, f) for f in ("scale", "width",
                                                      "height", "start_x",
                                                      "start_y")}, "cpu")
    fields = dict(regularization=0.01, light_surf_regularization=50.0)
    want = jO._newton_step(js, p["jview"], jnp.asarray(p["vis"]),
                           jnp.asarray(p["active"]),
                           jO.OptimizerOptions(**fields),
                           jnp.asarray(p["lighting"]))
    got = tO._newton_step(ts, p["tview"], _t(p["vis"]), _t(p["active"]),
                          tO.OptimizerOptions(**fields),
                          convert.lighting(p["lighting"], "cpu"))
    assert 1 < got.cg_iters < 200
    _close(got.nodes, want[0])
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want[1]))
    assert got.cg_iters == int(want[6])
    assert got.n_active == int(want[5])
    np.testing.assert_allclose(float(got.avg), float(want[3]), rtol=RTOL)


# ---------------------------------------------------------------------------
# the optimizer and the flagship


def _plane3(dim):
    scene = jsyn.make_plane_scene(n_views=3, dim=dim)
    jviews_ = [jviews.make_view(scene.cameras[i], scene.images[i], view_id=i)
               for i in range(3)]
    sgm_depth = np.asarray(jst.reconstruct_auto_multi(
        scene.cameras[1], [scene.cameras[0], scene.cameras[2]],
        jviews_[1].image * 255.0,
        [jviews_[0].image * 255.0, jviews_[2].image * 255.0],
        (3.4, 6.6), [(3.4, 6.6)] * 2))
    tviews_ = [convert.view(dataclasses.asdict(scene.cameras[i]),
                            scene.images[i], view_id=i, device="cpu")
               for i in range(3)]
    return scene, jviews_, tviews_, sgm_depth


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-6)


def test_optimize_view_shading_from_the_same_sgm_depth():
    """The 3-view plane at dim 160 from JAX's SGM depth, 2 iterations of 3
    fixed Newton steps at scales 4 (no lighting yet) and 3 (the lighting
    fit and the shading term), float32 as `optimize_view` runs.

    The ROADMAP's pixel bar (rtol 1.5e-3, < 10% of pixels drifting by
    > 2e-4) does not hold here even for JAX against itself: its own run
    from the SGM depth scaled by 1 + 1e-6 drifts on ~75% of the pixels by
    up to 1.5%, because the plane's lighting fit is ill-conditioned (the
    16x16 normal matrix of near-equal normals has singular values at the
    float32 pseudo-inverse's cutoff) and the shading systems' PCG runs to
    its 200-iteration cap. So the port is held to JAX's own envelope:
    the same coverage mask; its largest and median relative difference
    from JAX at most twice JAX's own under that 1e-6 change; and the
    shading its lighting renders on JAX's normals within twice JAX's own
    change of it. `test_newton_step_with_lighting_matches_jax` and the
    assembly tests hold the stages to rtol 1e-9 at float64.
    """
    scene, jv, tv, sgm_depth = _plane3(160)
    fields = dict(regularization=0.01, light_surf_regularization=0.0,
                  num_iterations=2, min_scale=3, use_sgm=True,
                  use_shading=True, max_newton_steps=3,
                  fixed_newton_steps=True)
    jopts = jO.OptimizerOptions(**fields)
    want = jO.optimize_view(jv[1], [jv[0], jv[2]], jopts,
                            sgm_depth=jnp.asarray(sgm_depth))
    moved = jO.optimize_view(jv[1], [jv[0], jv[2]], jopts,
                             sgm_depth=jnp.asarray(
                                 sgm_depth * np.float32(1 + 1e-6)))
    got = tO.optimize_view(tv[1], [tv[0], tv[2]],
                           convert.options(tO.OptimizerOptions, fields),
                           sgm_depth=sgm_depth, device="cpu")
    wd, md, gd = (np.asarray(want.depth), np.asarray(moved.depth),
                  got.depth.numpy())
    assert gd.dtype == np.float32 and (wd > 0).mean() > 0.5
    np.testing.assert_array_equal(gd > 0, wd > 0)
    m = wd > 0
    own, port = _rel(md[m], wd[m]), _rel(gd[m], wd[m])
    assert own.max() > 1e-3  # the envelope is real on this scene
    assert port.max() <= 2 * own.max(), (port.max(), own.max())
    assert np.median(port) <= 2 * np.median(own), (np.median(port),
                                                   np.median(own))

    # JAX's result carried into the port's DepthResult; the lightings'
    # renders of its normals in float64.
    jres = convert.depth_result(np.asarray(want.depth),
                                np.asarray(want.normals), got.surface,
                                np.asarray(want.lighting))
    normals = jres.normals.double()

    def render(params):
        return tL.render_normal_map(torch.as_tensor(np.asarray(params),
                                                    dtype=torch.float64),
                                    normals).numpy()

    ref = render(jres.lighting)
    lit = ref != 0
    assert lit.mean() > 0.5
    own_l = _rel(render(moved.lighting)[lit], ref[lit])
    port_l = _rel(render(got.lighting)[lit], ref[lit])
    assert np.median(port_l) <= 2 * np.median(own_l), (np.median(port_l),
                                                       np.median(own_l))
