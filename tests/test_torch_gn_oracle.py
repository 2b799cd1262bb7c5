"""The port's autodiff oracle (`GNOptions(analytic=False)`) and its
Hessian-routed samplers against the JAX package, on the CPU.

The samplers' derivatives are the sampled image Hessian (forward and
reverse mode) and equal `jax.jvp` of JAX's `custom_jvp` functions. The
oracle's (g, H) equal the JAX oracle's in float64 to 1e-10 of the largest
entry, and the port's own closed-form assembly to JAX's bar of 1e-9
(tests/test_gn_analytic.py), on the four problems of that test. In
float32 with the bf16 sampling image the oracle is held to twice the
distance between JAX's float32 and float64 oracles (`F32_ENVELOPE`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core.synthetic import make_plane_scene
from smvs_tpu.image import ops as jops
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline.views import make_view
from smvs_tpu.solver import gn as jgn
from smvs_tpu.surface import state as jS
from smvs_tpu_torch import convert
from smvs_tpu_torch.image import ops as tops
from smvs_tpu_torch.solver import gn as tgn
from smvs_tpu_torch.surface.state import stack_surfaces
from torch_threads import one_torch_thread  # noqa: F401

CASES = [(1, False), (3, False), (1, True), (2, True)]
JAX_OPTS = jgn.GNOptions(regularization=0.013, light_surf_regularization=0.5,
                         analytic=False)
PORT_OPTS = tgn.GNOptions(regularization=0.013, light_surf_regularization=0.5,
                          analytic=False)

# max |g32 - g64| / max |g64| and the same for H, JAX's float32 oracle with
# the bf16 sampling image against its float64 oracle, measured on these
# problems (2.97e-3 / 3.44e-3 and 1.13e-3 / 5.71e-4), rounded up.
F32_ENVELOPE = {(1, True): (3.0e-3, 3.5e-3), (2, True): (1.2e-3, 6.0e-4)}


def _scaled(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


@functools.lru_cache(maxsize=None)
def _jax_problem(n_views, use_shading, f32=False, dim=96, scale=3):
    """tests/test_gn_analytic.py's problem: the plane scene's true surface,
    seeded random visibility and lighting; float32 reads the bf16 image."""
    dtype = jnp.float32 if f32 else jnp.float64
    scene = make_plane_scene(n_views=n_views + 1, dim=dim)
    main = make_view(scene.cameras[0], scene.images[0], view_id=0,
                     dtype=dtype)
    subs = [make_view(scene.cameras[i], scene.images[i], view_id=i,
                      dtype=dtype) for i in range(1, n_views + 1)]
    surf = jS.create_from_depth(jnp.asarray(scene.depths[0], dtype), scale)
    view = jO._build_viewset(main, subs, scale, use_shading, dtype,
                             bf16_gather=f32)
    rng = np.random.default_rng(7)
    vis = jnp.asarray(
        rng.uniform(size=(*surf.patch_valid.shape, n_views)) > 0.2)
    vis = vis & surf.patch_valid[..., None]
    lighting = None
    if use_shading:
        lighting = jnp.asarray(rng.normal(size=16) * 0.1 + 0.3, dtype)
    return surf, view, vis, lighting


@functools.lru_cache(maxsize=None)
def _jax_oracle(n_views, use_shading, f32=False):
    surf, view, vis, lighting = _jax_problem(n_views, use_shading, f32)
    g, H = jgn.assemble(surf, view, vis, surf.node_valid, JAX_OPTS, lighting)
    return np.asarray(g), np.asarray(H)


def _port_problem(n_views, use_shading, f32=False):
    """The same problem carried into the port: (surf, view, vis, active,
    lighting)."""
    surf, view, vis, lighting = _jax_problem(n_views, use_shading, f32)
    meta = {f: getattr(surf, f) for f in ("scale", "width", "height",
                                          "start_x", "start_y")}
    ts = convert.surface(np.asarray(surf.nodes), np.asarray(surf.node_valid),
                         np.asarray(surf.patch_valid), meta, "cpu")
    tv = convert.viewset(view.grad_main, view.sub_gh, view.M, view.t,
                         view.flen, "cpu", shading_gi=view.shading_gi)
    tl = None if lighting is None else convert.lighting(
        np.asarray(lighting), "cpu", ts.nodes.dtype)
    return (ts, tv, convert.tensor(vis, "cpu"),
            convert.tensor(surf.node_valid, "cpu"), tl)


# ---------------------------------------------------------------------------
# the Hessian-routed samplers


def _images(seed=1, h=10, w=11):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, h, w)), rng.normal(size=(3, h, w))


def _points(n=200, seed=2, h=10, w=11):
    rng = np.random.default_rng(seed)
    # inside, on and beyond the clamped border
    return (rng.uniform(-1.0, w, n), rng.uniform(-1.0, h, n),
            rng.normal(size=n), rng.normal(size=n))


def _samplers(grad, hess):
    """(name, port function of (x, y), JAX function of (x, y))."""
    tg, th = torch.from_numpy(grad), torch.from_numpy(hess)
    jg, jh = jnp.asarray(grad), jnp.asarray(hess)
    tgh, jgh = tops.pack_gradhess(tg, th), jops.pack_gradhess(jg, jh)
    return [
        ("sample_gradient", lambda x, y: tops.sample_gradient(tg, th, x, y),
         lambda x, y: jops.sample_gradient(jg, jh, x, y)),
        ("sample_gradient_packed",
         lambda x, y: tops.sample_gradient_packed(tgh, x, y),
         lambda x, y: jops.sample_gradient_packed(jgh, x, y)),
    ]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("mode", ["jacfwd", "jacrev"])
def test_sampler_derivative_is_sampled_hessian(which, mode):
    """As tests/test_image_ops.py holds JAX's sample_gradient: the
    derivative in the position is the sampled image Hessian."""
    grad, hess = _images()
    _, fn, _ = _samplers(grad, hess)[which]
    xy = torch.tensor([4.3, 5.6], dtype=torch.float64)
    jac = getattr(torch.func, mode)(lambda p: fn(p[0], p[1]))(xy)
    th = torch.from_numpy(hess)
    hxx, hxy, hyy = (float(tops.bilinear(th[i], xy[0], xy[1]))
                     for i in range(3))
    np.testing.assert_allclose(jac.numpy(),
                               np.array([[hxx, hxy], [hxy, hyy]]), rtol=1e-9)


@pytest.mark.parametrize("which", [0, 1])
def test_sampler_jvp_matches_jax_float64(which):
    grad, hess = _images()
    x, y, dx, dy = _points()
    _, tfn, jfn = _samplers(grad, hess)[which]
    t_out, t_tan = torch.func.jvp(tfn, tuple(map(torch.from_numpy, (x, y))),
                                  tuple(map(torch.from_numpy, (dx, dy))))
    j_out, j_tan = jax.jvp(jfn, tuple(map(jnp.asarray, (x, y))),
                           tuple(map(jnp.asarray, (dx, dy))))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-12)
    np.testing.assert_allclose(t_tan.numpy(), np.asarray(j_tan), rtol=1e-12)


def test_sampler_jvp_matches_jax_bf16():
    """The bf16 x-paired image: gathered in bf16 (the same bits on both
    sides), blended and differentiated in float32."""
    grad, hess = _images()
    x, y, dx, dy = (a.astype(np.float32) for a in _points())
    t10 = tops.pack_gradhess_pair10(torch.from_numpy(grad).float(),
                                    torch.from_numpy(hess).float())
    j10 = jops.pack_gradhess_pair10(jnp.asarray(grad, jnp.float32),
                                    jnp.asarray(hess, jnp.float32))
    np.testing.assert_array_equal(
        t10.view(torch.int16).numpy(),
        np.asarray(j10).view(np.int16))
    t_out, t_tan = torch.func.jvp(
        lambda a, b: tops.sample_gradient_packed(t10, a, b),
        tuple(map(torch.from_numpy, (x, y))),
        tuple(map(torch.from_numpy, (dx, dy))))
    j_out, j_tan = jax.jvp(
        lambda a, b: jops.sample_gradient_packed(j10, a, b),
        tuple(map(jnp.asarray, (x, y))), tuple(map(jnp.asarray, (dx, dy))))
    assert t_out.dtype == t_tan.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-6)
    np.testing.assert_allclose(t_tan.numpy(), np.asarray(j_tan), rtol=1e-6)


@pytest.mark.parametrize("fmt", ["float64x5", "bf16x10", "stack"])
def test_sampler_primal_is_the_plain_sample(fmt):
    """The primal is the plain sample bit for bit (the sampler the main
    path calls: `sample_gh(...)[..., :2]`), also under vmap of a jvp."""
    grad, hess = _images()
    x, y, dx, dy = (torch.from_numpy(a) for a in _points())
    gh = tops.pack_gradhess(torch.from_numpy(grad), torch.from_numpy(hess))
    base = None
    if fmt == "bf16x10":
        gh = tops.pack_gradhess_pair10(torch.from_numpy(grad).float(),
                                       torch.from_numpy(hess).float())
        x, y, dx, dy = (a.float() for a in (x, y, dx, dy))
    elif fmt == "stack":
        gh = torch.stack([gh, 2.0 * gh])
        base = torch.arange(x.numel()) % 2
    plain = tops.sample_gh(gh, x, y, base)[..., :2]
    assert torch.equal(tops.sample_gradient_packed(gh, x, y, base), plain)
    seeds = torch.stack([dx, dy])
    outs, tans = torch.func.vmap(lambda s: torch.func.jvp(
        lambda a: tops.sample_gradient_packed(gh, a, y, base), (x,), (s,)))(
            seeds)
    assert torch.equal(outs[0], plain)
    hess5 = tops.sample_gh(gh, x, y, base)
    assert torch.equal(tans[1][..., 0], hess5[..., 2] * dy)
    assert torch.equal(tans[1][..., 1], hess5[..., 3] * dy)


# ---------------------------------------------------------------------------
# the oracle's parts


def test_gather_image_at_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(3, 20, 24))
    px = rng.integers(0, 24, size=(2, 3, 5))
    py = rng.integers(0, 20, size=(2, 3, 5))
    want = jgn._gather_image_at(jnp.asarray(img), px, py)
    got = tgn._gather_image_at(torch.from_numpy(img), torch.from_numpy(px),
                               torch.from_numpy(py))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_residual_weights_shading_matches_jax():
    """The shading branch, behind the new optional arguments."""
    rng = np.random.default_rng(5)
    diffs = rng.normal(size=(2, 16, 2)) * 0.05
    subdiffs = rng.normal(size=(16, 1, 2)) * 0.05
    div = rng.normal(size=(16, 6)) * 0.01
    gm = rng.normal(size=(16, 2)) * 0.05
    vis = np.array([1.0, 1.0])
    lighting = rng.normal(size=16)
    shading = rng.normal(size=16)
    shading[3] = 1e-7  # gated off
    lin_grad = rng.normal(size=(16, 2)) * 0.1
    lin_val = rng.uniform(0.2, 1.0, size=16)
    shading_res = rng.normal(size=(16, 2)) * 0.05
    for opts in (jgn.GNOptions(light_surf_regularization=0.5),
                 jgn.GNOptions()):
        want = jgn._residual_weights(
            *map(jnp.asarray, (diffs, subdiffs, div, gm, vis, lighting)),
            opts, jnp.float64, 16, [(0, 1)], shading=jnp.asarray(shading),
            lin_grad=jnp.asarray(lin_grad), lin_val=jnp.asarray(lin_val),
            shading_res=jnp.asarray(shading_res))
        got = tgn._residual_weights(
            *map(torch.from_numpy, (diffs, subdiffs, div, gm, vis)),
            convert.options(tgn.GNOptions, dataclasses.asdict(opts)),
            torch.float64, 16, [(0, 1)], lighting=torch.from_numpy(lighting),
            shading=torch.from_numpy(shading),
            lin_grad=torch.from_numpy(lin_grad),
            lin_val=torch.from_numpy(lin_val),
            shading_res=torch.from_numpy(shading_res))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


@pytest.mark.parametrize("n_views,use_shading", [(3, False), (2, True)])
def test_patch_residuals_and_weights_match_jax(n_views, use_shading):
    """One patch's residuals and weights, and a slab of patches on a
    leading axis equal to each patch alone."""
    surf, view, vis, lighting = _jax_problem(n_views, use_shading)
    ts, tv, tvis, _, tl = _port_problem(n_views, use_shading)
    rng = np.random.default_rng(6)
    vals = np.array([5.0, 0.0, 0.0, 0.0, 0.0, 0.0]) + rng.normal(
        size=(3, 16, 6)) * np.array([0.1, 0.02, 0.02, 0.01, 0.01, 0.01])
    u = rng.uniform(20.0, 70.0, size=(3, 16))
    v = rng.uniform(20.0, 70.0, size=(3, 16))
    gm = rng.normal(size=(3, 16, 2)) * 0.05
    vs = np.array([[1.0] * n_views, [0.0] + [1.0] * (n_views - 1),
                   [1.0] * n_views])
    slab = tgn._patch_residuals(
        *map(torch.from_numpy, (vals, u, v, gm, vs)), tv, tl, PORT_OPTS,
        ts.width, ts.height, want_weights=True)
    for i in range(3):
        want = jgn._patch_residuals(
            *map(jnp.asarray, (vals[i], u[i], v[i], gm[i], vs[i])), view,
            lighting, JAX_OPTS, surf.width, surf.height, want_weights=True)
        got = tgn._patch_residuals(
            *map(torch.from_numpy, (vals[i], u[i], v[i], gm[i], vs[i])), tv,
            tl, PORT_OPTS, ts.width, ts.height, want_weights=True)
        for g, w, s in zip(got, want, slab):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
            np.testing.assert_allclose(s[i].numpy(), g.numpy(), rtol=1e-14,
                                       atol=1e-14 * np.abs(w).max())


@pytest.mark.parametrize("n_views,use_shading", [(3, False), (2, True)])
def test_patch_grad_hessian_one_patch_matches_jax(n_views, use_shading):
    """One patch's (g, H) by autodiff, and the same patches as a slab."""
    from smvs_tpu.surface import bicubic as jbicubic
    from smvs_tpu_torch.surface import bicubic as tbicubic

    surf, view, vis, lighting = _jax_problem(n_views, use_shading)
    ts, tv, _, _, tl = _port_problem(n_views, use_shading)
    rng = np.random.default_rng(8)
    params = np.tile([5.0, 0.0, 0.0, 0.0], 4) + rng.normal(size=(3, 16)) * 0.05
    u = 40.5 + np.tile(np.arange(0, 8, 2), 4)[None] + rng.integers(0, 9, (3, 1))
    v = 40.5 + np.repeat(np.arange(0, 8, 2), 4)[None] + rng.integers(0, 9,
                                                                     (3, 1))
    u, v = u.astype(float), v.astype(float)
    gm = rng.normal(size=(3, 16, 2)) * 0.05
    vs = np.ones((3, n_views))
    ok = np.array([1.0, 0.0, 1.0])
    jbasis = jbicubic.pixel_basis(8, 2, dtype=jnp.float64)
    tbasis = tbicubic.pixel_basis(8, 2, dtype=torch.float64)
    slab = tgn.patch_grad_hessian(
        *map(torch.from_numpy, (params, u, v, gm, vs, ok)), tv, tbasis, tl,
        PORT_OPTS, ts.width, ts.height)
    for i in range(3):
        want = jgn.patch_grad_hessian(
            *map(jnp.asarray, (params[i], u[i], v[i], gm[i], vs[i], ok[i])),
            view, jbasis, lighting, JAX_OPTS, surf.width, surf.height)
        got = tgn.patch_grad_hessian(
            *map(torch.from_numpy, (params[i], u[i], v[i], gm[i], vs[i],
                                    ok[i:i + 1].reshape(()))),
            tv, tbasis, tl, PORT_OPTS, ts.width, ts.height)
        for g, w, s in zip(got, want, slab):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                       atol=1e-10 * np.abs(w).max())
            np.testing.assert_allclose(s[i].numpy(), g.numpy(), rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
    assert float(slab[1][1].abs().max()) == 0.0  # patch_ok 0 weighs nothing
    assert float(slab[1][0].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the whole oracle assembly


@pytest.mark.parametrize("n_views,use_shading", CASES)
def test_oracle_matches_jax_oracle(n_views, use_shading):
    g_j, H_j = _jax_oracle(n_views, use_shading)
    ts, tv, vis, active, tl = _port_problem(n_views, use_shading)
    g, H = tgn.assemble(ts, tv, vis, active, PORT_OPTS, tl)
    assert g.shape == g_j.shape and H.shape == H_j.shape
    assert _scaled(g, g_j) <= 1e-10
    assert _scaled(H, H_j) <= 1e-10


@pytest.mark.parametrize("n_views,use_shading", CASES)
def test_analytic_matches_oracle(n_views, use_shading):
    """The port's closed forms against its own oracle, at JAX's bar."""
    ts, tv, vis, active, tl = _port_problem(n_views, use_shading)
    g_o, H_o = tgn.assemble(ts, tv, vis, active, PORT_OPTS, tl)
    g_a, H_a = tgn.assemble(ts, tv, vis, active,
                            dataclasses.replace(PORT_OPTS, analytic=True), tl)
    assert _scaled(g_a, g_o) <= 1e-9
    assert _scaled(H_a, H_o) <= 1e-9


@pytest.mark.parametrize("case", sorted(F32_ENVELOPE))
def test_oracle_float32_bf16_within_twice_jax_envelope(case):
    g32, H32 = _jax_oracle(*case, f32=True)
    env_g, env_h = F32_ENVELOPE[case]
    ts, tv, vis, active, tl = _port_problem(*case, f32=True)
    assert tv.sub_gh.dtype == torch.bfloat16 and tv.sub_gh.shape[-1] == 10
    g, H = tgn.assemble(ts, tv, vis, active, PORT_OPTS, tl)
    assert g.dtype == H.dtype == torch.float32
    assert _scaled(g, g32) <= 2 * env_g
    assert _scaled(H, H32) <= 2 * env_h


@pytest.mark.parametrize("n_views,use_shading", [(3, False), (2, True)])
def test_oracle_slabs(n_views, use_shading):
    """chunk=7: slabs of 7 patches (7 * 16 pixels) against one slab."""
    ts, tv, vis, active, tl = _port_problem(n_views, use_shading)
    g, H = tgn.assemble(ts, tv, vis, active, PORT_OPTS, tl)
    g7, H7 = tgn.assemble(ts, tv, vis, active,
                          dataclasses.replace(PORT_OPTS, chunk=7), tl)
    for got, want in ((g7, g), (H7, H)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))


def test_oracle_compaction_is_exact(monkeypatch):
    ts, tv, vis, active, tl = _port_problem(2, True)
    active = active.clone()
    active[:, : active.shape[1] // 2] = False
    g, H = tgn.assemble(ts, tv, vis, active, PORT_OPTS, tl)
    monkeypatch.setattr(tgn, "_COMPACT_MIN_PATCHES", 0)
    gc, Hc = tgn.assemble(ts, tv, vis, active, PORT_OPTS, tl)
    for got, want in ((gc, g), (Hc, H)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("use_shading", [False, True])
def test_oracle_batch_equals_views_alone(use_shading):
    """Two views on a leading axis, each bit-equal to its run alone."""
    ts, tv, vis, active, tl = _port_problem(2, use_shading)
    ts2 = dataclasses.replace(ts, nodes=ts.nodes * 1.003)
    vis2 = vis.clone()
    vis2[::2, :, 1] = False
    active2 = active.clone()
    active2[0] = False
    tl2 = None if tl is None else tl * 1.1
    alone = [tgn.assemble(ts, tv, vis, active, PORT_OPTS, tl),
             tgn.assemble(ts2, tv, vis2, active2, PORT_OPTS, tl2)]
    g, H = tgn.assemble(stack_surfaces([ts, ts2]),
                        tgn.stack_viewsets([tv, tv]),
                        torch.stack([vis, vis2]),
                        torch.stack([active, active2]), PORT_OPTS,
                        None if tl is None else torch.stack([tl, tl2]))
    assert g.shape == (4, 2, *active.shape)
    assert H.shape == (3, 3, 4, 4, 2, *active.shape)
    for i, (gi, Hi) in enumerate(alone):
        assert torch.equal(g[:, i], gi)
        assert torch.equal(H[:, :, :, :, i], Hi)
    assert not torch.equal(alone[0][0], alone[1][0])


def test_options_from_dict():
    opts = convert.options(tgn.GNOptions, {"analytic": False, "chunk": 64})
    assert opts == tgn.GNOptions(analytic=False, chunk=64)
    assert tgn.GNOptions().analytic and tgn.GNOptions().chunk == 16384
    with pytest.raises(ValueError):
        convert.options(tgn.GNOptions, {"analytic": False, "slab": 64})
