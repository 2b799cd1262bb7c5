"""The port's Gauss-Newton assembly and linear solvers against the JAX package.

float64 on both sides at rtol 1e-9 (atol 1e-9 of the largest entry, for
entries that cancel to ~0); the float32 assembly with the bf16 gather is
held to a norm-wise bound stated below.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.solver import cg as jcg
from smvs_tpu.solver import gn as jgn
from smvs_tpu.solver import mg as jmg
from smvs_tpu.solver import stencil as jst
from smvs_tpu.surface import state as jS
from smvs_tpu_torch import convert
from smvs_tpu_torch.pipeline import optimizer as tO
from smvs_tpu_torch.pipeline import views as tviews
from smvs_tpu_torch.solver import cg as tcg
from smvs_tpu_torch.solver import gn as tgn
from smvs_tpu_torch.solver import mg as tmg
from smvs_tpu_torch.solver import stencil as tst
from smvs_tpu_torch.solver import testing as tsys
from smvs_tpu_torch.utils.perview import per_view
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_surface(js):
    meta = {f: getattr(js, f) for f in ("scale", "width", "height",
                                        "start_x", "start_y")}
    return convert.surface(np.asarray(js.nodes), np.asarray(js.node_valid),
                           np.asarray(js.patch_valid), meta, "cpu")


def _problem(dim=96, scale=3, dtype=np.float64, bf16=False, n_sub=1):
    """A real GN system: the synthetic scene's surface near the truth."""
    slope = 0.005 * 460.0 / dim
    scene = jsyn.make_two_view_scene(
        dim=dim, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    views = [(jviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                               dtype=jdt),
              tviews.make_view(scene.cameras[i], scene.images[i], view_id=i,
                               device="cpu", dtype=tdt)) for i in (1, 0, 0)]
    jsubs = [v[0] for v in views[1:1 + n_sub]]
    tsubs = [v[1] for v in views[1:1 + n_sub]]
    depth = (scene.depths[1] * 1.01).astype(dtype)
    js = jS.create_from_depth(jnp.asarray(depth), scale)
    jview = jO._build_viewset(views[0][0], jsubs, scale, False, jdt,
                              bf16_gather=bf16)
    tview = tO._build_viewset(views[0][1], tsubs, scale, tdt,
                              bf16_gather=bf16)
    vis = np.broadcast_to(np.asarray(js.patch_valid)[..., None],
                          (*np.asarray(js.patch_valid).shape, n_sub)).copy()
    active = np.asarray(js.node_valid).copy()
    return js, _port_surface(js), jview, tview, vis, active


@pytest.fixture(scope="module")
def system64():
    js, ts, jview, tview, vis, active = _problem(scale=2)  # 2 MG levels
    g, Hb = jgn.assemble(js, jview, jnp.asarray(vis), jnp.asarray(active),
                         jgn.GNOptions())
    return np.asarray(g), np.asarray(Hb), active


def test_viewset_matches():
    """float32 scale space (XLA fuses the blur into FMAs): 1e-5 of the
    largest gradient; the bf16 image within one bf16 step (2^-7 relative)."""
    js, ts, jview, tview, vis, active = _problem(bf16=True,
                                                 dtype=np.float32)
    _close(tview.grad_main, jview.grad_main, rtol=1e-5)
    got = tview.sub_gh.to(torch.float32).numpy()
    want = np.asarray(jview.sub_gh).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0**-7,
                               atol=1e-5 * np.abs(want).max())
    _close(tview.M, jview.M, rtol=1e-7)
    _close(tview.t, jview.t, rtol=1e-7)


def test_data_term_and_weights():
    rng = np.random.default_rng(0)
    g5 = rng.normal(size=(20, 24, 5))
    M = np.array([[1.01, 0.02, -3.0], [-0.01, 0.99, 1.0], [1e-4, 2e-5, 1.0]])
    t = np.array([20.0, -4.0, 0.02])
    u, v = rng.uniform(2, 20, (3, 16)), rng.uniform(2, 18, (3, 16))
    w, wdx, wdy = rng.uniform(4, 6, (3, 16)), rng.normal(size=(3, 16)) * 0.1, \
        rng.normal(size=(3, 16)) * 0.1
    got = tgn._data_term_analytic(*map(_t, (M, t, g5, u, v, w, wdx, wdy)))
    want = jgn._data_term_analytic(*map(jnp.asarray,
                                        (M, t, g5, u, v, w, wdx, wdy)))
    for a, b in zip(got, want):
        _close(a, b)
    diffs = rng.normal(size=(2, 16, 2)) * 0.05
    subdiffs = rng.normal(size=(16, 1, 2)) * 0.05
    div = rng.normal(size=(16, 6)) * 0.01
    gm = rng.normal(size=(16, 2)) * 0.05
    vis = np.array([1.0, 0.0])
    want = jgn._residual_weights(
        jnp.asarray(diffs), jnp.asarray(subdiffs), jnp.asarray(div),
        jnp.asarray(gm), jnp.asarray(vis), None, jgn.GNOptions(),
        jnp.float64, 16, [(0, 1)])
    got = tgn._residual_weights(_t(diffs), _t(subdiffs), _t(div), _t(gm),
                                _t(vis), tgn.GNOptions(), torch.float64, 16,
                                [(0, 1)])
    _close(got, want)


@pytest.mark.parametrize("ps,sub", [(8, 2), (32, 4)])
def test_contraction_tensors(ps, sub):
    jb, jg = jgn._contraction_tensors(ps, sub, "float64")
    tb, tg = tgn._contraction_tensors(ps, sub, torch.float64, "cpu")
    _close(tb, jb)
    _close(tg, jg)


@pytest.mark.parametrize("n_sub", [1, 2])
def test_assemble_float64(n_sub):
    js, ts, jview, tview, vis, active = _problem(n_sub=n_sub)
    active[::3, ::2] = False  # a partial working set
    g, Hb = jgn.assemble(js, jview, jnp.asarray(vis), jnp.asarray(active),
                         jgn.GNOptions())
    tg, tHb = tgn.assemble(ts, tview, _t(vis), _t(active), tgn.GNOptions())
    _close(tg, g)
    _close(tHb, Hb)


def test_assemble_compacted_equals_full(monkeypatch):
    """The working-set compaction (on large grids) is exact."""
    js, ts, jview, tview, vis, active = _problem()
    active[:, : active.shape[1] // 2] = False
    g, Hb = jgn.assemble(js, jview, jnp.asarray(vis), jnp.asarray(active),
                         jgn.GNOptions())
    monkeypatch.setattr(tgn, "_COMPACT_MIN_PATCHES", 0)
    tg, tHb = tgn.assemble(ts, tview, _t(vis), _t(active), tgn.GNOptions())
    _close(tg, g)
    _close(tHb, Hb)


def test_assemble_float32_bf16_gather():
    """float32 with the bf16 x-paired gather on both sides. Inputs are
    identical bits; the sums differ in float32 order and XLA's fused
    multiply-adds, amplified where an IRLS weight 1/(1e-4 + |r|) sits on
    a tiny residual: held to 1e-3 of the norm."""
    js, ts, _, _, vis, active = _problem(dtype=np.float32, bf16=True)
    jview = _problem(dtype=np.float32, bf16=True)[2]
    tview = convert.viewset(jview.grad_main, jview.sub_gh, jview.M, jview.t,
                            jview.flen, "cpu")
    g, Hb = jgn.assemble(js, jview, jnp.asarray(vis), jnp.asarray(active),
                         jgn.GNOptions())
    tg, tHb = tgn.assemble(ts, tview, _t(vis), _t(active), tgn.GNOptions())
    for got, want in ((tg, g), (tHb, Hb)):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.numpy().astype(np.float64) - want)
        assert err <= 1e-3 * np.linalg.norm(want), err


def test_stencil_ops(system64):
    g, Hb, active = system64
    rng = np.random.default_rng(1)
    ny, nx = active.shape[0] - 1, active.shape[1] - 1
    gp = rng.normal(size=(16, ny, nx))
    Hp = rng.normal(size=(16, 16, ny, nx))
    pv = rng.random((ny, nx)) < 0.8
    got = tst.scatter_patch_systems(_t(gp), _t(Hp), _t(active), _t(pv))
    want = jst.scatter_patch_systems(jnp.asarray(gp), jnp.asarray(Hp),
                                     jnp.asarray(active), jnp.asarray(pv))
    for a, b in zip(got, want):
        _close(a, b)
    x = rng.normal(size=g.shape)
    _close(tst.spmv(_t(Hb), _t(x)), jst.spmv(jnp.asarray(Hb), jnp.asarray(x)))
    P = tst.block_jacobi_inverse(_t(Hb), _t(active))
    _close(P, jst.block_jacobi_inverse(jnp.asarray(Hb), jnp.asarray(active)))
    _close(tst.apply_block_diag(P, _t(x)),
           jst.apply_block_diag(jnp.asarray(P.numpy()), jnp.asarray(x)))


def test_multigrid(system64):
    g, Hb, active = system64
    rng = np.random.default_rng(2)
    ny1, nx1 = active.shape
    xc = rng.normal(size=(4, tmg.coarse_size(ny1), tmg.coarse_size(nx1)))
    _close(tmg.prolong(_t(xc), ny1, nx1),
           jmg.prolong(jnp.asarray(xc), ny1, nx1))
    xf = rng.normal(size=(4, ny1, nx1))
    _close(tmg.restrict(_t(xf)), jmg.restrict(jnp.asarray(xf)))
    np.testing.assert_array_equal(
        tmg.restrict_mask(_t(active)).numpy(),
        np.asarray(jmg.restrict_mask(jnp.asarray(active))))
    _close(tmg.galerkin_coarse(_t(Hb)), jmg.galerkin_coarse(jnp.asarray(Hb)))
    tl = tmg.build(_t(Hb), _t(active))
    jl = jmg.build(jnp.asarray(Hb), jnp.asarray(active))
    assert len(tl.ops) == len(jl.ops) >= 2
    for a, b in zip(tl.omegas, jl.omegas):
        _close(a, b)
    for a, b in zip(tl.pinvs, jl.pinvs):
        _close(a, b)
    r = rng.normal(size=(4, ny1, nx1))
    _close(tmg.apply(tl, _t(r)), jmg.apply(jl, jnp.asarray(r)))


@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_cg_solve(system64, precond):
    g, Hb, active = system64
    jH, tH = jnp.asarray(Hb), _t(Hb)
    if precond == "mg":
        jl, tl = jmg.build(jH, jnp.asarray(active)), tmg.build(tH, _t(active))
        jP = lambda x: jmg.apply(jl, x)  # noqa: E731
        tP = lambda x: tmg.apply(tl, x)  # noqa: E731
    else:
        jPi = jst.block_jacobi_inverse(jH, jnp.asarray(active))
        tPi = tst.block_jacobi_inverse(tH, _t(active))
        jP = lambda x: jst.apply_block_diag(jPi, x)  # noqa: E731
        tP = lambda x: tst.apply_block_diag(tPi, x)  # noqa: E731
    gnorm = float(np.linalg.norm(g))
    want = jcg.solve(lambda x: jst.spmv(jH, x), -jnp.asarray(g), precond=jP,
                     error_tolerance=gnorm * 1e-4, q_tolerance=1e-6)
    got = tcg.solve(lambda x: tst.spmv(tH, x), -_t(g), precond=tP,
                    error_tolerance=gnorm * 1e-4, q_tolerance=1e-6)
    assert got.iterations == int(want.iterations) > 1
    _close(got.x, want.x)
    _close(got.residual, want.residual)


def test_newton_step_float64():
    """One Newton step (assembly, MG-preconditioned CG, working set)."""
    js, ts, jview, tview, vis, active = _problem()
    want = jO._newton_step(js, jview, jnp.asarray(vis), jnp.asarray(active),
                           jO.OptimizerOptions(regularization=0.01), None)
    got = tO._newton_step(ts, tview, _t(vis), _t(active),
                          tO.OptimizerOptions(regularization=0.01))
    _close(got.nodes, want[0])
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want[1]))
    assert got.cg_iters == int(want[6])
    assert got.n_active == int(want[5])
    np.testing.assert_allclose(float(got.avg), float(want[3]), rtol=RTOL)


def _loop_before_graphs(A, b, precond=None, max_iterations=200,
                        error_tolerance=1e-20, q_tolerance=1e-3,
                        running=None, view_dim=1, reduce=None,
                        flexible=False):
    """`cg.solve_batch`'s loop as it was before its pass became `cg._step`
    (new tensors each pass, the mask None while every view runs, the pass
    number from the host), kept to hold `_step` to it."""
    P = precond if precond is not None else (lambda v: v)
    V = b.shape[view_dim]
    dev = b.device
    shape_v = [1] * b.ndim
    shape_v[view_dim] = V

    def vdot(a, c):
        if V == 1:
            out = tcg._dot(a, c).reshape(1)
        elif a is c:
            out = per_view(lambda v: tcg._dot(v, v), a, dim=view_dim)
        else:
            out = per_view(tcg._dot, a, c, dim=view_dim)
        return out if reduce is None else reduce(out)

    def keep(m, new, old):
        if m is None:
            return new
        return torch.where(m.reshape(shape_v) if new.ndim > 1 else m,
                           new, old)

    run_h = (np.ones(V, bool) if running is None
             else np.asarray(running, bool).copy())
    iters = np.zeros(V, np.int64)
    x = torch.zeros_like(b)
    r = b
    d = P(r)
    rdr = vdot(d, r)
    q_prev = torch.zeros((V,), dtype=b.dtype, device=dev)
    tol = torch.broadcast_to(torch.as_tensor(error_tolerance, dtype=b.dtype,
                                             device=dev), (V,))
    run = None if run_h.all() else torch.as_tensor(run_h, device=dev)
    i = 0
    while i < max_iterations and run_h.any():
        if i:
            z = P(r)
            new_rdr = vdot(z, r)
            num = vdot(z, r - r_prev) if flexible else new_rdr
            beta = torch.where(rdr != 0, num / rdr, 0.0).reshape(shape_v)
            d = keep(run, z + beta * d, d)
            rdr = keep(run, new_rdr, rdr)
            q_prev = keep(run, q1, q_prev)
        Ad = A(d)
        dAd = vdot(d, Ad)
        alpha = torch.where(dAd != 0, rdr / dAd, 0.0).reshape(shape_v)
        x = keep(run, x + alpha * d, x)
        r_prev = r
        r = keep(run, r - alpha * Ad, r)
        new_rr = vdot(r, r)
        q1 = -vdot(x, b + r)
        zeta = (i + 1) * (q1 - q_prev) / torch.where(q1 != 0, q1, 1.0)
        i += 1
        iters += run_h
        stop = (new_rr < tol) | (zeta < q_tolerance)
        run_h = run_h & ~stop.cpu().numpy()
        if i < max_iterations and run_h.any() and not run_h.all():
            run = ~stop if run is None else run & ~stop
    return tcg.CGBatchResult(x=x, iterations=iters, residual=vdot(r, r))


def _bits(t):
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("flexible", [False, True])
@pytest.mark.parametrize("precond", ["mg", "jacobi"])
@pytest.mark.parametrize("views", [0, 4])
def test_pcg_pass_matches_loop_before_graphs(monkeypatch, views, precond,
                                             flexible):
    """`cg._step`, run op by op as the CPU runs it (and a card runs pass 1
    and every pass of a split system), gives the loop it replaced bit for
    bit: x, the residual and each view's iterations. One system as
    `cg.solve` takes it, and a batch of 4 whose views exit at different
    passes, one of them not running."""
    Hb, b, active = tsys.stencil_system(37, 49, views, seed=5)
    kw = dict(precond=precond, flexible=flexible)
    if views:
        kw.update(tol_scale=[1.0, 1e-2, 1.0, 1e-4],
                  running=np.array([True, True, False, True]))
    got = tsys.solve(Hb, b, active, **kw)
    monkeypatch.setattr(tcg, "solve_batch", _loop_before_graphs)
    want = tsys.solve(Hb, b, active, **kw)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    np.testing.assert_array_equal(_bits(got.x), _bits(want.x))
    np.testing.assert_array_equal(_bits(got.residual), _bits(want.residual))
    assert got.iterations.max() > 2
    if views:  # the running views leave at different passes
        assert got.iterations[2] == 0
        assert len(set(got.iterations[[0, 1, 3]].tolist())) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mg_weights_cached(dtype):
    """The transfer and Galerkin weights are converted once per dtype and
    device: a second call hands back the same tensors, of the numpy
    constants' values."""
    cpu = torch.device("cpu")
    first = tmg._weights_4(dtype, cpu)
    again = tmg._weights_4(dtype, cpu)
    for got, same, want in zip(first, again, tmg._weights_4_np()):
        for u in (-1, 0, 1):
            assert same[u] is got[u] and got[u].dtype == dtype
            np.testing.assert_array_equal(
                got[u].numpy(), want[u].astype(got[u].numpy().dtype))
    G = tmg._galerkin_weight(dtype, cpu)
    assert tmg._galerkin_weight(dtype, cpu) is G and G.dtype == dtype
    np.testing.assert_array_equal(
        G.numpy(), tmg._galerkin_weight_np().astype(G.numpy().dtype))
