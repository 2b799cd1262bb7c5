"""View batching in the port (`smvs_tpu_torch.pipeline.batch`), on the CPU.

The port's `optimize_view_batch` against the JAX package's at the size of
tests/test_batch.py, and the port's batched solver pieces and pipeline
against the port's own sequential ones, view by view. Every batched
reduction runs view by view as the sequential path runs it (the PCG's
dot products, the multigrid's row sums and guard, the assembly's matrix
products: `smvs_tpu_torch.utils.perview`), so the port's batched and
sequential results are compared bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.pipeline import batch as jB
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.surface import state as jS
from smvs_tpu_torch.core import synthetic as tsyn
from smvs_tpu_torch.dist import launch
from smvs_tpu_torch.dist.dryrun import check_bars
from smvs_tpu_torch.geometry import correspondence as corr
from smvs_tpu_torch.pipeline import batch as tB
from smvs_tpu_torch.pipeline import optimizer as tO
from smvs_tpu_torch.pipeline import views as tviews
from smvs_tpu_torch.shading import lighting as tL
from smvs_tpu_torch.shading import sh
from smvs_tpu_torch.solver import cg, gn, mg, stencil
from smvs_tpu_torch.surface import state as S
import torch_dist_ranks
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_batch.py:43-46
OPTS = dict(regularization=0.01, num_iterations=2, min_scale=4,
            use_sgm=False, full_optimization=True, max_newton_steps=8,
            fixed_newton_steps=True)


def _problem(n_mains=2, dim=96, port=True, spread=0.0):
    """tests/test_batch.py's problem: the mains of a plane scene each see
    the center view; a dense init 2% deep (``spread``: view k's init
    (2 + spread * k)% deep, so that the views take different paths)."""
    syn, views = (tsyn, tviews) if port else (jsyn, jviews)
    scene = syn.make_plane_scene(n_views=n_mains + 1, dim=dim)
    kw = dict(device="cpu") if port else {}
    views_ = [views.make_view(scene.cameras[i], scene.images[i],
                              view_id=i, **kw) for i in range(n_mains + 1)]
    center = n_mains // 2
    mains, subs, gts, inits = [], [], [], []
    for k, i in enumerate(j for j in range(n_mains + 1) if j != center):
        mains.append(views_[i])
        subs.append([views_[center]])
        gts.append(scene.depths[i])
        inits.append((scene.depths[i] * (1.02 + spread * k)
                      ).astype(np.float32))
    return mains, subs, gts, inits


def test_optimize_view_batch_matches_jax():
    """The bars of tests/test_batch.py's batched-vs-sequential test: the
    same coverage mask, rtol/atol 1e-3, fewer than 10% of the pixels
    drifting by more than 2e-4, median error < 1% on the analytic
    depth."""
    jm, js, gts, inits = _problem(port=False)
    jres = jB.optimize_view_batch(jm, js, jO.OptimizerOptions(**OPTS),
                                  init_depths=[jnp.asarray(d) for d in inits])
    tm, ts, _, _ = _problem()
    tres = tB.optimize_view_batch(tm, ts, tO.OptimizerOptions(**OPTS),
                                  init_depths=inits, device="cpu")
    assert len(tres) == len(jres) == 2
    for jr, tr, gt in zip(jres, tres, gts):
        want = np.asarray(jr.depth)
        got = tr.depth.numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        assert (got > 0).mean() > 0.3
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
        drift = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
        assert (drift > 2e-4).mean() < 0.10
        mask = (got > 0) & (gt > 0)
        assert np.median(np.abs(got[mask] - gt[mask]) / gt[mask]) < 0.01
        np.testing.assert_array_equal(tr.surface.patch_valid.numpy(),
                                      np.asarray(jr.surface.patch_valid))


def test_sgm_bucket_runs():
    """The use_sgm bucket, held to tests/test_batch.py's
    test_batched_sgm_path_runs bars."""
    mains, subs, gts, inits = _problem()
    opts = tO.OptimizerOptions(regularization=0.01, num_iterations=2,
                               min_scale=4, use_sgm=True,
                               full_optimization=True, max_newton_steps=8)
    for r, gt in zip(tB.optimize_view_batch(mains, subs, opts,
                                            sgm_depths=inits, device="cpu"),
                     gts):
        d = r.depth.numpy()
        mask = (d > 0) & (gt > 0)
        assert mask.mean() > 0.3
        assert np.median(np.abs(d[mask] - gt[mask]) / gt[mask]) < 0.01


# The three buckets of the JAX module (SGM, sparse prior, shading), with
# the working-set Newton loop (fixed_newton_steps off) and views started
# from different inits: dim 128 reaches scale 3, where -S adds the
# shading term and the constant-damping multigrid.
BUCKETS = {
    "sparse_prior": dict(use_sgm=False),
    "sgm": dict(use_sgm=True),
    "shading": dict(use_sgm=True, use_shading=True),
}


@pytest.mark.parametrize("bucket", sorted(BUCKETS))
def test_batched_equals_sequential(bucket, monkeypatch):
    """Per view and scale the same outer iterations, Newton steps, patch
    counts and PCG iterations (each scale program's stats), and the same
    depth, normals, nodes, patches and lighting bit for bit."""
    opts = tO.OptimizerOptions(regularization=0.01, num_iterations=3,
                               min_scale=3, **BUCKETS[bucket])
    mains, subs, _, inits = _problem(n_mains=3, dim=128, spread=0.015)
    init = "sgm_depth" if opts.use_sgm else "init_depth"
    seq_stats, bat_stats = [], []

    def recorder(fn, out):
        def run(*args, **kw):
            surf, stats = fn(*args, **kw)
            out.append(stats)
            return surf, stats
        return run

    monkeypatch.setattr(tO, "scale_program",
                        recorder(tO.scale_program, seq_stats))
    monkeypatch.setattr(tO, "scale_program_batch",
                        recorder(tO.scale_program_batch, bat_stats))
    seq = [tO.optimize_view(m, s, opts, device="cpu", **{init: d})
           for m, s, d in zip(mains, subs, inits)]
    bat = tB.optimize_view_batch(mains, subs, opts, device="cpu",
                                 **{init + "s": inits})
    n_scales = len(bat_stats)
    assert n_scales >= 2 and len(seq_stats) == 3 * n_scales
    for i in range(3):
        for k in range(n_scales):
            assert bat_stats[k][i] == seq_stats[i * n_scales + k]
    assert len({str(bat_stats[-1][i]) for i in range(3)}) > 1
    for a, b in zip(seq, bat):
        assert (a.depth > 0).float().mean() > 0.3
        assert torch.equal(a.depth, b.depth)
        # bit for bit; unrasterized patches hold NaN normals in both
        torch.testing.assert_close(a.normals, b.normals, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.equal(a.surface.nodes, b.surface.nodes)
        assert torch.equal(a.surface.patch_valid, b.surface.patch_valid)
        if opts.use_shading:
            assert torch.equal(a.lighting, b.lighting)


def _scale_problem(dim=128, scale=3, n=3):
    """Per-view surfaces, viewsets and visibility at one scale, from inits
    1-4% deep: views that take different Newton and PCG paths."""
    mains, subs, _, inits = _problem(n_mains=n, dim=dim, spread=0.01)
    surfs, views, viss = [], [], []
    for m, s, d in zip(mains, subs, inits):
        surf = S.create_from_depth(torch.as_tensor(d), scale)
        view = tO._build_viewset(m, s, scale, torch.float32,
                                 bf16_gather=True)
        surf, vis = tO.compute_visibility(surf, view, None)
        surfs.append(surf)
        views.append(view)
        viss.append(vis)
    inv_cals = [torch.as_tensor(m.camera.inverse_calibration(m.width,
                                                             m.height),
                                dtype=torch.float64) for m in mains]
    return surfs, views, viss, inv_cals


def test_newton_loop_and_scale_program_per_view():
    """Each view's Newton steps, PCG iterations and patch counts in the
    batched loops equal its own, and the views differ from each other
    (they leave the loops at different steps)."""
    opts = tO.OptimizerOptions(regularization=0.01, num_iterations=4,
                               use_sgm=True)
    surfs, views, viss, inv_cals = _scale_problem()
    bs, bv, bvis = (S.stack_surfaces(surfs), gn.stack_viewsets(views),
                    torch.stack(viss))
    alive = np.ones(len(surfs), bool)
    nodes, active, steps, cgs = tO._newton_loop_batch(
        bs, bv, bvis, bs.node_valid, opts, None, alive)
    for i, (s, v, vis) in enumerate(zip(surfs, views, viss)):
        n1, a1, st1, cg1 = tO._newton_loop(s, v, vis, s.node_valid, opts,
                                           None)
        assert (steps[i], cgs[i]) == (st1, cg1)
        assert torch.equal(nodes[i], n1) and torch.equal(active[i], a1)
    assert len(set(zip(steps.tolist(), cgs.tolist()))) > 1

    # A view that is not alive takes no step and keeps its nodes.
    alive[1] = False
    nodes2, _, steps2, cgs2 = tO._newton_loop_batch(
        bs, bv, bvis, bs.node_valid, opts, None, alive)
    assert steps2[1] == 0 and cgs2[1] == 0
    assert torch.equal(nodes2[1], bs.nodes[1])
    assert torch.equal(nodes2[0], nodes[0])

    bout, bstats = tO.scale_program_batch(bs, bv, bvis, inv_cals, opts, None)
    for i, (s, v, vis) in enumerate(zip(surfs, views, viss)):
        out, stats = tO.scale_program(s, v, vis, inv_cals[i], opts, None)
        assert bstats[i] == stats
        assert torch.equal(bout.nodes[i], out.nodes)
        assert torch.equal(bout.patch_valid[i], out.patch_valid)


def _system(seed, ny1=13, nx1=11, dtype=torch.float64):
    """A random SPD 9-point stencil system with a ragged active set."""
    rng = np.random.default_rng(seed)
    n = 4 * ny1 * nx1
    R = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.02)
    A = R @ R.T + n * 0.05 * np.eye(n)
    idx = np.arange(n).reshape(4, ny1, nx1)
    Hb = np.zeros((3, 3, 4, 4, ny1, nx1))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            for y in range(ny1):
                for x in range(nx1):
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < ny1 and 0 <= xx < nx1:
                        Hb[1 + dy, 1 + dx, :, :, y, x] = \
                            A[np.ix_(idx[:, y, x], idx[:, yy, xx])]
    Hb = 0.5 * (Hb + np.flip(np.swapaxes(Hb, 2, 3), (0, 1)).copy())
    active = rng.random((ny1, nx1)) > 0.15 * seed
    b = rng.standard_normal((4, ny1, nx1))
    return (torch.as_tensor(Hb, dtype=dtype), torch.as_tensor(active),
            torch.as_tensor(b, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_mg_and_cg_per_view(dtype):
    """Batched stencil ops, multigrid hierarchy and apply, and the masked
    PCG against a loop over views, with each view's own CG iteration
    count (the systems differ, so the counts do), bit for bit in either
    dtype: each view's sums are the ones it takes alone."""
    def same(a, b):
        assert torch.equal(a, b)
    systems = [_system(s, dtype=dtype) for s in range(3)]
    Hb = torch.stack([h for h, _, _ in systems], dim=4)
    act = torch.stack([a for _, a, _ in systems])
    b = torch.stack([r for _, _, r in systems], dim=1)
    assert torch.equal(stencil.spmv(Hb, b)[:, 1],
                       stencil.spmv(systems[1][0], systems[1][2]))
    Pb = stencil.block_jacobi_inverse(Hb, act)
    levels = mg.build(Hb, act)
    const = mg.build(Hb, act, damp_rows=False)
    results, want_iters = [], []
    for i, (H, a, r) in enumerate(systems):
        P = stencil.block_jacobi_inverse(H, a)
        assert torch.equal(Pb[:, :, i], P)
        assert torch.equal(stencil.apply_block_diag(Pb, b)[:, i],
                           stencil.apply_block_diag(P, r))
        lv = mg.build(H, a)
        for op, opb in zip(lv.ops, levels.ops):
            assert torch.equal(opb[:, :, :, :, i], op)
        for om, omb in zip(lv.omegas, levels.omegas):
            assert torch.equal(omb[i], om)
        same(mg.apply(levels, b)[:, i], mg.apply(lv, r))
        lc = mg.build(H, a, damp_rows=False)
        same(mg.apply(const, b)[:, i], mg.apply(lc, r))
        tol = 1e-6 * torch.sum(r * r)
        res = cg.solve(lambda x: stencil.spmv(H, x), r,
                       precond=lambda x: mg.apply(lv, x),
                       error_tolerance=tol, q_tolerance=1e-9)
        results.append(res.x)
        want_iters.append(res.iterations)
    tols = torch.stack([1e-6 * torch.sum(r * r) for _, _, r in systems])
    bres = cg.solve_batch(lambda x: stencil.spmv(Hb, x), b,
                          precond=lambda x: mg.apply(levels, x),
                          error_tolerance=tols, q_tolerance=1e-9)
    assert bres.iterations.tolist() == want_iters
    assert len(set(want_iters)) > 1
    for i, x in enumerate(results):
        same(bres.x[:, i], x)
    # A view left out keeps x = 0 and takes no iteration.
    part = cg.solve_batch(lambda x: stencil.spmv(Hb, x), b,
                          precond=lambda x: mg.apply(levels, x),
                          error_tolerance=tols, q_tolerance=1e-9,
                          running=np.array([True, False, True]))
    assert part.iterations.tolist() == [want_iters[0], 0, want_iters[2]]
    assert not part.x[:, 1].any()
    same(part.x[:, 2], results[2])


def test_median_of_positive_per_view():
    rng = np.random.default_rng(3)
    lam = torch.as_tensor(rng.random((4, 9, 7)) - 0.3)
    lam[2] = -1.0  # no positive entry: 1.0
    lam[3, :, :4] = -1.0  # an even count of positives
    got = mg._median_of_positive(lam, 1)
    for i in range(4):
        want = mg._median_of_positive(lam[i])
        assert torch.equal(got[i], want)
        pos = lam[i][lam[i] > 0].numpy()
        assert float(want) == (float(np.median(pos)) if pos.size else 1.0)


def test_assembly_and_lighting_per_view():
    """gn.assemble over a batch (with the shading term, per-view
    lighting) equals each view's own; the batched lighting fit gives each
    view's lighting, and the normal matrices it solves have the same
    singular values batched as alone."""
    surfs, _, viss, _ = _scale_problem(scale=3)
    mains, subs, _, _ = _problem(n_mains=3, dim=128, spread=0.01)
    views = [tO._build_viewset(m, s, 3, torch.float32, bf16_gather=True,
                               use_shading=True)
             for m, s in zip(mains, subs)]
    nmaps = [S.normal_map(s, 1.0 / m.flen()) for s, m in zip(surfs, mains)]
    shading = [m.shading_images()[0] for m in mains]
    bs = S.stack_surfaces(surfs)
    lights = tL.fit_lighting(S.normal_map(bs, [1.0 / m.flen()
                                               for m in mains]),
                             torch.stack(shading))
    opts = gn.GNOptions(regularization=0.01)
    g, Hb = gn.assemble(bs, gn.stack_viewsets(views), torch.stack(viss),
                        bs.node_valid, opts, lights)
    for i, (s, v, vis) in enumerate(zip(surfs, views, viss)):
        torch.testing.assert_close(
            S.normal_map(bs, [1.0 / m.flen() for m in mains])[i], nmaps[i],
            rtol=0, atol=0, equal_nan=True)
        assert torch.equal(lights[i], tL.fit_lighting(nmaps[i], shading[i]))
        gi, Hi = gn.assemble(s, v, vis, s.node_valid, opts, lights[i])
        assert torch.equal(g[:, i], gi)
        assert torch.equal(Hb[:, :, :, :, i], Hi)
    # The batched SVD gives each view's singular values: the fit's normal
    # matrices, as `fit_lighting` sums them.
    mats = []
    for n, img in zip(nmaps, shading):
        ok = torch.isfinite(n).all(-1)
        nm = torch.where(ok[..., None], n, 0.0)
        valid = ok & (torch.abs(torch.linalg.vector_norm(nm, dim=-1) - 1.0)
                      <= 1e-4) & (img >= 0.05)
        basis = torch.where(valid[..., None], sh.eval_4_band(nm), 0.0)
        mats.append(basis.reshape(-1, 16).T @ basis.reshape(-1, 16))
    A = torch.stack(mats)
    assert (A.abs().sum((1, 2)) > 0).all()
    want = torch.stack([torch.linalg.svdvals(a) for a in A])
    assert torch.equal(torch.linalg.svdvals(A), want)


def test_surface_ops_over_views_and_warp_broadcast():
    surfs, views, _, _ = _scale_problem(scale=4)
    bs = S.stack_surfaces(surfs)
    for fn in (S.subdivide, S.expand, S.remove_isolated_patches):
        out = fn(bs)
        for i, s in enumerate(surfs):
            want = fn(s)
            got = S.unstack_surface(out, i)
            assert torch.equal(got.nodes, want.nodes)
            assert torch.equal(got.node_valid, want.node_valid)
    depth = S.depth_map(bs)
    for i, s in enumerate(surfs):
        assert torch.equal(depth[i], S.depth_map(s))
        assert torch.equal(S.patch_params(bs)[i], S.patch_params(s))
    # warp_depth_gradient with [V]-leading warps against the views alone
    bv = gn.stack_viewsets(views)
    u, v = tO._patch_pixel_grids_sub(surfs[0])
    w = 5.0 + torch.arange(3.0)[:, None, None, None] + u / 1000.0
    gd = corr.warp_depth_gradient(bv.M[:, 0, None, None, None],
                                  bv.t[:, 0, None, None, None], u, v, w)
    assert gd.shape == (3, *u.shape, 2)
    for i in range(3):
        assert torch.equal(gd[i], corr.warp_depth_gradient(
            views[i].M[0], views[i].t[0], u, v, w[i]))


def test_create_planar_matches_jax():
    want = jS.create_planar(5.5, 116, 100, 4, dtype=jnp.float64)
    got = S.create_planar(5.5, 116, 100, 4, dtype=torch.float64)
    assert (got.start_x, got.start_y) == (want.start_x, want.start_y)
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    np.testing.assert_array_equal(got.node_valid.numpy(),
                                  np.asarray(want.node_valid))


def test_bucket_key_grouping_and_mesh(tmp_path):
    mains, subs, _, inits = _problem()
    assert tB.bucket_key(mains[0], subs[0]) == (96, 96, 1)
    # The JAX CLI's groups: at most batch_views views and 3.0 MP in all.
    assert tB.group_views(list(range(5)), (736, 736, 3), 4, 3.0) == \
        [[0, 1, 2, 3], [4]]
    assert tB.group_views(list(range(3)), (1280, 1280, 3), 4, 3.0) == \
        [[0], [1], [2]]
    assert tB.group_views(list(range(3)), (640, 640, 3), 1, 3.0) == \
        [[0], [1], [2]]
    with pytest.raises(TypeError, match="DeviceMesh"):
        tB.optimize_view_batch(mains, subs,
                               tO.OptimizerOptions(**OPTS),
                               init_depths=inits, mesh=object(),
                               device="cpu")
    # Over a (1, 2) mesh both ranks split each view's node rows: both get
    # the same bits, within the JAX dry run's bars of the unsharded batch.
    outs = launch.spawn(torch_dist_ranks.batch_on_mesh, 2, backend="gloo",
                        device="cpu", store_path=str(tmp_path / "store"),
                        args=(2,), timeout=300)
    want = tB.optimize_view_batch(mains, subs, tO.OptimizerOptions(**OPTS),
                                  init_depths=inits, device="cpu")
    for o in outs:
        assert list(o["share"]) == [0, 1]
        for got, first in zip(o["results"], outs[0]["results"]):
            assert all(torch_dist_ranks.same_bits(a, b)
                       for a, b in zip(got[:5], first[:5]))
    for got, w in zip(outs[0]["results"], want):
        check_bars(got[0].numpy(), w.depth.numpy(), "(1, 2) mesh")
        assert got[5] == (w.surface.scale, w.surface.start_x,
                          w.surface.start_y, w.surface.width,
                          w.surface.height)
    with pytest.raises(ValueError, match="buckets"):
        tB.optimize_view_batch(mains, [subs[0], subs[0] * 2],
                               tO.OptimizerOptions(**OPTS),
                               init_depths=inits, device="cpu")
