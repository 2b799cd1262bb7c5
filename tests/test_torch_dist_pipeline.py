"""The port's row-split pipeline (`optimize_view_batch` over a ('views',
'patch') mesh with a 'patch' axis above 1) on the CPU, over gloo ranks
spawned by `dist.launch.spawn`: the band multigrid and the band Newton
step against the whole grid's in float64, and the pipeline at dim 96
against the port's unsharded batch and the JAX package's pipeline on
its 8-device CPU mesh with a 'patch' axis of 2, at the JAX dry run's
bars (`dist.dryrun.check_bars`). tests/test_torch_dist_pipeline_levels.py
runs the pipeline where the finest grid has two multigrid levels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_dist_ranks as ranks
from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.pipeline import batch as jB
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu_torch.dist import launch
from smvs_tpu_torch.dist.dryrun import check_bars
from smvs_tpu_torch.dist.testing import make_view_batch, plane_view_problem
from smvs_tpu_torch.pipeline import batch as tB
from smvs_tpu_torch.pipeline import optimizer as tO
from smvs_tpu_torch.solver import mg
from torch_threads import one_torch_thread  # noqa: F401


def _spawn(tmp_path, fn, n, *args):
    return launch.spawn(fn, n, backend="gloo", device="cpu",
                        store_path=str(tmp_path / f"store{n}"), args=args,
                        timeout=300)


@pytest.mark.parametrize("patch,ny1,min_size,gathered", [
    (2, 80, 8, []), (3, 80, 8, [2]), (4, 80, 2, [2, 3, 4, 5]),
    (4, 5, 2, [1, 2])], ids=["bands", "odd-start", "3-rows", "empty-band"])
def test_band_multigrid_equals_whole_grid(tmp_path, patch, ny1, min_size,
                                          gathered):
    """Each rank's band of every level (operator, inverted diagonal,
    damping map) and of one V-cycle with its guard are the whole grid's
    rows within 1e-12, over uneven bands: every level in bands (the
    coarsest's sweeps on halos), 80 rows on 3 ranks (a band from an odd
    row), levels down to 3 rows on 4 ranks (fewer rows than ranks), and
    5 rows on 4 ranks (a rank's coarse band of no row). The levels on
    which a rank would hold fewer than `mesh.GATHER_ROWS` rows are
    gathered whole on every rank."""
    data = ranks.seeded_system(2, ny1, 37)
    act = torch.ones(2, ny1, 37, dtype=torch.bool)
    act[0, 3:6, 5:9] = False
    act[1, ny1 // 2] = False
    data["active"] = act
    path = str(tmp_path / "system.pt")
    torch.save(data, path)
    whole = mg.build(data["Hb"], act, min_size=min_size)
    z = mg.apply(whole, data["x"])
    assert len(whole.ops) >= 3
    outs = _spawn(tmp_path, ranks.band_multigrid, patch, path, min_size)
    assert [lvl for lvl, b in enumerate(outs[0]["bands"]) if b is None] == \
        gathered
    for lvl in range(len(whole.ops)):
        bands = [o["bands"][lvl] for o in outs]
        if bands[0] is not None:  # each level's bands cover it once
            assert [i for b in bands for i in b] == \
                list(range(whole.shapes[lvl][0]))
    for o in outs:
        assert o["shapes"] == whole.shapes
        for lvl, band in enumerate(o["bands"]):
            for key in ("ops", "pinvs", "omegas"):
                want = getattr(whole, key)[lvl]
                if band is not None:
                    want = want[..., band.start:band.stop, :]
                np.testing.assert_allclose(o[key][lvl], want, rtol=1e-12,
                                           atol=1e-12 * want.abs().max())
        band = o["bands"][0]
        want = z[..., band.start:band.stop, :]
        np.testing.assert_allclose(o["z"], want, rtol=1e-12,
                                   atol=1e-12 * z.abs().max())


@pytest.mark.parametrize("patch", [2, 3])
def test_band_newton_step_equals_whole_grid(tmp_path, patch):
    """The optimizer's Newton step with its system split by rows (band
    assembly, band multigrid of three levels, halo stencil products,
    summed dots) against the whole grid's in float64: nodes within
    1e-10, the same exits, working set and PCG iterations, on every
    rank."""
    template, batch = make_view_batch(2, dim=116, scale=2,
                                      dtype=torch.float64, device="cpu")
    surf = dataclasses.replace(template, nodes=batch["nodes"],
                               node_valid=batch["node_valid"],
                               patch_valid=batch["patch_valid"])
    ny1, nx1 = batch["nodes"].shape[1:3]
    assert mg.num_levels(ny1, nx1) == 3
    want = tO._newton_step_batch(surf, batch["view"], batch["vis"],
                                 batch["active"], tO.OptimizerOptions(),
                                 None, np.ones(2, bool))
    outs = _spawn(tmp_path, ranks.band_newton_step, patch, 116, 2)
    assert (want.nodes - batch["nodes"]).abs().max() > 0
    for o in outs:
        np.testing.assert_allclose(o["nodes"], want.nodes, rtol=0,
                                   atol=1e-10)
        assert torch.equal(o["active"], want.active)
        for key in ("bad", "n_active", "cg_iters"):
            np.testing.assert_array_equal(o[key], getattr(want, key))
        for key in ("avg", "rel_step"):
            np.testing.assert_allclose(o[key], getattr(want, key),
                                       rtol=1e-9)
        assert ranks.same_bits(o["nodes"], outs[0]["nodes"])


def jax_sharded(dim: int, min_scale: int) -> list:
    """The JAX package's pipeline over make_view_mesh(8, patch_axis=2) on
    the same two views: their depth maps."""
    scene = jsyn.make_plane_scene(n_views=3, dim=dim)
    jv = [jviews.make_view(scene.cameras[i], scene.images[i], view_id=i)
          for i in range(3)]
    inits = [jnp.asarray((scene.depths[i] * 1.02).astype(np.float32))
             for i in (0, 2)]
    opts = jO.OptimizerOptions(**{**ranks.BATCH_OPTS,
                                  "min_scale": min_scale})
    out = jB.optimize_view_batch([jv[0], jv[2]], [[jv[1]], [jv[1]]], opts,
                                 init_depths=inits,
                                 mesh=jB.make_view_mesh(8, patch_axis=2))
    return [np.asarray(r.depth) for r in out]


def check_pipeline(tmp_path, dim: int, min_scale: int) -> None:
    """`optimize_view_batch` on (1, 2) and (2, 2) meshes: every rank gets
    the same bits for every view, and each view meets the JAX dry run's
    bars against the port's unsharded batch and the JAX package's
    pipeline with a 'patch' axis of 2."""
    mains, subs, inits = plane_view_problem(2, dim=dim, device="cpu")
    opts = tO.OptimizerOptions(**{**ranks.BATCH_OPTS,
                                  "min_scale": min_scale})
    unsharded = tB.optimize_view_batch(mains, subs, opts, init_depths=inits,
                                       device="cpu")
    jax_depths = jax_sharded(dim, min_scale)
    for views, patch in ((1, 2), (2, 2)):
        outs = _spawn(tmp_path, ranks.batch_on_mesh, views * patch, patch,
                      dim, min_scale)
        first = outs[0]["results"]
        for o in outs:
            for got, want in zip(o["results"], first):
                assert all(ranks.same_bits(a, b)
                           for a, b in zip(got[:5], want[:5]))
        for i, got in enumerate(first):
            depth = got[0].numpy()
            what = f"({views}, {patch}) mesh, dim {dim}, view {i}"
            check_bars(depth, unsharded[i].depth.numpy(),
                       what + " against the unsharded batch")
            check_bars(depth, jax_depths[i], what + " against JAX")
            s = unsharded[i].surface
            assert got[5] == (s.scale, s.start_x, s.start_y, s.width,
                              s.height)
            assert (depth > 0).mean() > 0.25


def test_pipeline_on_mesh_dim96(tmp_path):
    """The JAX dry run's problem: 7 node rows at the finest scale (one
    multigrid level), 4 at the first."""
    check_pipeline(tmp_path, 96, 4)
