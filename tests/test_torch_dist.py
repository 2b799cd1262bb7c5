"""The port's batched Newton step (`smvs_tpu_torch.dist.viewbatch`) against
the JAX package's, on the CPU, on `make_view_batch(4, dim=116, scale=4)`
in float64, as tests/test_dist.py sizes it. The device mesh and the
sharded step are ROADMAP.md queue 1, item 6.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from smvs_tpu.dist import testing as jtesting
from smvs_tpu.dist import viewbatch as jvb
from smvs_tpu.solver import gn as jgn
from smvs_tpu_torch.dist import testing as ttesting
from smvs_tpu_torch.dist import viewbatch as tvb
from smvs_tpu_torch.solver import gn as tgn
from smvs_tpu_torch.surface import state as S
from torch_threads import one_torch_thread  # noqa: F401

ARGS = ("nodes", "node_valid", "patch_valid", "vis", "active", "view")


@pytest.fixture(scope="module")
def batches():
    jt, jb = jtesting.make_view_batch(4, dim=116, scale=4, dtype=jnp.float64)
    tt, tb = ttesting.make_view_batch(4, dim=116, scale=4,
                                      dtype=torch.float64, device="cpu")
    return jt, jb, tt, tb


def test_make_view_batch_matches_jax(batches):
    """The same seeded problem: the grid, the perturbed nodes, the masks
    and the views' warps."""
    jt, jb, tt, tb = batches
    assert (tt.scale, tt.start_x, tt.start_y, tt.width, tt.height) == \
        (jt.scale, jt.start_x, jt.start_y, jt.width, jt.height)
    for k in ARGS[:-1]:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_allclose(tb["view"].M.numpy(), np.asarray(jb["view"].M),
                               rtol=1e-12)
    np.testing.assert_allclose(tb["view"].grad_main.numpy(),
                               np.asarray(jb["view"].grad_main),
                               rtol=1e-9, atol=1e-12)


def test_batched_newton_step_matches_jax(batches):
    """float64 on both sides; rtol 1e-7 with an absolute floor of 1e-9 of
    the largest step: the two packages sum the PCG's dot products in
    different orders, which moves the 200-iteration solve at ~1e-12, and
    its tolerance exits can end one view an iteration apart."""
    jt, jb, tt, tb = batches
    jstep = jax.jit(jvb.batched_newton_step(jt, jgn.GNOptions()))
    want = np.asarray(jstep(*(jb[k] for k in ARGS)))
    got = tvb.batched_newton_step(tt, tgn.GNOptions())(*(tb[k]
                                                         for k in ARGS))
    assert got.shape == want.shape == (4, *tt.nodes.shape)
    step = np.abs(want - np.asarray(jb["nodes"]))
    assert step.max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7,
                               atol=1e-9 * step.max())


def test_batched_newton_step_per_view(batches):
    """Each view of the batched step equals the step of that view alone
    (a batch of one) bit for bit, and the views' steps differ."""
    _, _, tt, tb = batches
    step = tvb.batched_newton_step(tt, tgn.GNOptions())
    out = step(*(tb[k] for k in ARGS))
    for i in range(4):
        one = step(*(tb[k][i:i + 1] for k in ARGS[:-1]),
                   tgn.stack_viewsets([tgn.viewset_at(tb["view"], i)]))
        assert torch.equal(out[i], one[0])
    assert not torch.equal(out[0] - tb["nodes"][0], out[1] - tb["nodes"][1])


def test_create_planar_and_single_problem(batches):
    jt, _, tt, _ = batches
    np.testing.assert_array_equal(tt.nodes.numpy(), np.asarray(jt.nodes))
    surf, view, vis, active = ttesting.make_single_view_problem(
        dim=96, scale=4, device="cpu")
    assert tuple(surf.nodes.shape[:2]) == (vis.shape[0] + 1,
                                           vis.shape[1] + 1)
    assert vis.all() and torch.equal(active, surf.node_valid)
    assert surf.nodes[..., 0].eq(5.5).all()
    assert isinstance(S.create_planar(5.5, 96, 96, 3), S.Surface)
