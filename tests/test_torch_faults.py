"""Two repaired faults of the SGM kernel router against the JAX package, on
the CPU.

1. Repeated shifts in rows 1 and 4 (`fused_pass`, `fused_pass(loop=True)`):
   the JAX kernel keeps one scratch line per listed shift and returns acc
   plus every path; the port routes such a sweep to one `sgm_path_kernel`
   launch per path, as rows 2 and 3 already did.
2. More than 128 depth planes: every kernel up to 512 depths is built for
   8 and 16 depths per lane beyond 128, and `plan_route` sends a sweep at
   129 <= D <= 512 where it goes at D <= 128 (straight: `sgm_line_kernel`;
   distinct shifts with a diagonal: `sgm_sweep3_kernel`, one block an SM
   with a problem's lines spread over the SMs; the rest: one
   `sgm_path_kernel` launch per path); the D <= 128 routes are unchanged.

On the CPU the entry points run their plan through the plain sweep, each
launch in its mode, so holding them bit for bit against the Pallas kernels
in interpret mode holds the plan; `tests/test_torch_kernels.py` holds the
kernels bit-equal to the plain sweep on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.sgm import pallas_agg
from smvs_tpu.sgm import stereo as jst
from smvs_tpu_torch.sgm import cuda_agg
from smvs_tpu_torch.sgm import stereo as tst
from torch_threads import one_torch_thread  # noqa: F401

P1, P2 = 6, 96
R = 264  # sgm_sweep3_kernel's resident blocks on the H100
B1, B2, B3 = "fused_pass", "fused_pass_batch", "fused_pass_bidir"


def _l(kernel, scan, reverse, mode, shifts, row, b0=0, nb=1, lines=0):
    return cuda_agg.Launch(kernel, scan, reverse, mode, shifts, row, b0, nb,
                           lines)


def _volume(shape, seed, hi=63):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=shape).astype(np.int16)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return cost, inten


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# 1. repeated shifts in rows 1 and 4


@pytest.mark.parametrize("entry", ["fused_pass", "fused_pass_loop"])
@pytest.mark.parametrize("shifts", [(1, 1), (0, 1, 0)])
def test_repeated_shift_route(entry, shifts):
    """One path launch per listed shift, each adding in place."""
    got = cuda_agg.plan_route(entry, 1, 1440, R, shifts=shifts,
                              reverse=True)
    assert got == [_l("path", 1, True, "add", (s,), entry) for s in shifts]


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shifts", [(1, 1), (0, 1, 0)])
def test_fused_pass_repeated_shifts_match_pallas(shifts, reverse, loop):
    """acc plus every listed path, bit for bit with the Pallas kernel in
    interpret mode and with the plain sweep; H and W not multiples of 8."""
    cost, inten = _volume((10, 13, 24), seed=len(shifts) + 2 * reverse)
    acc, _ = _volume((10, 13, 24), seed=7, hi=500)
    want = np.asarray(pallas_agg._fused_pass(
        *_j(cost, inten, acc), reverse, shifts, P1, P2, interpret=True,
        loop=loop))
    got = cuda_agg.fused_pass(*_t(cost, inten, acc), reverse, shifts, P1, P2,
                              loop=loop)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = cuda_agg.plain_fused_pass_batch(
        *[t[None] for t in _t(cost, inten, acc)], reverse, shifts, P1, P2)
    np.testing.assert_array_equal(plain[0].to(torch.int16).numpy(), want)


@pytest.mark.parametrize("shifts", [(0, 2), (2,), ()])
def test_fused_pass_rejects_shifts_outside_the_paths(shifts):
    """No SGM path has another slope than 0 and +-1."""
    cost, inten = _volume((6, 8, 16), seed=9)
    with pytest.raises(ValueError, match="shifts"):
        cuda_agg.fused_pass(*_t(cost, inten), torch.zeros(6, 8, 16,
                                                           dtype=torch.int16),
                            False, shifts, P1, P2)


# ---------------------------------------------------------------------------
# 2. more than 128 depths


DIAG = (0, 1, -1)
# (entry, B, L, kwargs) -> launches at D = 129, 192, 256 and 512: a sweep
# with a diagonal spreads a problem's L lines over the 132 SMs, ceil(L /
# 132) lines a block (13 for 1696 lines, 11 for 1440), one problem a
# launch where two do not fit (1696 or 1440 lines need 107 or 90 blocks of
# the most lines a block holds, 16 at 8 depths a lane and 14 at 16).
DEEP_ROUTES = {
    "aggregate_batch": (
        ("aggregate_batch", 2, 1696, {}),
        [_l("line", 2, False, "write", (0,), B2, 0, 2),
         _l("line", 2, True, "add", (0,), B2, 0, 2)]
        + [_l("sweep3", 1, r, "add", DIAG, B1, b, 1, 13)
           for r in (False, True) for b in (0, 1)]),
    "aggregate": (
        ("aggregate", 1, 1440, {}),
        [_l("line", 2, False, "write", (0,), B3),
         _l("line", 2, True, "add", (0,), B3)]
        + [_l("sweep3", 1, r, "add", DIAG, B3, 0, 1, 11)
           for r in (False, True)]),
    "batch (0,)": (
        ("fused_pass_batch", 2, 1440, dict(shifts=(0,))),
        [_l("line", 1, False, "into", (0,), B2, 0, 2)]),
    "pass (0, 1, -1)": (
        ("fused_pass", 1, 1440, dict(shifts=DIAG, reverse=True)),
        [_l("sweep3", 1, True, "add", DIAG, B1, 0, 1, 11)]),
    "bidir (0,)": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(0,))),
        [_l("line", 1, False, "into", (0,), B3),
         _l("line", 1, True, "add", (0,), B3)]),
}


@pytest.mark.parametrize("D", [129, 192, 256, 512])
@pytest.mark.parametrize("case", list(DEEP_ROUTES))
def test_deep_routes_take_the_path_kernel(case, D):
    """At 129-512 depths a sweep takes one launch as at D <= 128 (before
    this route was redesigned every sweep here took one `sgm_path_kernel`
    launch per path): straight sweeps `sgm_line_kernel`, sweeps with a
    diagonal `sgm_sweep3_kernel` in chunks of problems."""
    (entry, B, L, kw), want = DEEP_ROUTES[case]
    assert cuda_agg.plan_route(entry, B, L, R, D=D, **kw) == want


@pytest.mark.parametrize("case", list(DEEP_ROUTES))
def test_routes_at_128_depths_are_unchanged(case):
    """At D = 128 no sweep takes the path kernel: the launch counts of
    `aggregate_batch` (2 + 2) and `fused_pass_bidir` (0,) (2) stay as they
    were; `aggregate` takes 3 (its vertical pair one launch of the
    two-walk form since it was added; 4 before)."""
    (entry, B, L, kw), _ = DEEP_ROUTES[case]
    plan = cuda_agg.plan_route(entry, B, L, R, D=128, **kw)
    assert plan == cuda_agg.plan_route(entry, B, L, R, **kw)
    assert "path" not in {ln.kernel for ln in plan}
    n = {"aggregate_batch": 4, "aggregate": 3, "bidir (0,)": 2}.get(case, 1)
    assert len(plan) == n


@pytest.mark.parametrize("D", [129, 192])
def test_deep_aggregate_matches_pallas(D):
    cost, inten = _volume((9, 11, D), seed=D)
    want = np.asarray(pallas_agg.aggregate(*_j(cost, inten), P1, P2,
                                           interpret=True))
    got = cuda_agg.aggregate(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [129, 192])
def test_deep_aggregate_batch_matches_pallas(D):
    cost, inten = _volume((2, 8, 10, D), seed=D + 1)
    want = np.asarray(pallas_agg.aggregate_batch(*_j(cost, inten), P1, P2,
                                                 interpret=True))
    got = cuda_agg.aggregate_batch(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [129, 192])
def test_deep_sweeps_match_pallas(D):
    """`fused_pass` (rows 1 and 4), `fused_pass_batch` and
    `fused_pass_bidir` at D > 128, against their Pallas kernels."""
    cost, inten = _volume((9, 10, D), seed=D + 2)
    acc, _ = _volume((9, 10, D), seed=D + 3, hi=500)
    for loop in (False, True):
        want = np.asarray(pallas_agg._fused_pass(
            *_j(cost, inten, acc), True, (0, 1, -1), P1, P2, interpret=True,
            loop=loop))
        got = cuda_agg.fused_pass(*_t(cost, inten, acc), True, (0, 1, -1),
                                  P1, P2, loop=loop)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(pallas_agg._fused_pass_batch(
        *_j(cost[None], inten[None], acc[None]), False, (0,), P1, P2,
        interpret=True))
    got = cuda_agg.fused_pass_batch(*_t(cost[None], inten[None], acc[None]),
                                    False, (0,), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(pallas_agg._fused_pass_bidir(
        *_j(cost, inten, acc), (0, 1, -1), P1, P2, interpret=True))
    got = cuda_agg.fused_pass_bidir(*_t(cost, inten, acc), (0, 1, -1), P1,
                                    P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [129, 192])
def test_deep_scan_direction_matches_pallas(D):
    rng = np.random.default_rng(D + 4)
    cost = rng.integers(30000, 90000, size=(7, 9, D)).astype(np.int32)
    inten = rng.integers(0, 255, size=(7, 9)).astype(np.int32)
    for shift in (0, 1, -1):
        want = np.asarray(pallas_agg.scan_direction(
            *_j(cost, inten), shift, P1, P2, interpret=True))
        got = cuda_agg.scan_direction(*_t(cost, inten), shift, P1, P2)
        np.testing.assert_array_equal(got.numpy(), want)


def test_reconstruct_with_192_planes_matches_jax():
    """`stereo.reconstruct` with `num_steps=192` at dim 96, on the scene
    and in the terms of tests/test_torch_general.py: masks agree on >=
    99.5% of pixels, and >= 99% of the pixels valid in both agree to rtol
    1e-4."""
    dim = 96
    scene = jsyn.make_two_view_scene(dim=dim, rotate=False, baseline=0.25,
                                     texture="noise")
    cm, cn = scene.cameras[1], scene.cameras[0]
    mats = [np.asarray(a, np.float32) for a in (
        *cm.fill_reprojection(cn, dim, dim, dim, dim),
        *cn.fill_reprojection(cm, dim, dim, dim, dim))]
    main = scene.images[1] * np.float32(255.0)
    nbr = scene.images[0] * np.float32(255.0)
    want = np.asarray(jst.reconstruct(
        jnp.asarray(main), jnp.asarray(nbr), *_j(*mats), (4.0, 8.5),
        (4.0, 8.5), jst.SGMOptions(num_steps=192)))
    got = tst.reconstruct(torch.from_numpy(main), torch.from_numpy(nbr),
                          *_t(*mats), (4.0, 8.5), (4.0, 8.5),
                          tst.SGMOptions(num_steps=192)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (want > 0).mean() > 0.8
    assert ((got > 0) == (want > 0)).mean() >= 0.995
    both = (got > 0) & (want > 0)
    close = np.abs(got[both] - want[both]) <= 1e-4 * np.abs(want[both])
    assert close.mean() >= 0.99
    gt = scene.depths[1]
    m = got > 0
    assert np.median(np.abs(got[m] - gt[m]) / gt[m]) < 0.03
