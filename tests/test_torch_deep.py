"""More than 512 depth planes on the card: the route to `sgm_deep_kernel`,
against the JAX package on the CPU.

`sgm_path_kernel` holds at most 16 depths a lane (512 a warp), so
`cuda_agg.plan_route` sends every sweep of every entry point at D > 512
to `sgm_deep_kernel`, one launch per path, which splits one chain's
depths across the warps of a block; the routes at D <= 512 are unchanged
(`tests/test_torch_faults.py`). On the CPU the entry points run their
plan through the plain sweep, so holding them bit for bit against the
Pallas kernels in interpret mode at D = 520 holds the plan;
`tests/test_torch_kernels.py` holds the kernel bit-equal to the plain
sweep on the card, and raises past `cuda_agg.MAX_D` (16384) there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.sgm import pallas_agg
from smvs_tpu_torch.sgm import cuda_agg
from torch_threads import one_torch_thread  # noqa: F401

P1, P2 = 6, 96
R = 264  # sgm_sweep3_kernel's resident blocks on the H100
B1, B2, B3 = "fused_pass", "fused_pass_batch", "fused_pass_bidir"
D_DEEP = 520  # one full warp of 512 depths and a ragged one of 8


def _l(scan, reverse, mode, shifts, row, b0=0, nb=1):
    return cuda_agg.Launch("deep", scan, reverse, mode, shifts, row, b0, nb)


def _volume(shape, seed, hi=63):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=shape).astype(np.int16)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return cost, inten


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


ROUTES = {  # (entry, B, L, kwargs) -> launches at every D > 512
    "aggregate_batch": (
        ("aggregate_batch", 2, 1696, {}),
        [_l(2, False, "write", (0,), B2, 0, 2),
         _l(2, True, "add", (0,), B2, 0, 2)]
        + [_l(1, r, "add", (s,), B1, 0, 2) for r in (False, True)
           for s in (0, 1, -1)]),
    "aggregate": (
        ("aggregate", 1, 1440, {}),
        [_l(2, False, "write", (0,), B3), _l(2, True, "add", (0,), B3)]
        + [_l(1, r, "add", (s,), B3) for r in (False, True)
           for s in (0, 1, -1)]),
    "batch (0,)": (
        ("fused_pass_batch", 2, 1440, dict(shifts=(0,))),
        [_l(1, False, "add", (0,), B2, 0, 2)]),
    "batch (0, 1, -1)": (
        ("fused_pass_batch", 1, 640, dict(shifts=(0, 1, -1), reverse=True)),
        [_l(1, True, "add", (s,), B2) for s in (0, 1, -1)]),
    "pass (0, 1, -1)": (
        ("fused_pass", 1, 1440, dict(shifts=(0, 1, -1), reverse=True)),
        [_l(1, True, "add", (s,), B1) for s in (0, 1, -1)]),
    "loop (0, 1, -1)": (
        ("fused_pass_loop", 1, 640, dict(shifts=(0, 1, -1))),
        [_l(1, False, "add", (s,), "fused_pass_loop") for s in (0, 1, -1)]),
    "pass (0, 1, 0)": (
        ("fused_pass", 1, 640, dict(shifts=(0, 1, 0))),
        [_l(1, False, "add", (s,), B1) for s in (0, 1, 0)]),
    "bidir (0,)": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(0,))),
        [_l(1, False, "add", (0,), B3), _l(1, True, "add", (0,), B3)]),
}


@pytest.mark.parametrize("D", [513, 1024, 16384])
@pytest.mark.parametrize("case", list(ROUTES))
def test_routes_beyond_512_take_the_deep_kernel(case, D):
    (entry, B, L, kw), want = ROUTES[case]
    assert cuda_agg.plan_route(entry, B, L, R, D=D, **kw) == want


@pytest.mark.parametrize("case", list(ROUTES))
def test_routes_at_512_keep_the_path_kernel(case):
    """At D = 512 every launch stays on `sgm_path_kernel`, as before:
    the same launches, with the path kernel named."""
    (entry, B, L, kw), want = ROUTES[case]
    plan = cuda_agg.plan_route(entry, B, L, R, D=512, **kw)
    assert plan == [ln._replace(kernel="path") for ln in want]


def test_path_kernel_by_depths():
    assert [cuda_agg.path_kernel(D) for D in (1, 128, 512, 513, 16384)] == \
        ["path"] * 3 + ["deep"] * 2
    assert cuda_agg.MAX_D == 16384 and cuda_agg.PATH_MAX_D == 512


def test_deep_aggregate_matches_pallas():
    cost, inten = _volume((7, 9, D_DEEP), seed=1)
    want = np.asarray(pallas_agg.aggregate(*_j(cost, inten), P1, P2,
                                           interpret=True))
    got = cuda_agg.aggregate(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_deep_aggregate_batch_matches_pallas():
    cost, inten = _volume((2, 6, 8, D_DEEP), seed=2)
    want = np.asarray(pallas_agg.aggregate_batch(*_j(cost, inten), P1, P2,
                                                 interpret=True))
    got = cuda_agg.aggregate_batch(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("loop", [False, True])
def test_deep_fused_pass_matches_pallas(loop):
    """Rows 1 and 4 at D = 520."""
    cost, inten = _volume((7, 8, D_DEEP), seed=3)
    acc, _ = _volume((7, 8, D_DEEP), seed=4, hi=500)
    want = np.asarray(pallas_agg._fused_pass(
        *_j(cost, inten, acc), True, (0, 1, -1), P1, P2, interpret=True,
        loop=loop))
    got = cuda_agg.fused_pass(*_t(cost, inten, acc), True, (0, 1, -1), P1,
                              P2, loop=loop)
    np.testing.assert_array_equal(got.numpy(), want)


def test_deep_fused_pass_batch_and_bidir_match_pallas():
    """Rows 2 and 3 at D = 520."""
    cost, inten = _volume((7, 8, D_DEEP), seed=5)
    acc, _ = _volume((7, 8, D_DEEP), seed=6, hi=500)
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


def test_deep_scan_direction_matches_pallas():
    """Row 5 at D = 520, int32 costs above 2^15."""
    rng = np.random.default_rng(7)
    cost = rng.integers(30000, 90000, size=(5, 7, D_DEEP)).astype(np.int32)
    inten = rng.integers(0, 255, size=(5, 7)).astype(np.int32)
    for shift in (0, 1, -1):
        want = np.asarray(pallas_agg.scan_direction(
            *_j(cost, inten), shift, P1, P2, interpret=True))
        got = cuda_agg.scan_direction(*_t(cost, inten), shift, P1, P2)
        np.testing.assert_array_equal(got.numpy(), want)
