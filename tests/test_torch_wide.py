"""129 to 512 depth planes on the card: the routes to `sgm_line_kernel` and
`sgm_sweep3_kernel` at 8 and 16 depths a lane, against the JAX package on
the CPU.

Up to 512 depths one warp holds a line, so `cuda_agg.plan_route` sends a
sweep at 129 <= D <= 512 where it sends it at D <= 128: a straight sweep
to one `sgm_line_kernel` launch, a sweep of distinct shifts with a
diagonal to one cooperative `sgm_sweep3_kernel` launch per chunk of
problems whose lines the card holds at once (one block an SM, a
problem's lines spread over the SMs, `cuda_agg.deep_sweep_chunks`), and
anything else (a repeated shift, a problem too wide, row 5) to one
`sgm_path_kernel` launch per path. CPU tensors are planned with the
H100's geometry (`cuda_agg.sweep_stand_in`). On the CPU the entry points
run their plan through the plain sweep, each launch in its mode, so
holding them bit for bit against the Pallas kernels in interpret mode at
D = 256 and 512 holds the plan; `tests/test_torch_kernels.py` holds both
kernels bit-equal to the plain sweep on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.sgm import pallas_agg
from smvs_tpu_torch.sgm import cuda_agg
from torch_threads import one_torch_thread  # noqa: F401

P1, P2 = 6, 96
R = 264  # sgm_sweep3_kernel's resident blocks on the H100 at D <= 128
B1, B2, B3 = "fused_pass", "fused_pass_batch", "fused_pass_bidir"
DIAG = (0, 1, -1)


def _volume(shape, seed, hi=63):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=shape).astype(np.int16)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return cost, inten


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _s(reverse, row, b0=0, nb=1, lines=1, shifts=DIAG):
    """One `sgm_sweep3_kernel` launch of ``lines`` lines a block."""
    return cuda_agg.Launch("sweep3", 1, reverse, "add", shifts, row, b0, nb,
                           lines)


def test_sweep_stand_in():
    """The H100's geometry of `sgm_sweep3_kernel` at 129-512 depths as CPU
    tensors are planned with it: 8 depths a lane to 256, 16 beyond; the
    most lines a block holds (16, the most threads a block takes, at 8
    depths a lane; 14 at 16, within 227 KB of shared memory); edge words
    per block (2 slots x 2 directions x 32 K); 132 SMs, one block each;
    and 640 lines spread over 128 blocks of 5."""
    assert [cuda_agg.wide_sweep_k(D) for D in (129, 136, 256, 257, 512)] \
        == [8, 8, 8, 16, 16]
    for D, (lines, words) in {129: (16, 1024), 256: (16, 1024),
                              257: (14, 2048), 512: (14, 2048)}.items():
        assert cuda_agg.sweep_stand_in(D) == (lines, words, 132), D
        assert cuda_agg.sweep_smem_bytes(lines, D) <= \
            cuda_agg.H100_SMEM_PER_BLOCK
        assert lines == cuda_agg.TILE or cuda_agg.sweep_smem_bytes(
            lines + 1, D) > cuda_agg.H100_SMEM_PER_BLOCK
        assert cuda_agg.deep_sweep_chunks(1, 640, lines, 132) == \
            [(0, 1, 5)]
    # The ring's rows hold 32 K + 8 int16: a run read from one element
    # early and the word past it.
    assert cuda_agg.sweep_smem_bytes(16, 256) == 142624
    assert cuda_agg.sweep_smem_bytes(14, 512) == 219648
    # The layout at D <= 128 (16 lines, 4 stages, 4 depths a lane) is the
    # main path's, byte for byte: 70944 bytes a block.
    assert 16 * 18 * 128 + 4 * 4 * 16 * 128 + 4 * 4 * 18 + 1024 == 70944


def test_plan_geometry_of_cpu_tensors():
    """CPU tensors take the stand-in at 129-512 depths, the fixed tile at
    D <= 128, and the deep kernel's stand-in beyond 512."""
    geo = {D: cuda_agg.plan_geometry(torch.zeros(2, 3, D, dtype=torch.int16))
           for D in (128, 129, 512, 513)}
    assert geo[128] == {"resident": R, "tile": 16, "D": 128}
    assert geo[129]["wide"] == (16, 132) and "deep" not in geo[129]
    assert geo[512]["wide"] == (14, 132)
    assert "wide" not in geo[513] and geo[513]["deep"] == (6, 132)


@pytest.mark.parametrize("D", [129, 256, 512])
def test_general_path_volume_takes_one_launch_per_sweep(D):
    """`aggregate` at the general path's per-direction shape, [1440,
    1440, D]: 1440 lines resident at once, 11 a block on 131 blocks, so
    each vertical sweep is one launch (4 launches in all)."""
    plan = cuda_agg.plan_route("aggregate", 1, 1440, R, D=D)
    assert [ln.kernel for ln in plan] == ["line", "line", "sweep3", "sweep3"]
    assert [ln.lines for ln in plan if ln.kernel == "sweep3"] == [11, 11]
    assert -(-1440 // 11) == 131


# (entry, L, D, fits): the most lines the card holds at once with a
# diagonal, 132 blocks of sweep_stand_in's lines, and one more.
WIDE = [("fused_pass", 2112, 129, True), ("fused_pass", 2113, 129, False),
        ("fused_pass_loop", 2112, 256, True),
        ("fused_pass_bidir", 2113, 256, False),
        ("aggregate", 1848, 512, True), ("aggregate", 1849, 512, False),
        ("fused_pass_batch", 1848, 300, True),
        ("fused_pass_batch", 1849, 300, False)]


@pytest.mark.parametrize("entry, L, D, fits", WIDE)
def test_routes_beyond_the_resident_lines_keep_the_path_kernel(entry, L, D,
                                                               fits):
    """A sweep with a diagonal whose lines exceed what the card holds at
    once keeps one `sgm_path_kernel` launch per path; one that fits takes
    one `sgm_sweep3_kernel` launch, at most one block per SM. Straight
    sweeps take `sgm_line_kernel` at any width."""
    kw = {} if entry == "aggregate" else dict(shifts=DIAG)
    plan = cuda_agg.plan_route(entry, 1, L, R, D=D, **kw)
    vertical = [(ln.kernel, ln.shifts) for ln in plan if ln.scan == 1]
    sweeps = 2 if entry in ("aggregate", "fused_pass_bidir") else 1
    if fits:
        assert vertical == [("sweep3", DIAG)] * sweeps
        assert all(-(-L // ln.lines) <= 132 for ln in plan if ln.scan == 1)
    else:
        assert vertical == [("path", (s,)) for _ in range(sweeps)
                            for s in DIAG]
    horizontal = [ln.kernel for ln in plan if ln.scan == 2]
    assert horizontal == ["line"] * (2 if entry == "aggregate" else 0)


@pytest.mark.parametrize("D", [256, 512])
def test_wide_aggregate_matches_pallas(D):
    cost, inten = _volume((7, 9, D), seed=D + 10)
    want = np.asarray(pallas_agg.aggregate(*_j(cost, inten), P1, P2,
                                           interpret=True))
    got = cuda_agg.aggregate(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [256, 512])
def test_wide_aggregate_batch_matches_pallas(D):
    cost, inten = _volume((2, 6, 8, D), seed=D + 11)
    want = np.asarray(pallas_agg.aggregate_batch(*_j(cost, inten), P1, P2,
                                                 interpret=True))
    got = cuda_agg.aggregate_batch(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [256, 512])
def test_wide_sweeps_match_pallas(D):
    """Rows 1 and 4 both ways, rows 2 and 3 with shifts (0,) and (0, 1,
    -1), and row 5, at D = 256 and 512."""
    cost, inten = _volume((7, 8, D), seed=D + 12)
    acc, _ = _volume((7, 8, D), seed=D + 13, hi=500)
    for reverse in (False, True):
        for loop in (False, True):
            want = np.asarray(pallas_agg._fused_pass(
                *_j(cost, inten, acc), reverse, DIAG, P1, P2, interpret=True,
                loop=loop))
            got = cuda_agg.fused_pass(*_t(cost, inten, acc), reverse, DIAG,
                                      P1, P2, loop=loop)
            np.testing.assert_array_equal(got.numpy(), want)
    for shifts in ((0,), DIAG):
        want = np.asarray(pallas_agg._fused_pass_batch(
            *_j(cost[None], inten[None], acc[None]), True, shifts, P1, P2,
            interpret=True))
        got = cuda_agg.fused_pass_batch(
            *_t(cost[None], inten[None], acc[None]), True, shifts, P1, P2)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(pallas_agg._fused_pass_bidir(
            *_j(cost, inten, acc), shifts, P1, P2, interpret=True))
        got = cuda_agg.fused_pass_bidir(*_t(cost, inten, acc), shifts, P1,
                                        P2)
        np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(D + 14)
    cost32 = rng.integers(30000, 90000, size=(5, 7, D)).astype(np.int32)
    inten32 = rng.integers(0, 255, size=(5, 7)).astype(np.int32)
    want = np.asarray(pallas_agg.scan_direction(
        *_j(cost32, inten32), -1, P1, P2, interpret=True))
    got = cuda_agg.scan_direction(*_t(cost32, inten32), -1, P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [256, 512])
def test_wide_chunked_sweeps_match_pallas(D):
    """Sweeps split into chunks of problems (a small stand-in geometry: 2
    lines a block, 6 SMs), each adding acc + paths for its own problems
    into a copy of acc, then the backward sweep in place: through
    `cuda_agg.run_plan`, bit for bit with the Pallas kernels."""
    cost, inten = _volume((3, 6, 5, D), seed=D + 15)
    acc, _ = _volume((3, 6, 5, D), seed=D + 16, hi=500)
    plan = cuda_agg.plan_route("fused_pass_batch", 3, 5, R, shifts=DIAG,
                               D=D, wide=(2, 6))
    assert plan == [_s(False, B2, 0, 2, 2), _s(False, B2, 2, 1, 1)]
    want = np.asarray(pallas_agg._fused_pass_batch(
        *_j(cost, inten, acc), False, DIAG, P1, P2, interpret=True))
    got = cuda_agg.run_plan(plan, *_t(cost, inten, acc), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)
    back = [ln._replace(reverse=True) for ln in plan]
    want = np.asarray(pallas_agg._fused_pass_batch(
        *_j(cost, inten), jnp.asarray(want), True, DIAG, P1, P2,
        interpret=True))
    got = cuda_agg.run_plan(plan + back, *_t(cost, inten, acc), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [256, 512])
def test_wide_plan_against_the_per_path_plan(D):
    """`aggregate`'s plan at [640, 640, D] is 4 launches (none of them
    `sgm_path_kernel`) and the per-path plan (`cuda_agg.per_path_plan`,
    the route before: 8 `sgm_path_kernel` launches) moves 23 volumes
    against 11; both give the Pallas kernels' sums on a small volume
    through `cuda_agg.run_plan`."""
    plan = cuda_agg.plan_route("aggregate", 1, 640, R, D=D)
    per_path = cuda_agg.per_path_plan(plan, D)
    assert [ln.kernel for ln in plan] == ["line", "line", "sweep3", "sweep3"]
    assert [ln.kernel for ln in per_path] == ["path"] * 8
    shape = (1, 640, 640, D)
    vol = 640 * 640 * D * 2
    inten = 640 * 640 * 4
    assert cuda_agg.plan_bytes(plan, shape) == 11 * vol + 4 * inten
    assert cuda_agg.plan_bytes(per_path, shape) == 23 * vol + 8 * inten
    cost, it = _volume((1, 6, 7, D), seed=D + 17)
    want = np.asarray(pallas_agg.aggregate(*_j(cost[0], it[0]), P1, P2,
                                           interpret=True))
    small = cuda_agg.plan_route("aggregate", 1, 7, R, D=D)
    for p in (small, cuda_agg.per_path_plan(small, D)):
        got = cuda_agg.run_plan(p, *_t(cost, it), None, P1, P2)
        np.testing.assert_array_equal(got[0].numpy(), want)
