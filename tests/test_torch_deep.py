"""More than 512 depth planes on the card: the routes to
`sgm_deep_sweep_kernel` and `sgm_deep_kernel`, against the JAX package on
the CPU.

`sgm_path_kernel` holds at most 16 depths a lane (512 a warp), so
`cuda_agg.plan_route` sends every sweep of every entry point at D > 512
to the deep kernels: a sweep of distinct shifts to one
`sgm_deep_sweep_kernel` launch (with a diagonal, one per chunk of problems
whose lines the card holds at once, one block per SM), and anything else
(a repeated shift, a problem too wide, row 5) to `sgm_deep_kernel`, one
launch per path, which splits one chain's depths across the warps of a
block. The routes at D <= 512 are `tests/test_torch_faults.py`'s and
`tests/test_torch_wide.py`'s.
CPU tensors are planned with the H100's geometry
(`cuda_agg.deep_sweep_stand_in`). On the CPU the entry points run their
plan through the plain sweep, so holding them bit for bit against the
Pallas kernels in interpret mode at D = 520 holds the plan;
`tests/test_torch_kernels.py` holds both kernels bit-equal to the plain
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
LOOP = "fused_pass_loop"
D_DEEP = 520  # two warps of 10 depths a lane: 320 and 200
DIAG = (0, 1, -1)


def _l(scan, reverse, mode, shifts, row, b0=0, nb=1):
    """One `sgm_deep_kernel` launch (one path)."""
    return cuda_agg.Launch("deep", scan, reverse, mode, shifts, row, b0, nb)


def _s(scan, reverse, mode, shifts, row, b0=0, nb=1, lines=1):
    """One `sgm_deep_sweep_kernel` launch of ``lines`` lines a block."""
    return cuda_agg.Launch("deep_sweep", scan, reverse, mode, shifts, row, b0,
                           nb, lines)


def _volume(shape, seed, hi=63):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=shape).astype(np.int16)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return cost, inten


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _per_path(reverses, shifts, row, nb=1, first="add"):
    """One `sgm_deep_kernel` launch per path and direction."""
    return [_l(1, r, first if i == 0 else "add", (s,), row, 0, nb)
            for i, (r, s) in enumerate((r, s) for r in reverses
                                       for s in shifts)]


# (entry, B, L, kwargs) and the launches of the old per-path route, which
# D > 512 keeps on `sgm_deep_kernel` where the new kernel cannot take a
# sweep (and D <= 512 on `sgm_path_kernel` where the line and sweep
# kernels cannot).
PER_PATH = {
    "aggregate_batch": (
        ("aggregate_batch", 2, 1696, {}),
        [_l(2, False, "write", (0,), B2, 0, 2),
         _l(2, True, "add", (0,), B2, 0, 2)]
        + _per_path((False, True), DIAG, B1, nb=2)),
    "aggregate": (
        ("aggregate", 1, 1440, {}),
        [_l(2, False, "write", (0,), B3), _l(2, True, "add", (0,), B3)]
        + _per_path((False, True), DIAG, B3)),
    "batch (0,)": (
        ("fused_pass_batch", 2, 1440, dict(shifts=(0,))),
        [_l(1, False, "add", (0,), B2, 0, 2)]),
    "batch (0, 1, -1)": (
        ("fused_pass_batch", 1, 640, dict(shifts=DIAG, reverse=True)),
        _per_path((True,), DIAG, B2)),
    "pass (0, 1, -1)": (
        ("fused_pass", 1, 1440, dict(shifts=DIAG, reverse=True)),
        _per_path((True,), DIAG, B1)),
    "loop (0, 1, -1)": (
        ("fused_pass_loop", 1, 640, dict(shifts=DIAG)),
        _per_path((False,), DIAG, LOOP)),
    "pass (0, 1, 0)": (
        ("fused_pass", 1, 640, dict(shifts=(0, 1, 0))),
        _per_path((False,), (0, 1, 0), B1)),
    "bidir (0,)": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(0,))),
        [_l(1, False, "add", (0,), B3), _l(1, True, "add", (0,), B3)]),
}

# The new plan by D: one `sgm_deep_sweep_kernel` launch per sweep of
# distinct shifts; a sweep with a diagonal over L lines needs ceil(L /
# lines) <= 132 blocks, where a block holds at most 6 lines at D = 513, 5
# at D = 1024 and none at D = 16384 (deep_sweep_stand_in), and spreads
# them evenly: 640 lines take 5 a block; 1440 do not fit. Otherwise the
# per-path route above.
H2 = [_s(2, False, "write", (0,), B2, 0, 2),
      _s(2, True, "add", (0,), B2, 0, 2)]
H3 = [_s(2, False, "write", (0,), B3), _s(2, True, "add", (0,), B3)]
ROUTES = {
    "aggregate_batch": {  # 1696 lines: 142 blocks of 12, too many
        D: H2 + _per_path((False, True), DIAG, B1, nb=2)
        for D in (513, 1024, 16384)},
    "aggregate": {  # 1440 lines: 144 blocks of 10
        D: H3 + _per_path((False, True), DIAG, B3)
        for D in (513, 1024, 16384)},
    "batch (0,)": {D: [_s(1, False, "into", (0,), B2, 0, 2)]
                   for D in (513, 1024, 16384)},
    "batch (0, 1, -1)": {
        513: [_s(1, True, "into", DIAG, B2, lines=5)],
        1024: [_s(1, True, "into", DIAG, B2, lines=5)],
        16384: _per_path((True,), DIAG, B2)},
    "pass (0, 1, -1)": {D: _per_path((True,), DIAG, B1)
                        for D in (513, 1024, 16384)},
    "loop (0, 1, -1)": {
        513: [_s(1, False, "into", DIAG, LOOP, lines=5)],
        1024: [_s(1, False, "into", DIAG, LOOP, lines=5)],
        16384: _per_path((False,), DIAG, LOOP)},
    "pass (0, 1, 0)": {D: _per_path((False,), (0, 1, 0), B1)
                       for D in (513, 1024, 16384)},
    "bidir (0,)": {D: [_s(1, False, "into", (0,), B3),
                       _s(1, True, "add", (0,), B3)]
                   for D in (513, 1024, 16384)},
}


@pytest.mark.parametrize("D", [513, 1024, 16384])
@pytest.mark.parametrize("case", list(ROUTES))
def test_routes_beyond_512_take_the_deep_kernel(case, D):
    """Every sweep of distinct shifts takes `sgm_deep_sweep_kernel` where
    its problem's lines fit the card at once; the rest keeps
    `sgm_deep_kernel`, one launch per path."""
    (entry, B, L, kw), _ = PER_PATH[case]
    assert cuda_agg.plan_route(entry, B, L, R, D=D, **kw) == ROUTES[case][D]


def _w(kernel, scan, reverse, mode, shifts, row, b0=0, nb=1, lines=0):
    """One launch of the 512-depth route's line or sweep kernel."""
    return cuda_agg.Launch(kernel, scan, reverse, mode, shifts, row, b0, nb,
                           lines)


# The plan at D = 192, 256 and 512: every sweep of distinct shifts on
# `sgm_line_kernel` (straight) or `sgm_sweep3_kernel` (with a diagonal:
# the problem's lines spread over the 132 SMs, ceil(L / 132) a block, one
# problem a launch where two do not fit in blocks of at most 16 lines at 8
# depths a lane and 14 at 16), a repeated shift one `sgm_path_kernel`
# launch per path.
AT_512 = {
    "aggregate_batch": [_w("line", 2, False, "write", (0,), B2, 0, 2),
                        _w("line", 2, True, "add", (0,), B2, 0, 2)]
    + [_w("sweep3", 1, r, "add", DIAG, B1, b, 1, 13) for r in (False, True)
       for b in (0, 1)],
    "aggregate": [_w("line", 2, False, "write", (0,), B3),
                  _w("line", 2, True, "add", (0,), B3)]
    + [_w("sweep3", 1, r, "add", DIAG, B3, 0, 1, 11) for r in (False, True)],
    "batch (0,)": [_w("line", 1, False, "into", (0,), B2, 0, 2)],
    "batch (0, 1, -1)": [_w("sweep3", 1, True, "add", DIAG, B2, 0, 1, 5)],
    "pass (0, 1, -1)": [_w("sweep3", 1, True, "add", DIAG, B1, 0, 1, 11)],
    "loop (0, 1, -1)": [_w("sweep3", 1, False, "add", DIAG, LOOP, 0, 1, 5)],
    "pass (0, 1, 0)": [ln._replace(kernel="path")
                       for ln in PER_PATH["pass (0, 1, 0)"][1]],
    "bidir (0,)": [_w("line", 1, False, "into", (0,), B3),
                   _w("line", 1, True, "add", (0,), B3)],
}


@pytest.mark.parametrize("D", [192, 256, 512])
@pytest.mark.parametrize("case", list(PER_PATH))
def test_routes_at_512_keep_the_path_kernel(case, D):
    """At D = 512 (and 192, 256) a sweep of distinct shifts takes one
    launch (the line or the sweep kernel at 16 or 8 depths a lane; before
    this route was redesigned every launch here was the per-path route's
    on `sgm_path_kernel`), and a repeated shift keeps `sgm_path_kernel`,
    one launch per path."""
    (entry, B, L, kw), _ = PER_PATH[case]
    plan = cuda_agg.plan_route(entry, B, L, R, D=D, **kw)
    assert plan == AT_512[case]


# (entry, L, D, fits): the most lines the card holds at once with a
# diagonal, 132 blocks of deep_sweep_stand_in's lines, and one more.
WIDE = [("fused_pass", 792, 513, True), ("fused_pass", 793, 513, False),
        ("fused_pass_bidir", 660, 2048, True),
        ("fused_pass_bidir", 661, 2048, False),
        ("aggregate", 660, 1024, True), ("aggregate", 661, 1024, False),
        ("fused_pass_loop", 132, 8192, True),
        ("fused_pass_loop", 133, 8192, False),
        ("fused_pass", 4096, 16384, False), ("aggregate", 24, 16384, False)]


@pytest.mark.parametrize("entry, L, D, fits", WIDE)
def test_routes_beyond_the_resident_lines_keep_the_deep_kernel(entry, L, D,
                                                               fits):
    """A sweep with a diagonal whose lines exceed what the card holds at
    once keeps one `sgm_deep_kernel` launch per path; one that fits takes
    one `sgm_deep_sweep_kernel` launch, at most one block per SM."""
    kw = {} if entry == "aggregate" else dict(shifts=DIAG)
    plan = cuda_agg.plan_route(entry, 1, L, R, D=D, **kw)
    vertical = [(ln.kernel, ln.shifts) for ln in plan if ln.scan == 1]
    sweeps = 2 if entry in ("aggregate", "fused_pass_bidir") else 1
    if fits:
        assert vertical == [("deep_sweep", DIAG)] * sweeps
        assert all(-(-L // ln.lines) <= 132 for ln in plan if ln.scan == 1)
    else:
        assert vertical == [("deep", (s,)) for _ in range(sweeps)
                            for s in DIAG]
    horizontal = [ln.kernel for ln in plan if ln.scan == 2]
    assert horizontal == ["deep_sweep"] * (2 if entry == "aggregate" else 0)


def test_deep_sweep_stand_in():
    """The H100's geometry as CPU tensors are planned with it: warps per
    line and depths per lane (no warp holds a single depth at D = 513:
    320 + 193 straight, 192 + 192 + 129 with a diagonal), lines a block
    holds with a diagonal within 227 KB of shared memory and 640 threads,
    edge words per block, 132 SMs."""
    assert cuda_agg.deep_sweep_shape(513) == (2, 10)
    assert cuda_agg.deep_sweep_shape(2048) == (4, 16)
    assert cuda_agg.deep_sweep_shape(16384) == (32, 16)
    assert [cuda_agg.deep_sweep_shape(D, diag=True)
            for D in (513, 770, 1024, 2048, 4608)] == [
                (3, 6), (4, 8), (4, 8), (4, 16), (9, 16)]
    want = {513: 6, 1024: 5, 2048: 5, 4608: 2, 8192: 1, 10240: 1,
            10241: 0, 16384: 0}
    for D, lines in want.items():
        got, edge_words, sms = cuda_agg.deep_sweep_stand_in(D)
        W, K = cuda_agg.deep_sweep_shape(D, diag=True)
        assert (got, sms) == (lines, 132), D
        assert edge_words == 8 * (32 * W * K + 32)
        assert 32 * W * got <= cuda_agg.DEEP_SWEEP_DIAG_THREADS
        over = cuda_agg.deep_sweep_smem_bytes(got + 1, D)
        assert over > cuda_agg.H100_SMEM_PER_BLOCK or \
            32 * W * (got + 1) > cuda_agg.DEEP_SWEEP_DIAG_THREADS
        if got:
            assert cuda_agg.deep_sweep_smem_bytes(got, D) <= \
                cuda_agg.H100_SMEM_PER_BLOCK
    assert cuda_agg.deep_sweep_smem_bytes(5, 2048) == 206848


@pytest.mark.parametrize("D", [513, 520, 640, 1024, 1025, 2048, 4097, 10241,
                               16384])
def test_deep_shape(D):
    """`sgm_deep_kernel`'s warps a chain and depths a lane: K even and at
    most 16, W at most 32 (at most the launch bound's 4 below 16 depths a
    lane), W x 32 x K >= D, the default's (3, 6), (4, 8) and (4, 16) at
    513, 1024 and 2048 depths as `deep_sweep_shape` gives them with a
    diagonal; and the warps' slices (`deep_slices`) cover the D depths in
    order, each at most 32 K, none fewer than half of another's. The
    probes' 8 and 16 warps a chain keep the same rules."""
    assert cuda_agg.deep_shape(D) == cuda_agg.deep_sweep_shape(D, diag=True)
    for warps in (cuda_agg.DEEP_WARPS, 8, 16):
        W, K = cuda_agg.deep_shape(D, warps)
        assert K % 2 == 0 and 2 <= K <= 16 and 1 <= W <= 32, (warps, W, K)
        assert K == 16 or W <= warps
        assert W * 32 * K >= D
        slices = cuda_agg.deep_slices(D, warps)
        assert len(slices) == W
        first = 0
        for f, n in slices:
            assert f == first and f % K == 0 and 0 < n <= 32 * K
            first += n
        assert first == D
        sizes = [n for _, n in slices]
        assert 2 * min(sizes) >= max(sizes), (warps, sizes)
    assert [cuda_agg.deep_shape(d) for d in (513, 1024, 2048, 16384)] == [
        (3, 6), (4, 8), (4, 16), (32, 16)]


@pytest.mark.parametrize("B, L, lines, sms, want", [
    (1, 640, 5, 132, [(0, 1, 5)]),
    (2, 640, 5, 132, [(0, 1, 5), (1, 1, 5)]),
    (3, 100, 5, 132, [(0, 3, 3)]),
    (7, 30, 4, 16, [(0, 2, 4), (2, 2, 4), (4, 2, 4), (6, 1, 2)]),
    (1, 133, 1, 132, None), (1, 5, 0, 132, None)])
def test_deep_sweep_chunks(B, L, lines, sms, want):
    """Chunks of problems, each launch at most one block per SM."""
    got = cuda_agg.deep_sweep_chunks(B, L, lines, sms)
    assert got == want
    for b0, nb, n in got or ():
        assert n <= lines and nb * -(-L // n) <= sms


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


def test_deep_chunked_sweeps_match_pallas():
    """Sweeps split into chunks of problems (a small stand-in geometry: 2
    lines a block, 6 SMs), each chunk writing acc + paths for its own
    problems, then adding the backward sweep in place: bit for bit with
    the Pallas kernels at D = 520."""
    cost, inten = _volume((3, 6, 5, D_DEEP), seed=8)
    acc, _ = _volume((3, 6, 5, D_DEEP), seed=9, hi=500)
    plan = cuda_agg.plan_route("fused_pass_batch", 3, 5, R, shifts=DIAG,
                               D=D_DEEP, deep=(2, 6))
    assert plan == [_s(1, False, "into", DIAG, B2, 0, 2, 2),
                    _s(1, False, "into", DIAG, B2, 2, 1, 1)]
    want = np.asarray(pallas_agg._fused_pass_batch(
        *_j(cost, inten, acc), False, DIAG, P1, P2, interpret=True))
    got = cuda_agg.run_plan(plan, *_t(cost, inten, acc), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)
    back = [ln._replace(reverse=True, mode="add") for ln in plan]
    want = np.asarray(pallas_agg._fused_pass_batch(
        *_j(cost, inten), jnp.asarray(want), True, DIAG, P1, P2,
        interpret=True))
    got = cuda_agg.run_plan(plan + back, *_t(cost, inten, acc), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)
