"""The routes of the SGM aggregation entry points, on the CPU.

`cuda_agg.plan_route` decides from the shape alone which kernel runs each
sweep of a call (`sgm_line_kernel`, `sgm_sweep3_kernel`, its two-walk form
for row 3's vertical pair, or one `sgm_path_kernel` launch per path), in
which direction, and whether it writes the path cost, writes acc + path
elsewhere, or adds in place. The
cases below hold that plan for every entry point. On the CPU the entry
points run the same plan through the plain sweep, each launch in its mode
(`cuda_agg.run_plan`), so holding them bit for bit against the TPU
kernels in interpret mode holds the plan: a wrong direction, a missing
sweep or a write where an add belongs gives other sums, as the last test
shows.
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
WIDE = R * 16 + 1  # one line more than R blocks of 16 lines hold
PAIR = R * 8 + 1  # one line more than two two-walk blocks an SM hold
B1, B2 = "fused_pass", "fused_pass_batch"  # rows 1 and 2
B3 = "fused_pass_bidir"  # row 3
F, T = False, True  # directions


def _l(kernel, scan, reverse, mode, shifts, row, b0=0, nb=1, lines=0):
    return cuda_agg.Launch(kernel, scan, reverse, mode, shifts, row, b0, nb,
                           lines)


def _pair(shifts, lines=6):
    """Row 3's vertical pair in one launch of the two-walk form: 1440 lines
    spread over two blocks an SM of the H100's 132, 6 lines a block (640
    lines: one block an SM, 5 lines)."""
    return _l("sweep3_bidir", 1, F, "add", shifts, B3, lines=lines)


ROUTES = {
    "batch (0,)": (
        ("fused_pass_batch", 2, 1440, dict(shifts=(0,))),
        [_l("line", 1, F, "into", (0,), B2, 0, 2)]),
    "batch (0,) reverse, wide": (
        ("fused_pass_batch", 2, WIDE, dict(shifts=(0,), reverse=True)),
        [_l("line", 1, T, "into", (0,), B2, 0, 2)]),
    "batch (0, 1, -1)": (
        ("fused_pass_batch", 2, 1440, dict(shifts=(0, 1, -1), reverse=True)),
        [_l("sweep3", 1, T, "add", (0, 1, -1), B2, 0, 2)]),
    "batch (1,)": (
        ("fused_pass_batch", 3, 40, dict(shifts=(1,))),
        [_l("sweep3", 1, F, "add", (1,), B2, 0, 3)]),
    "batch repeated": (
        ("fused_pass_batch", 2, 40, dict(shifts=(0, 0))),
        [_l("path", 1, F, "add", (0,), B2, 0, 2)] * 2),
    "batch wide": (
        ("fused_pass_batch", 1, WIDE, dict(shifts=(0, 1, -1))),
        [_l("path", 1, F, "add", (s,), B2) for s in (0, 1, -1)]),
    "batch chunks": (
        ("fused_pass_batch", 3, 1440, dict(shifts=(-1, 0), resident=200)),
        [_l("sweep3", 1, F, "add", (-1, 0), B2, 0, 2),
         _l("sweep3", 1, F, "add", (-1, 0), B2, 2, 1)]),
    "pass (0,)": (
        ("fused_pass", 1, 1440, dict(shifts=(0,), reverse=True)),
        [_l("sweep3", 1, T, "add", (0,), B1)]),
    "pass loop (0, 1, -1)": (
        ("fused_pass_loop", 1, 1440, dict(shifts=(0, 1, -1))),
        [_l("sweep3", 1, F, "add", (0, 1, -1), "fused_pass_loop")]),
    "pass wide": (
        ("fused_pass", 1, WIDE, dict(shifts=(1, -1))),
        [_l("path", 1, F, "add", (s,), B1) for s in (1, -1)]),
    "bidir (0,)": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(0,))),
        [_l("line", 1, F, "into", (0,), B3), _l("line", 1, T, "add", (0,), B3)]),
    "bidir (0, 1, -1)": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(0, 1, -1))),
        [_pair((0, 1, -1))]),
    "bidir (0, 1, -1) at 640 lines": (
        ("fused_pass_bidir", 1, 640, dict(shifts=(0, 1, -1))),
        [_pair((0, 1, -1), 5)]),
    "bidir (1,)": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(1,))),
        [_pair((1,))]),
    "bidir (1, -1)": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(1, -1))),
        [_pair((1, -1))]),
    "bidir beyond the two-walk blocks": (
        ("fused_pass_bidir", 1, PAIR, dict(shifts=(0, 1, -1))),
        [_l("sweep3", 1, F, "add", (0, 1, -1), B3),
         _l("sweep3", 1, T, "add", (0, 1, -1), B3)]),
    "bidir few two-walk blocks": (  # 240 blocks of 6 lines, 179 resident
        ("fused_pass_bidir", 1, 1440, dict(shifts=(0, 1, -1),
                                           bidir=(132, 179))),
        [_l("sweep3", 1, F, "add", (0, 1, -1), B3),
         _l("sweep3", 1, T, "add", (0, 1, -1), B3)]),
    "bidir on 100 SMs": (  # 1440 lines: 8 a block, two blocks an SM
        ("fused_pass_bidir", 1, 1440, dict(shifts=(-1, 0),
                                           bidir=(100, 200))),
        [_l("sweep3_bidir", 1, F, "add", (-1, 0), B3, lines=8)]),
    "bidir D > 128": (
        ("fused_pass_bidir", 1, 1440, dict(shifts=(0, 1, -1), D=129)),
        [_l("sweep3", 1, F, "add", (0, 1, -1), B3, lines=11),
         _l("sweep3", 1, T, "add", (0, 1, -1), B3, lines=11)]),
    "bidir repeated": (
        ("fused_pass_bidir", 1, 40, dict(shifts=(0, 0))),
        [_l("path", 1, F, "add", (0,), B3)] * 2
        + [_l("path", 1, T, "add", (0,), B3)] * 2),
    "bidir wide": (
        ("fused_pass_bidir", 1, WIDE, dict(shifts=(0, 1, -1))),
        [_l("path", 1, r, "add", (s,), B3) for r in (F, T)
         for s in (0, 1, -1)]),
    "aggregate_batch": (
        ("aggregate_batch", 2, 1696, {}),
        [_l("line", 2, F, "write", (0,), B2, 0, 2),
         _l("line", 2, T, "add", (0,), B2, 0, 2),
         _l("sweep3", 1, F, "add", (0, 1, -1), B1, 0, 2),
         _l("sweep3", 1, T, "add", (0, 1, -1), B1, 0, 2)]),
    "aggregate_batch wide": (
        ("aggregate_batch", 1, WIDE, {}),
        [_l("line", 2, F, "write", (0,), B2), _l("line", 2, T, "add", (0,), B2)]
        + [_l("path", 1, r, "add", (s,), B1) for r in (F, T)
           for s in (0, 1, -1)]),
    "aggregate": (
        ("aggregate", 1, 1440, {}),
        [_l("line", 2, F, "write", (0,), B3), _l("line", 2, T, "add", (0,), B3),
         _pair((0, 1, -1))]),
    "aggregate at 640 lines": (
        ("aggregate", 1, 640, {}),
        [_l("line", 2, F, "write", (0,), B3), _l("line", 2, T, "add", (0,), B3),
         _pair((0, 1, -1), 5)]),
    "aggregate beyond the two-walk blocks": (
        ("aggregate", 1, PAIR, {}),
        [_l("line", 2, F, "write", (0,), B3), _l("line", 2, T, "add", (0,), B3),
         _l("sweep3", 1, F, "add", (0, 1, -1), B3),
         _l("sweep3", 1, T, "add", (0, 1, -1), B3)]),
    "aggregate D > 128": (
        ("aggregate", 1, 1440, dict(D=256)),
        [_l("line", 2, F, "write", (0,), B3), _l("line", 2, T, "add", (0,), B3),
         _l("sweep3", 1, F, "add", (0, 1, -1), B3, lines=11),
         _l("sweep3", 1, T, "add", (0, 1, -1), B3, lines=11)]),
    "aggregate wide": (
        ("aggregate", 1, WIDE, {}),
        [_l("line", 2, F, "write", (0,), B3), _l("line", 2, T, "add", (0,), B3)]
        + [_l("path", 1, r, "add", (s,), B3) for r in (F, T)
           for s in (0, 1, -1)]),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_plan_route(case):
    (entry, B, L, kw), want = ROUTES[case]
    kw = {"resident": R, **kw}
    got = cuda_agg.plan_route(entry, B, L, **kw)
    assert got == want


@pytest.mark.parametrize("entry, shifts", [
    ("fused_pass", (0, 0, 2)), ("fused_pass_loop", (0, 2)),
    ("fused_pass_batch", (0, 2)), ("fused_pass_bidir", ()),
    ("fused_pass_batch", ())])
def test_plan_route_rejects_shifts_the_kernels_cannot_take(entry, shifts):
    with pytest.raises(ValueError, match="shifts"):
        cuda_agg.plan_route(entry, 1, 16, R, shifts=shifts)


def _volume(shape, seed, hi=63):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=shape).astype(np.int16)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return cost, inten


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("D", [16, 24, 40])
def test_aggregate_plan_matches_pallas(D):
    """H and W not multiples of 8."""
    cost, inten = _volume((9, 13, D), seed=D)
    want = np.asarray(pallas_agg.aggregate(*_j(cost, inten), P1, P2,
                                           interpret=True))
    got = cuda_agg.aggregate(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [16, 24, 40])
def test_aggregate_batch_plan_matches_pallas(D):
    cost, inten = _volume((2, 11, 10, D), seed=D + 1)
    want = np.asarray(pallas_agg.aggregate_batch(*_j(cost, inten), P1, P2,
                                                 interpret=True))
    got = cuda_agg.aggregate_batch(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shifts, D", [((0,), 16), ((0, 1, -1), 24),
                                       ((1,), 40), ((0, 0), 16)])
def test_fused_pass_bidir_plan_matches_pallas(shifts, D):
    cost, inten = _volume((10, 13, D), seed=D + 2)
    acc, _ = _volume((10, 13, D), seed=D + 3, hi=500)
    want = np.asarray(pallas_agg._fused_pass_bidir(
        *_j(cost, inten, acc), shifts, P1, P2, interpret=True))
    got = cuda_agg.fused_pass_bidir(*_t(cost, inten, acc), shifts, P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("X", [1, 2, 3, 8, 9])
@pytest.mark.parametrize("D", [16, 24, 40])
def test_bidir_pair_plans_match_pallas(D, X):
    """Row 3's vertical pair in one launch of the two-walk form, run
    through the plain sweep: `fused_pass_bidir` and `aggregate` bit-equal
    to the TPU kernels in interpret mode at odd and even X, down to one
    scan position."""
    cost, inten = _volume((X, 13, D), seed=D + X)
    acc, _ = _volume((X, 13, D), seed=D + X + 1, hi=500)
    for shifts in ((0, 1, -1), (1, -1)):
        assert [ln.kernel for ln in cuda_agg.plan_route(
            "fused_pass_bidir", 1, 13, R, shifts=shifts)] == ["sweep3_bidir"]
        want = np.asarray(pallas_agg._fused_pass_bidir(
            *_j(cost, inten, acc), shifts, P1, P2, interpret=True))
        got = cuda_agg.fused_pass_bidir(*_t(cost, inten, acc), shifts, P1,
                                        P2)
        np.testing.assert_array_equal(got.numpy(), want)
    assert [ln.kernel for ln in cuda_agg.plan_route("aggregate", 1, 13, R)
            ] == ["line", "line", "sweep3_bidir"]
    want = np.asarray(pallas_agg.aggregate(*_j(cost, inten), P1, P2,
                                           interpret=True))
    got = cuda_agg.aggregate(*_t(cost, inten), P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L, sms, lines", [
    (1440, 132, 6), (640, 132, 5), (132, 132, 1), (13, 132, 1),
    (1056, 132, 8), (1057, 132, 5), (2112, 132, 8), (2113, 132, 0),
    (1440, 100, 8), (1696, 132, 7)])
def test_bidir_lines(L, sms, lines):
    """The two-walk form's lines a block: L spread over one block an SM
    while a block holds at most 8 lines, else over two, else none."""
    assert cuda_agg.bidir_lines(L, sms) == lines


def test_bidir_pair_plan_bytes():
    """The two-walk launch moves each direction's bytes once: the cost and
    the accumulator read and the accumulator written per direction, 6
    volumes and the intensities twice; `aggregate`'s plan the same 11
    volumes as its four one-walk launches."""
    shape = (1, 1440, 1440, 128)
    V, inten = 1440 * 1440 * 128 * 2, 4 * 1440 * 1440
    pair = cuda_agg.plan_route("fused_pass_bidir", 1, 1440, R,
                               shifts=(0, 1, -1))
    assert cuda_agg.plan_bytes(pair, shape) == 6 * V + 2 * inten
    agg = cuda_agg.plan_route("aggregate", 1, 1440, R)
    four = cuda_agg.plan_route("aggregate", 1, 1440, R, bidir=(132, 1))
    assert len(agg) == 3 and len(four) == 4
    assert cuda_agg.plan_bytes(agg, shape) == cuda_agg.plan_bytes(
        four, shape) == 11 * V + 4 * inten
    assert len(cuda_agg.per_path_plan(pair, 128)) == 6


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shifts, D", [((0,), 24), ((0, 1, -1), 40),
                                       ((-1,), 16), ((0, 0), 24)])
def test_fused_pass_batch_plan_matches_pallas(shifts, D, reverse):
    cost, inten = _volume((2, 9, 11, D), seed=D + 4)
    acc, _ = _volume((2, 9, 11, D), seed=D + 5, hi=500)
    want = np.asarray(pallas_agg._fused_pass_batch(
        *_j(cost, inten, acc), reverse, shifts, P1, P2, interpret=True))
    got = cuda_agg.fused_pass_batch(*_t(cost, inten, acc), reverse, shifts,
                                    P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("resident, tile, kernel", [
    (2, 4, "path"),     # 4 tiles of 4 lines > 2 resident blocks
    (6, 4, "sweep3")])  # 4 tiles a problem: one problem per launch
def test_wide_and_chunked_routes_match_pallas(resident, tile, kernel):
    """The routes the card takes beyond its resident blocks, planned with
    a small block count and run through the plain sweep."""
    cost, inten = _volume((2, 8, 13, 16), seed=30 + resident)
    want = np.asarray(pallas_agg.aggregate_batch(*_j(cost, inten), P1, P2,
                                                 interpret=True))
    plan = cuda_agg.plan_route("aggregate_batch", 2, 13, resident, tile=tile)
    assert {ln.kernel for ln in plan[2:]} == {kernel}
    assert len(plan) == (2 + 6 if kernel == "path" else 2 + 4)
    got = cuda_agg.run_plan(plan, *_t(cost, inten), None, P1, P2)
    np.testing.assert_array_equal(got.numpy(), want)


def _flip(ln):
    return ln._replace(reverse=not ln.reverse)


AGG = ("aggregate_batch", None)  # the plan of aggregate_batch, no acc
BIDIR = ("fused_pass_bidir", (0,))  # the plan of fused_pass_bidir (0,)
MUTATIONS = {  # name: (plan, mutation, refused by run_plan)
    "wrong direction": (AGG, lambda p: [_flip(p[0])] + p[1:], False),
    "second sweep forward": (BIDIR, lambda p: [p[0], _flip(p[1])], False),
    "vertical sweep reversed": (
        AGG, lambda p: p[:2] + [_flip(p[2])] + p[3:], False),
    "missing sweep": (AGG, lambda p: p[:3], False),
    "missing diagonal": (
        AGG, lambda p: p[:2] + [p[2]._replace(shifts=(0, 1))] + p[3:],
        False),
    "write where acc + path belongs": (
        BIDIR, lambda p: [p[0]._replace(mode="write"), p[1]], False),
    "write where an add belongs": (
        AGG, lambda p: [p[0], p[1]._replace(mode="write")] + p[2:], True),
    "add where a write belongs": (
        AGG, lambda p: [p[0]._replace(mode="add")] + p[1:], True),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_a_wrong_plan_differs_from_pallas(mutation):
    """The comparisons above see a wrong plan: each mutation of a plan
    either gives sums that differ from the TPU kernel's, or is refused (a
    write after the first launch, an add into no accumulator)."""
    (entry, shifts), mutate, refused = MUTATIONS[mutation]
    cost, inten = _volume((2, 9, 10, 16), seed=40)
    if shifts is None:
        acc = None
        want = np.asarray(pallas_agg.aggregate_batch(
            *_j(cost, inten), P1, P2, interpret=True))
        plan = cuda_agg.plan_route(entry, 2, 10, R)
        args = _t(cost, inten) + [None]
    else:
        cost, inten = cost[0], inten[0]
        acc, _ = _volume(cost.shape, seed=41, hi=500)
        want = np.asarray(pallas_agg._fused_pass_bidir(
            *_j(cost, inten, acc), shifts, P1, P2, interpret=True))
        plan = cuda_agg.plan_route(entry, 1, 10, R, shifts=shifts)
        args = [t[None] for t in _t(cost, inten, acc)]
    got = cuda_agg.run_plan(plan, *args, P1, P2)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    bad = mutate(plan)
    if refused:
        with pytest.raises(ValueError):
            cuda_agg.run_plan(bad, *args, P1, P2)
        return
    got = cuda_agg.run_plan(bad, *args, P1, P2)
    assert not np.array_equal(got.numpy().reshape(want.shape), want)
