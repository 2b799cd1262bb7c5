"""The CUDA SGM aggregation kernels against their plain PyTorch versions,
for every TPU kernel row they replace.

The vertical sweep kernel (rows 1 and 4) gives each block a tile of lines
and trades the diagonals' edge lines between blocks at every step; the
shapes below include a ragged last tile, fewer lines than a tile, one
line, and B = 3, and one test repeats a sweep to catch a rare race. The
line kernel (the straight sweeps of rows 2 and 3) is held in both layouts
the entry points give it and in its three modes (write, add in place,
acc + path elsewhere), at depth counts that do and do not allow 16-byte
copies, one scan step, fewer lines than a block, and B = 3. At 129-512
depths both kernels run 8 or 16 depths a lane: every entry point and
mode bit-equal to plain at D = 129, 136, 256 and 512 (several lines a
block of the sweep kernel, many blocks, a ragged last block), a repeated
3-path sweep, and the geometry against the H100 stand-in. Beyond 512
depths every entry point is held to its plan's launches and bit-equal to
plain on `sgm_deep_sweep_kernel` (several lines a block, many blocks, a
ragged last block, odd and aligned D) and on `sgm_deep_kernel` where a
problem does not fit, and a repeated 3-path sweep catches a race in the
hand-off between blocks. `sgm_deep_kernel` alone is held in its three
storage modes at odd, unaligned and aligned D with a ragged last warp, on
volumes that start one element into their storage, and repeated to catch
a race in its warps' exchange. The vertical sweep kernel's two-walk form
(row 3's vertical pair at D <= 128, both directions in one launch) is held
at 1-9 scan positions (odd and even, below and around its ring's depth,
where the two walks' adds to one position cross), with a ragged last tile,
fewer lines than a block and one line, at D with and without 16-byte
copies, at other lines a block and on volumes one element into their
storage, repeated 20 times, and where its blocks do not all fit.

These tests need a CUDA device and skip without one. This file imports
neither JAX nor the JAX package, so on the GPU machine it runs without
the JAX test configuration:

    python -m pytest tests/test_torch_kernels.py --noconftest -q -p no:cacheprovider
"""

import collections

import pytest
import torch

from smvs_tpu_torch.sgm import cuda_agg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


def _planned(entry, cost, B, L, **kw):
    """Launches by row and by kernel that `plan_route` plans for ``cost``
    on its device."""
    plan = cuda_agg.plan_route(entry, B, L, **cuda_agg.plan_geometry(cost),
                               **kw)
    return (dict(collections.Counter(ln.row for ln in plan)),
            dict(collections.Counter(ln.kernel for ln in plan)))


def _launched():
    """The launch counts by row and by kernel that are not 0."""
    return ({k: v for k, v in cuda_agg.launches.items() if v},
            {k: v for k, v in cuda_agg.kernel_launches.items() if v})


def _volume(shape, seed, device, hi=127):
    g = torch.Generator(device="cpu").manual_seed(seed)
    cost = torch.randint(0, hi, shape, generator=g, dtype=torch.int16)
    inten = torch.randint(0, 255, shape[:-1], generator=g, dtype=torch.int32)
    return cost.to(device), inten.to(device)


@pytest.mark.parametrize("shape", [(2, 11, 13, 16), (2, 10, 12, 24),
                                   (2, 37, 53, 128), (1, 9, 7, 40),
                                   (3, 6, 70, 33), (1, 9, 11, 100),
                                   (2, 9, 1, 32), (3, 12, 48, 64)])
def test_aggregate_batch_equals_plain(cuda, shape):
    """Vertical sweeps over W lines: fewer than a tile, ragged, one line,
    whole tiles."""
    cost, inten = _volume(shape, seed=sum(shape), device=cuda)
    cuda_agg.reset_launches()
    got = cuda_agg.aggregate_batch(cost, inten, 6, 96)
    torch.cuda.synchronize()
    assert cuda_agg.launches["fused_pass_batch"] == 2
    assert cuda_agg.launches["fused_pass"] == 2
    want = cuda_agg.plain_aggregate_batch(cost, inten, 6, 96)
    assert got.dtype == torch.int16
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1), (1,), (-1, 0)])
@pytest.mark.parametrize("shape", [(21, 34, 128), (7, 1, 64), (9, 5, 40),
                                   (12, 35, 128), (10, 48, 16)])
def test_fused_pass_equals_plain(cuda, shape, reverse, shifts):
    cost, inten = _volume(shape, seed=3, device=cuda)
    acc, _ = _volume(shape, seed=4, device=cuda, hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass(cost, inten, acc, reverse, shifts, 6, 96)
    assert cuda_agg.launches["fused_pass"] == 1
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           reverse, shifts, 6, 96)[0]
    assert torch.equal(got.to(torch.int32), want)
    assert torch.equal(acc, _volume(shape, seed=4, device=cuda,
                                    hi=500)[0])  # input left untouched


def test_fused_pass_repeats_bit_equal(cuda):
    """A race in the blocks' hand-off shows as a rare mismatch: the 3-path
    sweep 20 times on one input, each bit-equal to the plain version."""
    shape = (300, 400, 128)
    cost, inten = _volume(shape, seed=21, device=cuda)
    acc, _ = _volume(shape, seed=22, device=cuda, hi=500)
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           False, (0, 1, -1), 6, 96)[0]
    for rep in range(20):
        got = cuda_agg.fused_pass(cost, inten, acc, False, (0, 1, -1), 6, 96)
        assert torch.equal(got.to(torch.int32), want), f"repetition {rep}"


def test_fused_pass_rejects_repeated_shifts(cuda):
    """Rows 1 and 4 take a repeated shift as the JAX kernel does (acc plus
    every listed path): one `sgm_path_kernel` launch per path, bit-equal
    to plain. Only shifts outside {0, 1, -1} are rejected."""
    cost, inten = _volume((8, 20, 32), seed=23, device=cuda)
    acc, _ = _volume((8, 20, 32), seed=30, device=cuda, hi=500)
    for loop, row in ((False, "fused_pass"), (True, "fused_pass_loop")):
        for shifts in ((1, 1), (0, 1, 0)):
            cuda_agg.reset_launches()
            got = cuda_agg.fused_pass(cost, inten, acc, True, shifts, 6, 96,
                                      loop=loop)
            assert cuda_agg.launches[row] == len(shifts)
            want = cuda_agg.plain_fused_pass_batch(
                cost[None], inten[None], acc[None], True, shifts, 6, 96)[0]
            assert torch.equal(got.to(torch.int32), want), shifts
        with pytest.raises(ValueError, match="shifts"):
            cuda_agg.fused_pass(cost, inten, acc, False, (0, 2), 6, 96,
                                loop=loop)


def test_vertical_sweep_splits_problems_beyond_the_resident_blocks(cuda):
    """One tile per problem and one problem more than the card keeps
    resident: two launches per vertical sweep."""
    _, _, resident = cuda_agg.sweep_geometry(cuda, 16)
    shape = (resident + 1, 3, 16, 16)
    cost, inten = _volume(shape, seed=24, device=cuda)
    cuda_agg.reset_launches()
    got = cuda_agg.aggregate_batch(cost, inten, 6, 96)
    assert cuda_agg.launches["fused_pass"] == 4
    want = cuda_agg.plain_aggregate_batch(cost, inten, 6, 96)
    assert torch.equal(got.to(torch.int32), want)


def test_vertical_sweep_rejects_a_problem_beyond_the_resident_blocks(cuda):
    """The sweep kernel cannot take one problem wider than the resident
    blocks; the wrapper does not raise but routes it to one
    `sgm_path_kernel` launch per path, bit-equal to the plain version."""
    tile, _, resident = cuda_agg.sweep_geometry(cuda, 16)
    cost, inten = _volume((2, resident * tile + 1, 16), seed=25, device=cuda)
    acc, _ = _volume((2, resident * tile + 1, 16), seed=26, device=cuda,
                     hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass(cost, inten, acc, False, (0, 1, -1), 6, 96)
    assert cuda_agg.launches["fused_pass"] == 3
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           False, (0, 1, -1), 6, 96)[0]
    assert torch.equal(got.to(torch.int32), want)


def test_aggregate_batch_beyond_the_resident_blocks_equals_plain(cuda):
    """W one tile more than the resident blocks hold: the vertical sweeps
    take 3 path launches each, the horizontal ones the line kernel."""
    tile, _, resident = cuda_agg.sweep_geometry(cuda, 16)
    cost, inten = _volume((1, 8, (resident + 1) * tile, 16), seed=27,
                          device=cuda)
    cuda_agg.reset_launches()
    got = cuda_agg.aggregate_batch(cost, inten, 6, 96)
    assert cuda_agg.launches["fused_pass_batch"] == 2
    assert cuda_agg.launches["fused_pass"] == 6
    want = cuda_agg.plain_aggregate_batch(cost, inten, 6, 96)
    assert torch.equal(got.to(torch.int32), want)


LINE_SHAPES = [(3, 9, 7, 1), (2, 11, 13, 24), (1, 12, 5, 33),
               (2, 7, 10, 100), (2, 21, 34, 128), (3, 1, 6, 64),
               (1, 40, 3, 128), (2, 70, 9, 128), (2, 9, 7, 129),
               (1, 11, 6, 136), (2, 40, 5, 256), (3, 1, 5, 200),
               (1, 9, 4, 512), (2, 13, 3, 300)]


@pytest.mark.parametrize("mode", ["write", "add", "into"])
@pytest.mark.parametrize("scan", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LINE_SHAPES)
def test_line_kernel_equals_plain(cuda, shape, reverse, scan, mode):
    """One launch of the line kernel over [B, A, C, D]: scan 1 is the
    lines-adjacent layout of `fused_pass_batch`, scan 2 the
    chain-contiguous one of the horizontal sweeps (a line's positions are
    one run of bytes). X = 1 and 70 scan steps, fewer lines than a block,
    D from 1 to 512 (8 and 16 depths a lane beyond 128; 129 and 300 fill
    the ring by plain loads), B = 3."""
    cost, inten = _volume(shape, seed=sum(shape) + scan, device=cuda)
    acc, _ = _volume(shape, seed=sum(shape) + 7, device=cuda, hi=500)
    keep = acc.clone()
    plan = [cuda_agg.Launch("line", scan, reverse, mode, (0,),
                            "fused_pass_batch", 0, shape[0])]
    cuda_agg.reset_launches()
    got = cuda_agg.run_plan(plan, cost, inten,
                            None if mode == "write" else acc, 6, 96)
    torch.cuda.synchronize()
    assert cuda_agg.launches["fused_pass_batch"] == 1
    base = torch.zeros_like(acc) if mode == "write" else acc
    if scan == 1:
        want = cuda_agg.plain_fused_pass_batch(cost, inten, base, reverse,
                                               (0,), 6, 96)
    else:
        want = cuda_agg.plain_fused_pass_batch(
            cost.transpose(1, 2), inten.transpose(1, 2),
            base.transpose(1, 2), reverse, (0,), 6, 96).transpose(1, 2)
    assert torch.equal(got.to(torch.int32), want)
    assert torch.equal(acc, keep)  # the input accumulator left untouched


def test_line_kernel_repeats_bit_equal(cuda):
    """Row 2's straight sweep 20 times on one input, each bit-equal to the
    plain version."""
    shape = (2, 300, 400, 128)
    cost, inten = _volume(shape, seed=28, device=cuda)
    acc, _ = _volume(shape, seed=29, device=cuda, hi=500)
    want = cuda_agg.plain_fused_pass_batch(cost, inten, acc, True, (0,), 6,
                                           96)
    for rep in range(20):
        cuda_agg.reset_launches()
        got = cuda_agg.fused_pass_batch(cost, inten, acc, True, (0,), 6, 96)
        assert cuda_agg.launches["fused_pass_batch"] == 1
        assert torch.equal(got.to(torch.int32), want), f"repetition {rep}"


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_pass_batch_equals_plain(cuda, reverse):
    cost, inten = _volume((2, 17, 19, 24), seed=5, device=cuda)
    acc = torch.zeros_like(cost)
    for shifts, n in (((0, 1, -1), 1), ((0,), 1), ((1,), 1), ((0, 0), 2),
                      ((1, 0, 1), 3)):
        cuda_agg.reset_launches()
        got = cuda_agg.fused_pass_batch(cost, inten, acc, reverse, shifts,
                                        6, 96)
        assert cuda_agg.launches["fused_pass_batch"] == n, shifts
        want = cuda_agg.plain_fused_pass_batch(cost, inten, acc, reverse,
                                               shifts, 6, 96)
        assert torch.equal(got.to(torch.int32), want), shifts


def test_kernel_rejects_what_it_cannot_take(cuda):
    cost, inten = _volume((1, 8, 8, 16), seed=6, device=cuda)
    with pytest.raises(TypeError):
        cuda_agg.fused_pass_batch(cost.to(torch.int32), inten,
                                  torch.zeros_like(cost), False, (0,), 6, 96)
    with pytest.raises(ValueError):
        cuda_agg.fused_pass_batch(cost.transpose(1, 2), inten,
                                  torch.zeros_like(cost), False, (0,), 6, 96)
    deep, _ = _volume((1, 8, 8, cuda_agg.MAX_D + 1), seed=7, device=cuda)
    cuda_agg.reset_launches()
    with pytest.raises(ValueError, match="16384"):
        cuda_agg.aggregate_batch(deep, inten, 6, 96)
    assert sum(cuda_agg.launches.values()) == 0


# 129-512: sgm_line_kernel and sgm_sweep3_kernel with 8 or 16 depths a
# lane; 513-16384: sgm_deep_sweep_kernel for a sweep of distinct shifts
# that fits, else sgm_deep_kernel, one block of `deep_shape`'s warps a
# chain per path.
DEEP = [129, 192, 256, 512, 513, 1024, 2048, 4608, 16384]


@pytest.mark.parametrize("D", DEEP)
def test_deep_aggregate_batch_and_aggregate_equal_plain(cuda, D):
    """More than 128 depths: one launch per sweep (2 horizontal, 2
    vertical with both problems in one chunk) on the line and sweep
    kernels with 8 or 16 depths per lane, and beyond 512 on the deep
    kernels, with the launches `plan_route` plans (4 where the vertical
    sweeps fit at once)."""
    cost, inten = _volume((2, 9, 13, D), seed=D, device=cuda)
    cuda_agg.reset_launches()
    got = cuda_agg.aggregate_batch(cost, inten, 6, 96)
    assert _launched() == _planned("aggregate_batch", cost, 2, 13)
    if D <= 512:
        assert (cuda_agg.launches["fused_pass_batch"],
                cuda_agg.launches["fused_pass"]) == (2, 2)
    assert torch.equal(got.to(torch.int32),
                       cuda_agg.plain_aggregate_batch(cost, inten, 6, 96))
    cuda_agg.reset_launches()
    got = cuda_agg.aggregate(cost[0], inten[0], 6, 96)
    assert _launched() == _planned("aggregate", cost, 1, 13)
    assert cuda_agg.launches["fused_pass_bidir"] == (8 if D > 8192 else 4)
    assert torch.equal(got.to(torch.int32),
                       cuda_agg.plain_aggregate(cost[0], inten[0], 6, 96))


@pytest.mark.parametrize("D", DEEP)
def test_deep_sweeps_equal_plain(cuda, D):
    """`fused_pass` (rows 1 and 4), `fused_pass_batch`, `fused_pass_bidir`
    and `scan_direction` at D > 128: one launch per sweep (line, sweep or
    deep sweep kernel), or one path (or deep) launch per path, as
    planned."""
    cost, inten = _volume((11, 14, D), seed=D + 1, device=cuda)
    acc, _ = _volume((11, 14, D), seed=D + 2, device=cuda, hi=500)
    for reverse in (False, True):
        for loop in (False, True):
            cuda_agg.reset_launches()
            got = cuda_agg.fused_pass(cost, inten, acc, reverse, (0, 1, -1),
                                      6, 96, loop=loop)
            assert _launched() == _planned(
                "fused_pass_loop" if loop else "fused_pass", cost, 1, 14,
                shifts=(0, 1, -1), reverse=reverse)
            want = cuda_agg.plain_fused_pass_batch(
                cost[None], inten[None], acc[None], reverse, (0, 1, -1), 6,
                96)[0]
            assert torch.equal(got.to(torch.int32), want)
        got = cuda_agg.fused_pass_batch(cost[None], inten[None], acc[None],
                                        reverse, (0,), 6, 96)
        want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None],
                                               acc[None], reverse, (0,), 6,
                                               96)
        assert torch.equal(got.to(torch.int32), want)
    got = cuda_agg.fused_pass_bidir(cost, inten, acc, (0, 1, -1), 6, 96)
    want = cuda_agg.plain_fused_pass_bidir(cost, inten, acc, (0, 1, -1), 6,
                                           96)
    assert torch.equal(got.to(torch.int32), want)
    cost32 = cost.to(torch.int32) * 300
    for shift in (0, 1, -1):
        got = cuda_agg.scan_direction(cost32, inten, shift, 6, 96)
        assert torch.equal(got, cuda_agg.plain_scan_direction(
            cost32, inten, shift, 6, 96))


@pytest.mark.parametrize("shape", [(11, 13, 16), (10, 12, 24),
                                   (37, 53, 128), (9, 7, 40)])
def test_aggregate_equals_plain(cuda, shape):
    """Two horizontal `sgm_line_kernel` launches and one launch of
    `sgm_sweep3_kernel`'s two-walk form for the vertical pair."""
    cost, inten = _volume(shape, seed=sum(shape), device=cuda)
    cuda_agg.reset_launches()
    got = cuda_agg.aggregate(cost, inten, 6, 96)
    torch.cuda.synchronize()
    assert cuda_agg.launches["fused_pass_bidir"] == 3
    assert _launched()[1] == {"line": 2, "sweep3_bidir": 1}
    want = cuda_agg.plain_aggregate(cost, inten, 6, 96)
    assert got.dtype == torch.int16
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1)])
def test_fused_pass_bidir_equals_plain(cuda, shifts):
    """Shifts (0,): two `sgm_line_kernel` launches; (0, 1, -1): one launch
    of `sgm_sweep3_kernel`'s two-walk form."""
    cost, inten = _volume((21, 34, 128), seed=8, device=cuda)
    acc, _ = _volume((21, 34, 128), seed=9, device=cuda, hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass_bidir(cost, inten, acc, shifts, 6, 96)
    assert cuda_agg.launches["fused_pass_bidir"] == (2 if shifts == (0,)
                                                     else 1)
    want = cuda_agg.plain_fused_pass_bidir(cost, inten, acc, shifts, 6, 96)
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_pass_loop_equals_plain(cuda, reverse):
    cost, inten = _volume((16, 30, 64), seed=10, device=cuda)
    acc, _ = _volume((16, 30, 64), seed=11, device=cuda, hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass(cost, inten, acc, reverse, (0, 1, -1), 6, 96,
                              loop=True, xb=4)
    assert cuda_agg.launches["fused_pass_loop"] == 1
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None],
                                           acc[None], reverse, (0, 1, -1),
                                           6, 96)[0]
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("shift", [0, 1, -1])
@pytest.mark.parametrize("shape", [(13, 17, 128), (9, 11, 24)])
def test_scan_direction_equals_plain(cuda, shift, shape):
    """int32 costs above 2^15; the output is the path cost itself."""
    g = torch.Generator(device="cpu").manual_seed(12 + shift)
    cost = torch.randint(30000, 90000, shape, generator=g,
                         dtype=torch.int32).to(cuda)
    inten = torch.randint(0, 255, shape[:-1], generator=g,
                          dtype=torch.int32).to(cuda)
    cuda_agg.reset_launches()
    got = cuda_agg.scan_direction(cost, inten, shift, 6, 96)
    assert cuda_agg.launches["scan_direction"] == 1
    want = cuda_agg.plain_scan_direction(cost, inten, shift, 6, 96)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


# sgm_path_kernel at every instantiation, K = 1, 2, 3, 4, 8 and 16 depths a
# lane: D that allow 16-byte pieces (16, 64, 128, 256, 512) and D that
# take the 4-byte words that cover each run (5, 40, 100, 129, 200, 300);
# X = 1 or L = 1 make every chain one position long (the corners' chains).
PATH_SHAPES = [(2, 11, 13, 16), (1, 9, 7, 5), (2, 7, 10, 40),
               (1, 12, 9, 64), (3, 6, 5, 100), (1, 13, 17, 128),
               (2, 9, 7, 129), (1, 8, 11, 200), (1, 6, 9, 256),
               (1, 7, 5, 300), (2, 5, 6, 512), (1, 1, 9, 64),
               (1, 9, 1, 129), (1, 1, 1, 512)]


def _path_volumes(shape, seed, device, mode):
    """cost (int32 above 2^15 for "write32"), intensities, accumulator."""
    cost, inten = _volume(shape, seed=seed, device=device)
    if mode == "write32":
        cost = cost.to(torch.int32) * 300 + 30000
    acc, _ = _volume(shape, seed=seed + 7, device=device, hi=500)
    return cost, inten, acc


@pytest.mark.parametrize("mode", ["add", "write", "write32"])
@pytest.mark.parametrize("scan", [1, 2])
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_path_kernel_equals_plain(cuda, shape, scan, mode):
    """One `sgm_path_kernel` launch over [B, A, C, D] in each of its three
    storage modes (int16 adding in place, int16 writing, int32 writing),
    with shifts 0, +1 and -1, forward and reverse, scanning axis 1 (lines
    adjacent) and axis 2 (a chain's positions strided by D, a diagonal's
    by D +- C D); bit-equal to the plain version."""
    cost, inten, acc = _path_volumes(shape, sum(shape) + scan, cuda, mode)
    for shift in (0, 1, -1):
        for reverse in (False, True):
            plan = [cuda_agg.Launch("path", scan, reverse, mode[:5],
                                    (shift,), "fused_pass", 0, shape[0])]
            a = acc if mode == "add" else None
            cuda_agg.reset_launches()
            got = cuda_agg.run_plan(plan, cost, inten, a, 6, 96)
            torch.cuda.synchronize()
            assert cuda_agg.kernel_launches["path"] == 1
            want = cuda_agg.plain_run_plan(plan, cost, inten, a, 6, 96)
            assert got.dtype == cost.dtype
            assert torch.equal(got, want), (shift, reverse)


def _at_odd_element(t):
    """``t`` copied into a contiguous tensor that starts one element into
    its storage."""
    store = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = store[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("D", [40, 129, 256, 512])
def test_chain_kernels_take_volumes_at_an_odd_element(cuda, D):
    """Volumes that start one element into their storage: every int16 run
    starts on the odd half of a 4-byte word, so the line, path and sweep
    kernels copy the words that cover it from one element early (at D >
    128 for the line and sweep kernels). At D = 256 and 512 that is a
    whole ring row and one word more, which the rows' padding holds; every
    mode and scan axis, bit-equal to plain."""
    shape = (2, 9, 7, D)
    for mode, kernel, shift in (("add", "path", 1), ("write", "path", -1),
                                ("write32", "path", 0), ("into", "line", 0),
                                ("add", "line", 0), ("write", "line", 0)):
        cost, inten, acc = _path_volumes(shape, D, cuda, mode)
        cost, acc = _at_odd_element(cost), _at_odd_element(acc)
        for scan in (1, 2):
            plan = [cuda_agg.Launch(kernel, scan, True, mode[:5], (shift,),
                                    "fused_pass_batch", 0, shape[0])]
            a = None if mode.startswith("write") else acc
            got = cuda_agg.run_plan(plan, cost, inten, a, 6, 96)
            want = cuda_agg.plain_run_plan(plan, cost, inten, a, 6, 96)
            assert torch.equal(got, want), (mode, kernel, scan)
    cost, inten = _volume((9, 7, D), seed=D + 1, device=cuda)
    acc, _ = _volume(cost.shape, seed=D + 2, device=cuda, hi=500)
    cost, acc = _at_odd_element(cost), _at_odd_element(acc)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass(cost, inten, acc, True, (0, 1, -1), 6, 96)
    assert _launched()[1] == {"sweep3": 1}
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           True, (0, 1, -1), 6, 96)[0]
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("D", [16, 129, 256, 512])
def test_repeated_shifts_take_the_path_kernel_at_every_entry_point(cuda, D):
    """A repeated shift in every entry point that takes shifts: one
    `sgm_path_kernel` launch per listed path (and direction), adding into
    a copy of acc, bit-equal to plain."""
    cost, inten = _volume((9, 13, D), seed=40 + D, device=cuda)
    acc, _ = _volume(cost.shape, seed=41 + D, device=cuda, hi=500)
    b3 = (cost[None], inten[None], acc[None])
    for name, fn, plain, n in (
            ("fused_pass (1, 1)",
             lambda: cuda_agg.fused_pass(cost, inten, acc, False, (1, 1), 6,
                                         96),
             lambda: cuda_agg.plain_fused_pass_batch(*b3, False, (1, 1), 6,
                                                     96)[0], 2),
            ("fused_pass(loop=True) (0, 1, 0)",
             lambda: cuda_agg.fused_pass(cost, inten, acc, True, (0, 1, 0),
                                         6, 96, loop=True),
             lambda: cuda_agg.plain_fused_pass_batch(*b3, True, (0, 1, 0), 6,
                                                     96)[0], 3),
            ("fused_pass_batch (-1, -1)",
             lambda: cuda_agg.fused_pass_batch(*b3, True, (-1, -1), 6, 96),
             lambda: cuda_agg.plain_fused_pass_batch(*b3, True, (-1, -1), 6,
                                                     96), 2),
            ("fused_pass_bidir (1, 0, 1)",
             lambda: cuda_agg.fused_pass_bidir(cost, inten, acc, (1, 0, 1),
                                               6, 96),
             lambda: cuda_agg.plain_fused_pass_bidir(cost, inten, acc,
                                                     (1, 0, 1), 6, 96), 6)):
        cuda_agg.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        assert _launched()[1] == {"path": n}, name
        assert torch.equal(got.to(torch.int32), plain()), name


@pytest.mark.parametrize("D", [16, 256])
def test_wide_problem_takes_the_path_kernel_at_every_entry_point(cuda, D):
    """One line more than the vertical sweep kernel holds at once: every
    sweep with a diagonal of every entry point takes one `sgm_path_kernel`
    launch per path (as planned), the straight sweeps their line kernel,
    bit-equal to plain."""
    tile, _, held = cuda_agg.sweep_geometry(cuda, D)
    cost, inten = _volume((3, tile * held + 1, D), seed=42 + D, device=cuda)
    acc, _ = _volume(cost.shape, seed=43 + D, device=cuda, hi=500)
    b3 = (cost[None], inten[None], acc[None])
    L = cost.shape[1]
    for entry, fn, plain, kw in (
            ("aggregate", lambda: cuda_agg.aggregate(cost, inten, 6, 96),
             lambda: cuda_agg.plain_aggregate(cost, inten, 6, 96), {}),
            ("aggregate_batch",
             lambda: cuda_agg.aggregate_batch(*b3[:2], 6, 96),
             lambda: cuda_agg.plain_aggregate_batch(*b3[:2], 6, 96), {}),
            ("fused_pass",
             lambda: cuda_agg.fused_pass(cost, inten, acc, True, (0, 1, -1),
                                         6, 96),
             lambda: cuda_agg.plain_fused_pass_batch(
                 *b3, True, (0, 1, -1), 6, 96)[0],
             {"shifts": (0, 1, -1), "reverse": True}),
            ("fused_pass_loop",
             lambda: cuda_agg.fused_pass(cost, inten, acc, False, (0, 1, -1),
                                         6, 96, loop=True),
             lambda: cuda_agg.plain_fused_pass_batch(
                 *b3, False, (0, 1, -1), 6, 96)[0], {"shifts": (0, 1, -1)}),
            ("fused_pass_batch",
             lambda: cuda_agg.fused_pass_batch(*b3, False, (1, -1), 6, 96),
             lambda: cuda_agg.plain_fused_pass_batch(*b3, False, (1, -1), 6,
                                                     96),
             {"shifts": (1, -1)}),
            ("fused_pass_bidir",
             lambda: cuda_agg.fused_pass_bidir(cost, inten, acc, (0, 1, -1),
                                               6, 96),
             lambda: cuda_agg.plain_fused_pass_bidir(cost, inten, acc,
                                                     (0, 1, -1), 6, 96),
             {"shifts": (0, 1, -1)})):
        want_launches = _planned(entry, cost, 1, L, **kw)
        assert "path" in want_launches[1], entry
        cuda_agg.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        assert _launched() == want_launches, entry
        assert torch.equal(got.to(torch.int32), plain()), entry


def test_path_kernel_repeats_bit_equal(cuda):
    """Row 5 and the per-path route of `aggregate` 10 times on one input,
    each bit-equal to the plain version (a race shows as a rare
    mismatch)."""
    g = torch.Generator(device="cpu").manual_seed(44)
    cost32 = (torch.randint(0, 127, (300, 257, 200), generator=g,
                            dtype=torch.int32) * 300).to(cuda)
    inten = torch.randint(0, 255, (300, 257), generator=g,
                          dtype=torch.int32).to(cuda)
    want = cuda_agg.plain_scan_direction(cost32, inten, -1, 6, 96)
    cost, inten2 = _volume((1, 64, 300, 256), seed=45, device=cuda)
    plan = cuda_agg.per_path_plan(cuda_agg.plan_route(
        "aggregate", 1, 300, **cuda_agg.plan_geometry(cost)), 256)
    want2 = cuda_agg.plain_run_plan(plan, cost, inten2, None, 6, 96)
    for rep in range(10):
        got = cuda_agg.scan_direction(cost32, inten, -1, 6, 96)
        assert torch.equal(got, want), f"row 5, repetition {rep}"
        got = cuda_agg.run_plan(plan, cost, inten2, None, 6, 96)
        assert torch.equal(got, want2), f"per path, repetition {rep}"


# sgm_deep_sweep_kernel at D depths on [X, L, D]: L > 132 lines, so a
# sweep with a diagonal takes several lines a block (in-block hand-off)
# and many blocks (hand-off through the edge words), with a ragged last
# block. D = 513 and 770 take neither the cp.async ring nor aligned
# pieces; D = 16384 takes the kernel for its straight sweeps only.
DEEP_SWEEP = {513: (9, 301), 520: (9, 301), 770: (7, 281), 1024: (9, 301),
              4608: (6, 201), 16384: (5, 40)}


@pytest.mark.parametrize("D", list(DEEP_SWEEP))
def test_deep_sweep_kernel_equals_plain(cuda, D):
    """Every entry point, both directions and every mode (write, into,
    add), bit-equal to the plain version, with the launches planned; every
    call but the per-path fallback's goes through `sgm_deep_sweep_kernel`."""
    X, L = DEEP_SWEEP[D]
    cost, inten = _volume((X, L, D), seed=D + 3, device=cuda)
    acc, _ = _volume((X, L, D), seed=D + 4, device=cuda, hi=500)
    b = (cost[None], inten[None], acc[None])
    calls = []
    for reverse in (False, True):
        for shifts in ((0, 1, -1), (1,), (-1, 0), (0,)):
            calls.append((
                ("fused_pass", 1, L, dict(shifts=shifts, reverse=reverse)),
                lambda r=reverse, s=shifts: cuda_agg.fused_pass(
                    cost, inten, acc, r, s, 6, 96),
                lambda r=reverse, s=shifts: cuda_agg.plain_fused_pass_batch(
                    *b, r, s, 6, 96)[0]))
        calls.append((
            ("fused_pass_loop", 1, L, dict(shifts=(0, 1, -1),
                                           reverse=reverse)),
            lambda r=reverse: cuda_agg.fused_pass(cost, inten, acc, r,
                                                  (0, 1, -1), 6, 96,
                                                  loop=True),
            lambda r=reverse: cuda_agg.plain_fused_pass_batch(
                *b, r, (0, 1, -1), 6, 96)[0]))
        for shifts in ((0,), (0, 1, -1)):
            calls.append((
                ("fused_pass_batch", 1, L, dict(shifts=shifts,
                                                reverse=reverse)),
                lambda r=reverse, s=shifts: cuda_agg.fused_pass_batch(
                    *b, r, s, 6, 96)[0],
                lambda r=reverse, s=shifts: cuda_agg.plain_fused_pass_batch(
                    *b, r, s, 6, 96)[0]))
    for shifts in ((0,), (0, 1, -1)):
        calls.append((
            ("fused_pass_bidir", 1, L, dict(shifts=shifts)),
            lambda s=shifts: cuda_agg.fused_pass_bidir(cost, inten, acc, s,
                                                       6, 96),
            lambda s=shifts: cuda_agg.plain_fused_pass_bidir(cost, inten, acc,
                                                             s, 6, 96)))
    calls.append((("aggregate", 1, L, {}),
                  lambda: cuda_agg.aggregate(cost, inten, 6, 96),
                  lambda: cuda_agg.plain_aggregate(cost, inten, 6, 96)))
    two = torch.stack([cost, cost.flip(0)]), torch.stack([inten, inten])
    calls.append((("aggregate_batch", 2, L, {}),
                  lambda: cuda_agg.aggregate_batch(*two, 6, 96),
                  lambda: cuda_agg.plain_aggregate_batch(*two, 6, 96)))
    fits = cuda_agg.deep_sweep_geometry(cuda, D)[0] > 0
    for (entry, B, lines, kw), fn, plain in calls:
        cuda_agg.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        planned = _planned(entry, cost, B, lines, **kw)
        assert _launched() == planned, (entry, kw)
        straight = kw.get("shifts") == (0,) or entry.startswith("aggregate")
        assert "deep_sweep" in planned[1] or not (fits or straight), \
            (entry, kw)
        assert torch.equal(got.to(torch.int32), plain()), (entry, kw)
    assert torch.equal(acc, _volume((X, L, D), seed=D + 4, device=cuda,
                                    hi=500)[0])  # input left untouched


def test_deep_sweep_beyond_the_resident_lines_takes_the_deep_kernel(cuda):
    """One line more than the card holds at once with a diagonal: the
    sweep keeps one `sgm_deep_kernel` launch per path, bit-equal."""
    D = 1024
    lines, _, sms = cuda_agg.deep_sweep_geometry(cuda, D)
    cost, inten = _volume((3, lines * sms + 1, D), seed=31, device=cuda)
    acc, _ = _volume(cost.shape, seed=32, device=cuda, hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass(cost, inten, acc, True, (0, 1, -1), 6, 96)
    assert _launched() == ({"fused_pass": 3}, {"deep": 3})
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           True, (0, 1, -1), 6, 96)[0]
    assert torch.equal(got.to(torch.int32), want)


def test_deep_sweep_geometry_matches_the_stand_in(cuda):
    """The card's geometry is the one CPU tensors are planned with (on an
    H100 SXM: 132 SMs, 227 KB of shared memory a block)."""
    if cuda_agg.deep_sweep_geometry(cuda, 2048)[2] != cuda_agg.H100_SMS:
        pytest.skip("not an H100 SXM")
    for D in (513, 1024, 2048, 4608, 8192, 10240, 10241, 16384):
        assert cuda_agg.deep_sweep_geometry(cuda, D) == \
            cuda_agg.deep_sweep_stand_in(D), D


def test_deep_sweep_repeats_bit_equal(cuda):
    """A race in the blocks' hand-off shows as a rare mismatch: the 3-path
    sweep at [64, 640, 1024] 20 times, each bit-equal to the plain
    version."""
    cost, inten = _volume((64, 640, 1024), seed=33, device=cuda)
    acc, _ = _volume(cost.shape, seed=34, device=cuda, hi=500)
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           False, (0, 1, -1), 6, 96)[0]
    for rep in range(20):
        cuda_agg.reset_launches()
        got = cuda_agg.fused_pass(cost, inten, acc, False, (0, 1, -1), 6, 96)
        assert cuda_agg.kernel_launches["deep_sweep"] == 1
        assert torch.equal(got.to(torch.int32), want), f"repetition {rep}"


# sgm_deep_kernel: a block of `deep_shape`'s W warps a chain, each warp a
# slice of the depths (`deep_slices`) through its own cp.async ring. D =
# 513, 2049 and 4097 are odd (every ring takes the 4-byte words that cover
# a run, and a row may start one element early); 520 and 1000 give slices
# that do not start or end on 16 bytes (174 and 248 depths) next to ones
# that do; 1024 and 16384 fill every lane with 16-byte pieces; at 1000,
# 2049 and 4097 the last warp's last lane holds part of a run (a ragged
# tail); 16384 is the 32-warp form.
DEEP_CHAIN = [513, 520, 1000, 1024, 2049, 4097, 16384]


@pytest.mark.parametrize("mode", ["add", "write", "write32"])
@pytest.mark.parametrize("D", DEEP_CHAIN)
def test_deep_kernel_equals_plain(cuda, D, mode):
    """One `sgm_deep_kernel` launch over [B, A, C, D] in each storage mode
    (int16 adding in place, int16 writing, int32 writing), with shifts 0,
    +1 and -1, forward and reverse, scanning axis 1 and axis 2 (a chain's
    positions strided by D, a diagonal's by D +- C D); bit-equal to the
    plain version."""
    shape = (2, 5, 6, D) if D < 4096 else (1, 4, 5, D)
    cost, inten, acc = _path_volumes(shape, D + len(mode), cuda, mode)
    for scan in (1, 2):
        for shift in (0, 1, -1):
            for reverse in (False, True):
                plan = [cuda_agg.Launch("deep", scan, reverse, mode[:5],
                                        (shift,), "fused_pass", 0, shape[0])]
                a = acc if mode == "add" else None
                cuda_agg.reset_launches()
                got = cuda_agg.run_plan(plan, cost, inten, a, 6, 96)
                torch.cuda.synchronize()
                assert cuda_agg.kernel_launches["deep"] == 1
                want = cuda_agg.plain_run_plan(plan, cost, inten, a, 6, 96)
                assert got.dtype == cost.dtype
                assert torch.equal(got, want), (scan, shift, reverse)


@pytest.mark.parametrize("D", [513, 1024, 2049])
def test_deep_kernel_takes_volumes_at_an_odd_element(cuda, D):
    """Volumes that start one element into their storage: no run of the
    cost or the accumulator starts on 16 bytes, and at int16 every other
    one on the odd half of a word, so each ring row holds its run from one
    element early and the staged writes start mid-piece; every mode and
    scan axis, bit-equal to plain."""
    shape = (2, 7, 5, D)
    for mode, shift in (("add", 1), ("write", -1), ("write32", 0)):
        cost, inten, acc = _path_volumes(shape, D + 5, cuda, mode)
        cost, acc = _at_odd_element(cost), _at_odd_element(acc)
        for scan in (1, 2):
            plan = [cuda_agg.Launch("deep", scan, True, mode[:5], (shift,),
                                    "fused_pass", 0, shape[0])]
            a = acc if mode == "add" else None
            got = cuda_agg.run_plan(plan, cost, inten, a, 6, 96)
            want = cuda_agg.plain_run_plan(plan, cost, inten, a, 6, 96)
            assert torch.equal(got, want), (mode, scan)


def test_deep_kernel_repeats_bit_equal(cuda):
    """A race in the warps' exchange shows as a rare mismatch: row 5 at
    [64, 640, 513] and a repeated shift adding in place at [64, 640, 1024]
    (two `sgm_deep_kernel` launches), each 20 times, each run bit-equal to
    the plain version."""
    g = torch.Generator(device="cpu").manual_seed(46)
    cost32 = (torch.randint(0, 127, (64, 640, 513), generator=g,
                            dtype=torch.int32) * 300).to(cuda)
    inten32 = torch.randint(0, 255, (64, 640), generator=g,
                            dtype=torch.int32).to(cuda)
    want32 = cuda_agg.plain_scan_direction(cost32, inten32, 1, 6, 96)
    cost, inten = _volume((64, 640, 1024), seed=47, device=cuda)
    acc, _ = _volume(cost.shape, seed=48, device=cuda, hi=500)
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           False, (1, 1), 6, 96)[0]
    for rep in range(20):
        cuda_agg.reset_launches()
        got = cuda_agg.scan_direction(cost32, inten32, 1, 6, 96)
        assert torch.equal(got, want32), f"row 5, repetition {rep}"
        got = cuda_agg.fused_pass(cost, inten, acc, False, (1, 1), 6, 96)
        assert torch.equal(got.to(torch.int32), want), f"add, repetition {rep}"
        assert cuda_agg.kernel_launches["deep"] == 3


# The line and sweep kernels at 8 and 16 depths a lane, on [X, L, D]: L >
# 132 lines, so a sweep with a diagonal takes several lines a block
# (in-block hand-off) and many blocks (hand-off through the edge words),
# with a ragged last block; D = 129 fills the ring by plain loads and
# stores a depth at a time, D = 136 copies 16-byte pieces and holds 8
# depths a lane, 256 and 512 fill every lane.
WIDE = {129: (9, 301), 136: (11, 290), 256: (8, 301), 512: (7, 277)}


@pytest.mark.parametrize("D", list(WIDE))
def test_wide_sweeps_equal_plain(cuda, D):
    """Every entry point, both directions and every shift set, bit-equal
    to the plain version, with the launches planned: every sweep of
    distinct shifts on `sgm_line_kernel` or `sgm_sweep3_kernel`, none on
    `sgm_path_kernel` but a repeated shift's and row 5's."""
    X, L = WIDE[D]
    cost, inten = _volume((X, L, D), seed=D + 5, device=cuda)
    acc, _ = _volume((X, L, D), seed=D + 6, device=cuda, hi=500)
    b = (cost[None], inten[None], acc[None])
    calls = []
    for reverse in (False, True):
        for shifts in ((0, 1, -1), (1,), (-1, 0), (0,), (1, -1)):
            calls.append((
                ("fused_pass", 1, L, dict(shifts=shifts, reverse=reverse)),
                lambda r=reverse, s=shifts: cuda_agg.fused_pass(
                    cost, inten, acc, r, s, 6, 96),
                lambda r=reverse, s=shifts: cuda_agg.plain_fused_pass_batch(
                    *b, r, s, 6, 96)[0]))
        calls.append((
            ("fused_pass_loop", 1, L, dict(shifts=(0, 1, -1),
                                           reverse=reverse)),
            lambda r=reverse: cuda_agg.fused_pass(cost, inten, acc, r,
                                                  (0, 1, -1), 6, 96,
                                                  loop=True),
            lambda r=reverse: cuda_agg.plain_fused_pass_batch(
                *b, r, (0, 1, -1), 6, 96)[0]))
        for shifts in ((0,), (0, 1, -1), (0, 0)):
            calls.append((
                ("fused_pass_batch", 1, L, dict(shifts=shifts,
                                                reverse=reverse)),
                lambda r=reverse, s=shifts: cuda_agg.fused_pass_batch(
                    *b, r, s, 6, 96)[0],
                lambda r=reverse, s=shifts: cuda_agg.plain_fused_pass_batch(
                    *b, r, s, 6, 96)[0]))
    for shifts in ((0,), (0, 1, -1)):
        calls.append((
            ("fused_pass_bidir", 1, L, dict(shifts=shifts)),
            lambda s=shifts: cuda_agg.fused_pass_bidir(cost, inten, acc, s,
                                                       6, 96),
            lambda s=shifts: cuda_agg.plain_fused_pass_bidir(cost, inten, acc,
                                                             s, 6, 96)))
    calls.append((("aggregate", 1, L, {}),
                  lambda: cuda_agg.aggregate(cost, inten, 6, 96),
                  lambda: cuda_agg.plain_aggregate(cost, inten, 6, 96)))
    two = torch.stack([cost, cost.flip(0)]), torch.stack([inten, inten])
    calls.append((("aggregate_batch", 2, L, {}),
                  lambda: cuda_agg.aggregate_batch(*two, 6, 96),
                  lambda: cuda_agg.plain_aggregate_batch(*two, 6, 96)))
    for (entry, B, lines, kw), fn, plain in calls:
        cuda_agg.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        planned = _planned(entry, cost, B, lines, **kw)
        assert _launched() == planned, (entry, kw)
        shifts = kw.get("shifts", (0, 1, -1))
        if len(set(shifts)) == len(shifts):
            assert "path" not in planned[1], (entry, kw)
        assert torch.equal(got.to(torch.int32), plain()), (entry, kw)
    assert torch.equal(acc, _volume((X, L, D), seed=D + 6, device=cuda,
                                    hi=500)[0])  # input left untouched


@pytest.mark.parametrize("D", [136, 512])
def test_wide_sweep_plans_bit_equal(cuda, D):
    """`sgm_sweep3_kernel` at 8 and 16 depths a lane through `run_plan`
    at every lines-a-block count from 1 to the geometry's most, on B = 3
    problems of 40 lines (one launch of 3 problems), and split into two
    chunks of problems (the plan for one line a block on 80 SMs)."""
    tile, _, _ = cuda_agg.sweep_geometry(cuda, D)
    cost, inten = _volume((3, 6, 40, D), seed=D + 7, device=cuda)
    acc, _ = _volume(cost.shape, seed=D + 8, device=cuda, hi=500)
    want = cuda_agg.plain_fused_pass_batch(cost, inten, acc, True,
                                           (0, 1, -1), 6, 96)
    for n in range(1, tile + 1):
        plan = [cuda_agg.Launch("sweep3", 1, True, "add", (0, 1, -1),
                                "fused_pass_batch", 0, 3, n)]
        got = cuda_agg.run_plan(plan, cost, inten, acc, 6, 96)
        assert torch.equal(got.to(torch.int32), want), n
    plan = cuda_agg.plan_route("fused_pass_batch", 3, 40,
                               cuda_agg.CPU_RESIDENT, shifts=(0, 1, -1),
                               reverse=True, D=D, wide=(1, 80))
    assert [(ln.b0, ln.nb, ln.lines) for ln in plan] == [
        (0, 2, 1), (2, 1, 1)]
    got = cuda_agg.run_plan(plan, cost, inten, acc, 6, 96)
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("D", [256, 512])
def test_wide_sweep_repeats_bit_equal(cuda, D):
    """A race in the blocks' hand-off shows as a rare mismatch: the 3-path
    sweep at [64, 640, D] (5 lines a block, 128 blocks) 20 times, each
    bit-equal to the plain version."""
    cost, inten = _volume((64, 640, D), seed=35, device=cuda)
    acc, _ = _volume(cost.shape, seed=36, device=cuda, hi=500)
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           False, (0, 1, -1), 6, 96)[0]
    for rep in range(20):
        cuda_agg.reset_launches()
        got = cuda_agg.fused_pass(cost, inten, acc, False, (0, 1, -1), 6, 96)
        assert cuda_agg.kernel_launches["sweep3"] == 1
        assert torch.equal(got.to(torch.int32), want), f"repetition {rep}"


def test_wide_sweep_beyond_the_resident_lines_takes_the_path_kernel(cuda):
    """One line more than the card holds at once at 256 depths: the 3-path
    sweep keeps one `sgm_path_kernel` launch per path, bit-equal."""
    D = 256
    tile, _, sms = cuda_agg.sweep_geometry(cuda, D)
    cost, inten = _volume((3, tile * sms + 1, D), seed=37, device=cuda)
    acc, _ = _volume(cost.shape, seed=38, device=cuda, hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass(cost, inten, acc, True, (0, 1, -1), 6, 96)
    assert _launched() == ({"fused_pass": 3}, {"path": 3})
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           True, (0, 1, -1), 6, 96)[0]
    assert torch.equal(got.to(torch.int32), want)


def test_sweep_geometry_matches_the_stand_in(cuda):
    """At 129-512 depths the card's geometry is the one CPU tensors are
    planned with (on an H100 SXM: 16 lines a block at 8 depths a lane, 14
    at 16, 132 SMs); at D <= 128 the tile stays 16 lines and two blocks an
    SM."""
    if cuda_agg.deep_sweep_geometry(cuda, 2048)[2] != cuda_agg.H100_SMS:
        pytest.skip("not an H100 SXM")
    for D in (129, 136, 256, 257, 512):
        assert cuda_agg.sweep_geometry(cuda, D) == \
            cuda_agg.sweep_stand_in(D), D
    assert cuda_agg.sweep_geometry(cuda, 128) == (
        cuda_agg.TILE, 512, cuda_agg.CPU_RESIDENT)


# sgm_sweep3_kernel's two-walk form (row 3's vertical pair at D <= 128):
# X = 1-9 scan positions, below, at and past the ring's 4 stages, odd
# (both walks at the middle position in one step) and even; L with a
# ragged last tile, fewer lines than a block, and one line; D with and
# without 16-byte copies.
BIDIR_SHAPES = [(X, L, D) for X in range(1, 10)
                for L, D in ((19, 128), (5, 40))] + [
    (7, 1, 16), (12, 35, 33), (31, 64, 100), (4, 9, 1), (40, 120, 64)]


@pytest.mark.parametrize("shifts", [(0, 1, -1), (1, -1), (1,), (-1, 0)])
@pytest.mark.parametrize("shape", BIDIR_SHAPES)
def test_bidir_sweep_equals_plain(cuda, shape, shifts):
    """One launch of the two-walk form per `fused_pass_bidir` call,
    bit-equal to plain (acc plus the forward and the backward sweep); and
    the same launch with 3 lines a block (a ragged last tile, the lines'
    diagonals handed on inside a block) and with 8."""
    cost, inten = _volume(shape, seed=sum(shape) + len(shifts), device=cuda)
    acc, _ = _volume(shape, seed=sum(shape) + 11, device=cuda, hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass_bidir(cost, inten, acc, shifts, 6, 96)
    torch.cuda.synchronize()
    assert _launched() == ({"fused_pass_bidir": 1}, {"sweep3_bidir": 1})
    want = cuda_agg.plain_fused_pass_bidir(cost, inten, acc, shifts, 6, 96)
    assert torch.equal(got.to(torch.int32), want)
    for lines in (3, 8):
        plan = [cuda_agg.Launch("sweep3_bidir", 1, False, "add", shifts,
                                "fused_pass_bidir", 0, 1, lines)]
        got = cuda_agg.run_plan(plan, cost[None], inten[None], acc[None], 6,
                                96)[0]
        assert torch.equal(got.to(torch.int32), want), lines


@pytest.mark.parametrize("lines", [1, 3, 5, 8])
@pytest.mark.parametrize("shape", [(2, 9, 37, 128), (1, 8, 21, 33),
                                   (3, 5, 7, 64)])
def test_bidir_sweep_lines_and_odd_elements_equal_plain(cuda, shape, lines):
    """The form with other lines a block (as the probe runs it), over B
    problems, on volumes that start one element into their storage (no
    16-byte copies, unaligned runs) and on aligned ones, adding in place
    into an accumulator."""
    cost, inten = _volume(shape, seed=sum(shape) + lines, device=cuda)
    acc, _ = _volume(shape, seed=lines, device=cuda, hi=500)
    plan = [cuda_agg.Launch("sweep3_bidir", 1, False, "add", (0, 1, -1),
                            "fused_pass_bidir", 0, shape[0], lines)]
    want = cuda_agg.plain_run_plan(plan, cost, inten, acc, 6, 96)
    for c, a in ((cost, acc), (_at_odd_element(cost), _at_odd_element(acc))):
        got = cuda_agg.run_plan(plan, c, inten, a, 6, 96)
        assert torch.equal(got, want)


def test_bidir_sweep_repeats_bit_equal(cuda):
    """A race between the two walks' adds, or in the hand-off between
    blocks, shows as a rare mismatch: the two-walk sweep 20 times on one
    input with an odd and an even X, each bit-equal to plain."""
    for shape in ((301, 400, 128), (300, 400, 128)):
        cost, inten = _volume(shape, seed=shape[0], device=cuda)
        acc, _ = _volume(shape, seed=23, device=cuda, hi=500)
        want = cuda_agg.plain_fused_pass_bidir(cost, inten, acc, (0, 1, -1),
                                               6, 96)
        for rep in range(20):
            got = cuda_agg.fused_pass_bidir(cost, inten, acc, (0, 1, -1), 6,
                                            96)
            assert torch.equal(got.to(torch.int32), want), (shape, rep)


def test_bidir_sweep_beyond_its_resident_blocks_takes_two_sweeps(cuda):
    """One line more than two two-walk blocks an SM hold: the two one-walk
    sweeps (their blocks hold twice the lines), bit-equal."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    L = 2 * sms * cuda_agg.BIDIR_LINES + 1
    cost, inten = _volume((3, L, 16), seed=46, device=cuda)
    acc, _ = _volume(cost.shape, seed=47, device=cuda, hi=500)
    cuda_agg.reset_launches()
    got = cuda_agg.fused_pass_bidir(cost, inten, acc, (0, 1, -1), 6, 96)
    assert _launched()[1] == {"sweep3": 2}
    want = cuda_agg.plain_fused_pass_bidir(cost, inten, acc, (0, 1, -1), 6,
                                           96)
    assert torch.equal(got.to(torch.int32), want)


def test_bidir_geometry_matches_the_stand_in(cuda):
    """On an H100 SXM the two-walk form keeps two blocks of 8 lines an SM,
    the stand-in CPU tensors are planned with."""
    if cuda_agg.deep_sweep_geometry(cuda, 2048)[2] != cuda_agg.H100_SMS:
        pytest.skip("not an H100 SXM")
    for D in (16, 128):
        assert cuda_agg.bidir_geometry(cuda, D) == (1024,
                                                    cuda_agg.CPU_RESIDENT)
