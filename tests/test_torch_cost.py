"""The SGM census and the rectified sweep's cost volume: the card's kernels
(`sgm.cuda_cost`: `census_kernel`, `census_cost_kernel`) against their
plain PyTorch twins, and the plain cost volume against the JAX package.

On the CPU, the plain `_disparity_cost` is held bit for bit to the JAX
package's over the cases the kernel is held to on the card, at small
sizes: both directions of `_rectified_sgm` (the main census against the
widened neighbor canvas and the reverse), starts clipped at both ends,
odd widths, images narrower than the census band, D = 1 to 600 and a
disparity span wider than the kernel's window. The shift fractions lie on
a 1/8 grid and the intensities are integers, so every blend is exact and
XLA's fused rounding cannot differ (tests/test_torch_sgm.py). The CPU
path's dispatch and the `sgm_cost_roofline` reader are held too.

On the card (marked ``gpu``; they skip without one): `census_transform`
on random images with ties, zeros and a batch axis, and `_disparity_cost`
in every case above plus arbitrary float32 fractions, unordered shifts,
NaN, infinite and negative intensities and the rectified path's strided
``vol[0, :, :w]`` output, each bit-equal to the plain twin run on the
same card; the cost kernel's launch plan; a CUDA tensor never reaches
the plain code; and `sgm.cost` makes 4 kernel launches a rectified pair
and no read of the shifts. Run
them on the GPU machine with

    python -m pytest tests/test_torch_cost.py -m gpu --noconftest -q -p no:cacheprovider

(the CPU cases import the JAX package, which that machine does not run).
"""

import numpy as np
import pytest
import torch

from smvs_tpu_torch.sgm import cuda_agg, cuda_cost
from smvs_tpu_torch.sgm import stereo as tst
from smvs_tpu_torch.utils.timing import host_reads
from torch_threads import one_torch_thread  # noqa: F401


def _image(h, w, seed, levels=8, zero_frac=0.05):
    """Small-integer intensities (many census ties) with a few holes."""
    rng = np.random.default_rng(seed)
    img = rng.integers(1, levels, size=(h, w)).astype(np.float32) * 30.0
    img[rng.random((h, w)) < zero_frac] = 0.0
    return img


def _shifts(D, first, step):
    """``first + step * d`` for d < D, float32."""
    return (np.float32(first) + np.float32(step)
            * np.arange(D, dtype=np.float32)).astype(np.float32)


# (h, w, wn, D, first shift, step): each shift on the 1/8 grid. Cases of
# one shape share the JAX package's compiled program.
CASES = {
    "pair": (14, 20, 28, 24, -7.0, 0.625),
    "descending": (14, 20, 28, 24, 7.0, -0.625),  # the span walked back
    "clipped_low": (14, 20, 28, 24, 60.0, 0.5),  # starts clipped to 1
    "clipped_high": (14, 20, 28, 24, -60.0, -0.375),  # to P + wn
    "clipped_both": (14, 20, 28, 24, -60.0, 5.125),
    "odd_widths": (11, 21, 33, 9, -5.125, 0.75),
    "narrow": (6, 9, 9, 5, -1.5, 0.5),  # narrower than the census band
    "D1": (12, 19, 27, 1, -3.375, 0.0),
    "D5": (12, 19, 27, 5, -3.375, 0.25),
    "D33": (12, 19, 27, 33, -3.375, 0.25),  # a part chunk of planes last
    "D128": (10, 24, 40, 128, -12.0, 0.125),
    "D200": (8, 16, 30, 200, 10.0, -0.125),
    "D600": (8, 12, 20, 600, -30.0, 0.125),
    "wide_span": (8, 24, 300, 48, -250.0, 6.125),  # wider than the window
    "tiles": (37, 70, 90, 20, -10.0, 0.875),  # more than one tile each way
}


def _case(name):
    h, w, wn, D, first, step = CASES[name]
    main, nbr = _image(h, w, seed=3), _image(h, wn, seed=4)
    return main, nbr, _shifts(D, first, step)


# ---------------------------------------------------------------------------
# CPU: the plain cost volume against the JAX package


_JAX_COST = []


def _jax_cost():
    """The JAX package's census and `_disparity_cost` as one compiled
    function of (main, neighbor, shifts), made at the first call."""
    if not _JAX_COST:
        import jax

        from smvs_tpu.sgm import stereo as jst

        _JAX_COST.append(jax.jit(lambda m, n, s: jst._disparity_cost(
            *jst.census_transform(m), n, s)))
    return _JAX_COST[0]


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_cost_matches_jax(name, direction):
    """`_disparity_cost` on the CPU in `_rectified_sgm`'s two directions:
    the main census against the neighbor over the shifts, and the
    neighbor's census against the main image over their negation."""
    import jax.numpy as jnp

    main, nbr, shifts = _case(name)
    if direction:
        main, nbr, shifts = nbr, main, -shifts
    want = np.asarray(_jax_cost()(jnp.asarray(main), jnp.asarray(nbr),
                                  jnp.asarray(shifts)))
    got = tst._disparity_cost(tst.census_transform(torch.from_numpy(main)),
                              torch.from_numpy(nbr), torch.from_numpy(shifts))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_cpu_tensors_take_the_plain_code():
    """On the CPU no kernel is launched and the shifts are read once."""
    main, nbr, shifts = _case("pair")
    cuda_cost.reset_launches()
    reads = host_reads["shifts"]
    m = tst.census_transform(torch.from_numpy(main))
    got = tst._disparity_cost(m, torch.from_numpy(nbr),
                              torch.from_numpy(shifts))
    want = tst.plain_disparity_cost(
        tst.plain_census_transform(torch.from_numpy(main)),
        torch.from_numpy(nbr), torch.from_numpy(shifts))
    assert torch.equal(got, want)
    assert sum(cuda_cost.launches.values()) == 0
    assert host_reads["shifts"] == reads + 2


@pytest.mark.parametrize("names, want", [
    # the change: the two kernels' device time, other kernels left out
    ({"void (anonymous namespace)::census_cost_kernel(uint2 const*)": 4e-3,
      "(anonymous namespace)::census_kernel(float const*, ...)": 1e-3,
      "sgm_line_kernel<4>": 5.0, "elementwise_kernel": 7.0},
     100.0 * 2 * (2 * 1440 * 1440 * 128 * 2) / 3.35e12 / 5e-3),
    # the parent: the census runs as PyTorch's elementwise kernels
    ({"sgm_line_kernel<4>": 5.0, "elementwise_kernel": 7.0}, None),
])
def test_cost_roofline_reader(names, want):
    """`sgm_cost_roofline` reads the two volumes of every traced pair at
    3.35 TB/s over the census and cost kernels' device time, and nothing
    where neither ran; `sgm_kernel_roofline` does not count them."""
    from benchmarks import run
    from benchmarks.trace import Trace

    ctx = run.Context(trace=Trace(window_s=9.0, busy_s=8.0, kernel_s=names,
                                  longest_gaps=[]))
    ctx.traced_sgm_pairs = [(1440, 1440, 128)] * 2
    got = run.load_reader("sgm_cost_roofline")(ctx)
    assert got == pytest.approx(want) if want else got is None
    agg = run.load_reader("sgm_kernel_roofline")(ctx)
    assert agg == pytest.approx(run.load_reader("sgm_kernel_roofline")(
        run.Context(trace=Trace(9.0, 8.0, {"sgm_line_kernel<4>": 5.0}, []),
                    traced_sgm_pairs=ctx.traced_sgm_pairs)))
    assert run.load_reader("sgm_cost_roofline")(run.Context()) is None


# ---------------------------------------------------------------------------
# the card: the kernels against the plain twin


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(37, 45), (3, 37, 45), (2, 5, 7),
                                   (2, 64, 100), (1, 7, 10), (130, 70)])
def test_census_kernel_matches_plain(cuda, shape):
    """Random images with ties, zeros and a batch axis, and images no
    wider or taller than the census band."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 6, size=shape).astype(np.float32) * 40.0
    img[rng.random(shape) < 0.1] = 0.0
    (x,) = _on(cuda, img)
    cuda_cost.reset_launches()
    got = tst.census_transform(x)
    assert cuda_cost.launches == {"census_kernel": 1,
                                  "census_cost_kernel": 0}
    assert torch.equal(got, tst.plain_census_transform(x))


@pytest.mark.gpu
@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cost_kernel_matches_plain(cuda, name, direction):
    """Every CPU case on the card, into a fresh volume and into the
    rectified path's strided ``vol[direction, :, :w]``."""
    main, nbr, shifts = _case(name)
    if direction:
        main, nbr, shifts = nbr, main, -shifts
    main, nbr, shifts = _on(cuda, main, nbr, shifts)
    m = tst.census_transform(main)
    want = tst.plain_disparity_cost(m, nbr, shifts)
    cuda_cost.reset_launches()
    got = tst._disparity_cost(m, nbr, shifts)
    assert cuda_cost.launches["census_cost_kernel"] == 1
    assert torch.equal(got, want)
    h, w = m.shape
    vol = torch.full((2, h, w + 7, shifts.shape[0]), 255, dtype=torch.int16,
                     device=cuda)
    tst._disparity_cost(m, nbr, shifts, out=vol[direction, :, :w])
    assert torch.equal(vol[direction, :, :w], want)
    assert bool((vol[direction, :, w:] == 255).all())
    assert bool((vol[1 - direction] == 255).all())


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["ascending", "descending", "shuffled"])
def test_cost_kernel_arbitrary_fractions(cuda, order):
    """Float32 shifts off the 1/8 grid on smooth float images (the blend
    rounds: held to the twin's fused multiply-add), ascending and
    descending over a span the window holds, and shuffled over one three
    times as wide, which reloads the window at almost every plane."""
    rng = np.random.default_rng(11)
    h, w, wn, D = 40, 300, 364, 128
    main = rng.uniform(1.0, 255.0, size=(h, w)).astype(np.float32)
    nbr = rng.uniform(1.0, 255.0, size=(h, wn)).astype(np.float32)
    nbr[:, :5] = 0.0
    shifts = (np.float32(-112.70882) + np.float32(0.6288888)
              * np.arange(D, dtype=np.float32)).astype(np.float32)
    if order == "descending":
        shifts = shifts[::-1].copy()
    elif order == "shuffled":
        shifts = rng.permutation(shifts) * np.float32(3.0)
    main, nbr, shifts = _on(cuda, main, nbr, shifts)
    m = tst.census_transform(main)
    got = tst._disparity_cost(m, nbr, shifts)
    assert torch.equal(got, tst.plain_disparity_cost(m, nbr, shifts))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernels_match_plain_on_special_values(cuda, seed):
    """NaN, +-inf, -0, negative and near-overflow intensities: the census
    bit is the sign of a difference on the card, held here to `<`."""
    rng = np.random.default_rng(seed)
    imgs = []
    for shape in ((40, 60), (40, 90)):
        a = rng.uniform(1.0, 255.0, size=shape).astype(np.float32)
        u = rng.random(shape)
        a[u < 0.03] = np.nan
        a[(u >= 0.03) & (u < 0.06)] = np.inf
        a[(u >= 0.06) & (u < 0.09)] = -np.inf
        a[(u >= 0.09) & (u < 0.12)] = -0.0
        a[(u >= 0.12) & (u < 0.15)] *= -1.0
        a[(u >= 0.15) & (u < 0.18)] = 3e38
        imgs.append(a)
    main, nbr, shifts = _on(cuda, *imgs, _shifts(64, -20.0, 0.37))
    m = tst.plain_census_transform(main)
    assert torch.equal(tst.census_transform(main), m)
    got = tst._disparity_cost(m, nbr, shifts)
    assert torch.equal(got, tst.plain_disparity_cost(m, nbr, shifts))


@pytest.mark.gpu
@pytest.mark.parametrize("shape, sms, want", [
    ((1440, 1440, 1696, 128), 132, (128, 192)),  # rect2mp, direction 0
    ((1440, 1696, 1440, 128), 132, (128, 192)),  # rect2mp, direction 1
    ((304, 400, 464, 128), 132, (32, 192)),  # dtu49, direction 0: 4 groups
    ((304, 464, 400, 128), 132, (48, 192)),  # dtu49, direction 1: 3 groups
    ((9, 17, 23, 600), 132, (16, 64)),  # a tile: a group a chunk
    ((8, 12, 20, 5), 132, (16, 61)),
])
def test_cost_plan(cuda, shape, sms, want):
    """Planes a block and window columns of `census_cost_kernel`, as the
    library plans a launch: every plane in one block where the 32 x 32
    pixel tiles fill three blocks an SM, else the planes split into
    16-plane chunks over as many groups as fill them; a window of 192
    columns, or the neighbor and one plane's reach (41 columns)."""
    h, w, wn, D = shape
    group, cap = cuda_cost.cost_plan(h, w, wn, D, sms)
    assert (group, cap) == want
    tiles = -(-w // 32) * -(-h // 32)
    assert tiles * -(-D // group) >= min(3 * sms, tiles * -(-D // 16))
    with pytest.raises(ValueError):
        cuda_cost.cost_plan(h, w, wn, 0, sms)


@pytest.mark.gpu
def test_cost_kernel_repeats(cuda):
    """Twenty launches on one input give one result (a race between the
    blend, the census and the staged stores would show here)."""
    main, nbr, shifts = _on(cuda, *_case("wide_span"))
    m = tst.census_transform(main)
    first = tst._disparity_cost(m, nbr, shifts)
    for _ in range(20):
        assert torch.equal(tst._disparity_cost(m, nbr, shifts), first)


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_code(cuda, monkeypatch):
    """On the card the census and the cost launch or raise."""
    def plain(*_a, **_k):
        raise AssertionError("the plain code ran on a CUDA tensor")

    monkeypatch.setattr(tst, "plain_census_transform", plain)
    monkeypatch.setattr(tst, "plain_disparity_cost", plain)
    main, nbr, shifts = _on(cuda, *_case("pair"))
    tst._disparity_cost(tst.census_transform(main), nbr, shifts)
    with pytest.raises(TypeError):
        tst.census_transform(main.double())
    with pytest.raises(TypeError):
        tst._disparity_cost(tst.census_transform(main), nbr.double(), shifts)


@pytest.mark.gpu
def test_sgm_cost_launches_four_kernels_a_pair(cuda, monkeypatch):
    """`_rectified_sgm`'s cost stage on the card: two censuses and one cost
    volume a direction, no read of the shifts, no aggregation launch
    counted for them, and the pair's depth equal to the same call with
    the plain census and cost on the card."""
    rng = np.random.default_rng(5)
    h, w, pad = 48, 64, 8
    main = np.round(rng.uniform(20.0, 250.0, size=(h, w))).astype(np.float32)
    nbr = np.round(rng.uniform(20.0, 250.0, size=(h, w + 2 * pad))
                   ).astype(np.float32)
    main_r, nbr_r = _on(cuda, main, nbr)
    eye = torch.eye(3, device=cuda)
    shifts = torch.arange(16, dtype=torch.float32, device=cuda) * 0.75 - 4.0
    args = (main_r, nbr_r, eye, eye, torch.tensor([0.0, 0.0, 1.0],
                                                  device=cuda),
            1.0, 0.0, -4.0, 0.75, shifts, 6, 96)
    cuda_cost.reset_launches()
    cuda_agg.reset_launches()
    reads = host_reads["shifts"]
    got = tst._rectified_sgm(*args)
    assert cuda_cost.launches == {"census_kernel": 2,
                                  "census_cost_kernel": 2}
    assert sum(cuda_agg.launches.values()) == 4
    assert host_reads["shifts"] == reads
    monkeypatch.setattr(tst, "census_transform", tst.plain_census_transform)
    monkeypatch.setattr(tst, "_disparity_cost", tst.plain_disparity_cost)
    assert torch.equal(got, tst._rectified_sgm(*args))
    assert sum(cuda_cost.launches.values()) == 4
