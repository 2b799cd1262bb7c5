"""The port's plain aggregation entry points for TPU kernel rows 3-5
against the Pallas kernels in interpret mode, bit for bit, on the CPU.

Row 3 is `_fused_pass_bidir` (and `aggregate`, which runs it), row 4
`_fused_pass(loop=True)`, row 5 `scan_direction`. The CUDA kernel that
replaces them is held against these plain versions on the card
(`tests/test_torch_kernels.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.sgm import pallas_agg
from smvs_tpu.sgm import stereo as jst
from smvs_tpu_torch.sgm import cuda_agg
from torch_threads import one_torch_thread  # noqa: F401


def _volume(shape, seed, lo=0, hi=63, dtype=np.int16):
    rng = np.random.default_rng(seed)
    cost = rng.integers(lo, hi, size=shape).astype(dtype)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return cost, inten


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1)])
def test_fused_pass_bidir_matches_pallas(shifts):
    cost, inten = _volume((10, 12, 16), seed=8)
    acc, _ = _volume((10, 12, 16), seed=9, hi=500)
    want = np.asarray(pallas_agg._fused_pass_bidir(
        jnp.asarray(cost), jnp.asarray(inten), jnp.asarray(acc), shifts, 6,
        96, interpret=True))
    got = cuda_agg.fused_pass_bidir(*_t(cost, inten, acc), shifts, 6, 96)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(11, 13, 16), (9, 14, 24), (8, 16, 16)])
def test_aggregate_matches_pallas(shape):
    """H, W not multiples of 8 (the TPU pads them) and D in {16, 24}."""
    cost, inten = _volume(shape, seed=sum(shape), dtype=np.int32)
    want = np.asarray(pallas_agg.aggregate(jnp.asarray(cost),
                                           jnp.asarray(inten), 6, 96,
                                           interpret=True))
    got = cuda_agg.aggregate(*_t(cost, inten), 6, 96)
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)
    # and the lax.scan reference the Pallas kernels are held to
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jst.aggregate(jnp.asarray(cost),
                                              jnp.asarray(inten), 6, 96)))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1)])
@pytest.mark.parametrize("xb", [1, 4])
def test_fused_pass_loop_matches_pallas(reverse, shifts, xb):
    cost, inten = _volume((8, 12, 16), seed=10)
    acc, _ = _volume((8, 12, 16), seed=11, hi=500)
    want = np.asarray(pallas_agg._fused_pass(
        jnp.asarray(cost), jnp.asarray(inten), jnp.asarray(acc), reverse,
        shifts, 6, 96, interpret=True, xb=xb, loop=True))
    got = cuda_agg.fused_pass(*_t(cost, inten, acc), reverse, shifts, 6, 96,
                              loop=True, xb=xb)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", [16, 129, 200, 256, 512, 520])
@pytest.mark.parametrize("shift", [0, 1, -1])
def test_scan_direction_matches_pallas(shift, D):
    """int32 costs above 2^15, which int16 cannot hold; the output is the
    path cost itself, not an accumulation. L != X; D from one to 16 depths
    a lane on the card (129 and 200 unaligned), and 520 past the path
    kernel's 512 (the deep kernel's on the card)."""
    cost, inten = _volume((9, 11, D), seed=12 + shift + D, lo=30000,
                          hi=90000, dtype=np.int32)
    want = np.asarray(pallas_agg.scan_direction(
        jnp.asarray(cost), jnp.asarray(inten), shift, 6, 96, interpret=True))
    got = cuda_agg.scan_direction(*_t(cost, inten), shift, 6, 96)
    assert got.dtype == torch.int32
    assert want.max() > 1 << 15
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_reject_bad_arguments():
    cost, inten = _volume((8, 9, 16), seed=13, dtype=np.int32)
    with pytest.raises(ValueError, match="shift"):
        cuda_agg.scan_direction(*_t(cost, inten), 2, 6, 96)
    c16, i16 = _volume((8, 9, 16), seed=13)
    with pytest.raises(ValueError, match="accumulator"):
        cuda_agg.fused_pass(*_t(c16, i16, c16[:, :-1]), False, (0,), 6, 96,
                            loop=True)
    with pytest.raises(ValueError, match="intensity"):
        cuda_agg.fused_pass_bidir(*_t(c16, i16[:, :-1], c16), (0,), 6, 96)


def test_wrappers_count_no_launch_on_the_cpu():
    """The plain versions serve CPU tensors; only a kernel launch counts."""
    cost, inten = _volume((8, 9, 16), seed=14)
    cuda_agg.reset_launches()
    cuda_agg.aggregate(*_t(cost, inten), 6, 96)
    cuda_agg.fused_pass_bidir(*_t(cost, inten, cost), (0,), 6, 96)
    assert set(cuda_agg.launches) == set(cuda_agg.ROWS)
    assert all(n == 0 for n in cuda_agg.launches.values())
