"""The CUDA SGM aggregation kernel against its plain PyTorch version.

These tests need a CUDA device and skip without one. This file imports
neither JAX nor the JAX package, so on the GPU machine it runs without
the JAX test configuration:

    python -m pytest tests/test_torch_kernels.py --noconftest -q -p no:cacheprovider
"""

import pytest
import torch

from smvs_tpu_torch.sgm import cuda_agg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file on the GPU machine")
    return torch.device("cuda")


def _volume(shape, seed, device, hi=127):
    g = torch.Generator(device="cpu").manual_seed(seed)
    cost = torch.randint(0, hi, shape, generator=g, dtype=torch.int16)
    inten = torch.randint(0, 255, shape[:-1], generator=g, dtype=torch.int32)
    return cost.to(device), inten.to(device)


@pytest.mark.parametrize("shape", [(2, 11, 13, 16), (2, 10, 12, 24),
                                   (2, 37, 53, 128), (1, 9, 7, 40),
                                   (3, 6, 70, 33), (1, 9, 11, 100)])
def test_aggregate_batch_equals_plain(cuda, shape):
    cost, inten = _volume(shape, seed=sum(shape), device=cuda)
    before = cuda_agg.launches
    got = cuda_agg.aggregate_batch(cost, inten, 6, 96)
    torch.cuda.synchronize()
    assert cuda_agg.launches - before == 8
    want = cuda_agg.plain_aggregate_batch(cost, inten, 6, 96)
    assert got.dtype == torch.int16
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1)])
def test_fused_pass_equals_plain(cuda, reverse, shifts):
    cost, inten = _volume((21, 34, 128), seed=3, device=cuda)
    acc, _ = _volume((21, 34, 128), seed=4, device=cuda, hi=500)
    got = cuda_agg.fused_pass(cost, inten, acc, reverse, shifts, 6, 96)
    want = cuda_agg.plain_fused_pass_batch(cost[None], inten[None], acc[None],
                                           reverse, shifts, 6, 96)[0]
    assert torch.equal(got.to(torch.int32), want)
    assert torch.equal(acc, _volume((21, 34, 128), seed=4, device=cuda,
                                    hi=500)[0])  # input left untouched


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_pass_batch_equals_plain(cuda, reverse):
    cost, inten = _volume((2, 17, 19, 24), seed=5, device=cuda)
    acc = torch.zeros_like(cost)
    got = cuda_agg.fused_pass_batch(cost, inten, acc, reverse, (0, 1, -1),
                                    6, 96)
    want = cuda_agg.plain_fused_pass_batch(cost, inten, acc, reverse,
                                           (0, 1, -1), 6, 96)
    assert torch.equal(got.to(torch.int32), want)


def test_kernel_rejects_what_it_cannot_take(cuda):
    cost, inten = _volume((1, 8, 8, 16), seed=6, device=cuda)
    with pytest.raises(TypeError):
        cuda_agg.fused_pass_batch(cost.to(torch.int32), inten,
                                  torch.zeros_like(cost), False, (0,), 6, 96)
    with pytest.raises(ValueError):
        cuda_agg.fused_pass_batch(cost.transpose(1, 2), inten,
                                  torch.zeros_like(cost), False, (0,), 6, 96)
    wide, _ = _volume((1, 8, 8, 129), seed=7, device=cuda)
    with pytest.raises(ValueError):
        cuda_agg.aggregate_batch(wide, inten, 6, 96)
