"""The tile schedule of the vertical sweep kernel, modelled in plain
PyTorch on the CPU and held bit for bit against the plain sweep.

`sgm_sweep3_kernel` (`smvs_tpu_torch/csrc/sgm_agg.cu`) gives each block a
tile of T consecutive lines of one problem and walks the scan axis. A
diagonal's carried line moves to the next line at each step, so a block
trades its lines: in a shared buffer by step parity inside the block, and
with the neighbouring blocks through a two-slot (step parity) edge buffer
in device memory, whose words carry the step that wrote them. A block's
edge warps wait until their neighbours' edge lines carry the previous
step before they compute and write their own. `tile_schedule` below does
what the blocks do, one block step at a time, in an order that a seeded
random scheduler picks among the blocks whose waits are met, and asserts
that every edge slot it reads carries the previous step, so a read of a
wrong or overwritten slot fails at once. Also here: the wrapper's split
of B problems into launches (`cuda_agg.plan_chunks`), and the model
against the TPU kernel (`_fused_pass` in interpret mode).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.sgm import pallas_agg
from smvs_tpu_torch.sgm import cuda_agg
from torch_threads import one_torch_thread  # noqa: F401

BIG = cuda_agg.BIG
P1, P2 = 6, 96


def _volume(shape, seed, hi=63):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=shape).astype(np.int16)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return torch.from_numpy(cost), torch.from_numpy(inten)


def tile_schedule(cost, inten, acc, reverse: bool, shifts: tuple, p1: int,
                  p2: int, T: int, seed: int = 0) -> torch.Tensor:
    """acc plus the paths of ``shifts``, computed block by block as the
    kernel does: a block steps only when both neighbours have finished
    the previous step (whenever a diagonal runs, its edge warps wait on
    both), reads its own lines' diagonal values from its parity buffer of
    the previous step and its neighbours' edge lines from their edge slot
    of the previous step, and writes its new lines and edges into the
    slots of this step's parity."""
    B, X, L, D = cost.shape
    tiles = -(-L // T)
    out = acc.to(torch.int32, copy=True)
    inten = inten.to(torch.int32)
    order = list(range(X - 1, -1, -1)) if reverse else list(range(X))
    diag = any(shifts)
    p2min = p1 * 3 // 2
    big = torch.full((1, D), BIG, dtype=torch.int32)

    progress = [[-1] * tiles for _ in range(B)]
    carried = {}  # (b, tile) -> own straight line of the previous step
    shared = {}   # (b, tile, parity, shift) -> the block's diagonal lines
    edge = {}     # (b, tile, parity, shift) -> (step, edge line)

    def p2a(it, pi):
        return torch.clamp(p2 // (torch.abs(it - pi) + 1), min=p2min)

    def neighbour_edge(b, k, par, shift, t):
        step, line = edge[(b, k, par, shift)]
        assert step == t - 1, f"edge slot of step {step} read at step {t}"
        return line[None]

    def step(b, k, t):
        l0 = k * T
        n = min(T, L - l0)
        x = order[t]
        c = cost[b, x, l0:l0 + n].to(torch.int32)
        total = out[b, x, l0:l0 + n]
        par, pp = t & 1, (t - 1) & 1
        for shift in shifts:
            if t == 0:
                new = c
            else:
                pi_line = inten[b, order[t - 1]]
                if shift == 0:
                    prev = carried[(b, k)]
                    pi = pi_line[l0:l0 + n]
                elif shift == 1:  # line l takes line l-1's value
                    own = shared[(b, k, pp, 1)][:-1]
                    left = (big if k == 0 else
                            neighbour_edge(b, k - 1, pp, 1, t))
                    prev = torch.cat([left, own])
                    pi = torch.cat([pi_line[:1] if k == 0 else
                                    pi_line[l0 - 1:l0],
                                    pi_line[l0:l0 + n - 1]])
                else:  # line l takes line l+1's value
                    own = shared[(b, k, pp, -1)][1:]
                    right = (big if k == tiles - 1 else
                             neighbour_edge(b, k + 1, pp, -1, t))
                    prev = torch.cat([own, right])
                    pi = torch.cat([pi_line[l0 + 1:l0 + n],
                                    pi_line[L - 1:] if k == tiles - 1 else
                                    pi_line[l0 + n:l0 + n + 1]])
                new = cuda_agg._min_plus(prev, c, p1, p2a(inten[b, x,
                                                               l0:l0 + n], pi))
            if shift == 0:
                carried[(b, k)] = new
            else:
                shared[(b, k, par, shift)] = new
                edge[(b, k, par, shift)] = (t, new[-1 if shift == 1 else 0])
            total += new
        progress[b][k] = t

    rng = random.Random(seed)
    while True:
        ready = [(b, k) for b in range(B) for k in range(tiles)
                 if progress[b][k] < X - 1
                 and (not diag or all(progress[b][j] >= progress[b][k]
                                      for j in (k - 1, k + 1)
                                      if 0 <= j < tiles))]
        if not ready:
            break
        b, k = rng.choice(ready)
        step(b, k, progress[b][k] + 1)
    assert all(p == X - 1 for row in progress for p in row)
    return out


SHIFT_SETS = [(0, 1, -1), (1,), (-1, 0)]


@pytest.mark.parametrize("shifts", SHIFT_SETS)
@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("D", [40, 128])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("X, L", [(6, 7), (9, 21)])
def test_tile_schedule_equals_plain(X, L, reverse, D, T, shifts):
    """B = 2; L = 7 is below T = 16 and L = 21 no multiple of 4 or 16."""
    cost, inten = _volume((2, X, L, D), seed=X * L + D + T)
    acc, _ = _volume((2, X, L, D), seed=X + L, hi=500)
    want = cuda_agg.plain_fused_pass_batch(cost, inten, acc, reverse, shifts,
                                           P1, P2)
    got = tile_schedule(cost, inten, acc, reverse, shifts, P1, P2, T,
                        seed=D + T)
    assert torch.equal(got, want)


@pytest.mark.parametrize("L", [1, 16, 33])
def test_tile_schedule_at_tile_edges(L):
    """One line (both diagonals restart at every step), exactly one tile,
    and one line past two tiles."""
    cost, inten = _volume((2, 8, L, 32), seed=L)
    acc = torch.zeros_like(cost)
    for reverse in (False, True):
        want = cuda_agg.plain_fused_pass_batch(cost, inten, acc, reverse,
                                               (0, 1, -1), P1, P2)
        got = tile_schedule(cost, inten, acc, reverse, (0, 1, -1), P1, P2,
                            16, seed=L)
        assert torch.equal(got, want)


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_tile_schedule_matches_pallas(reverse, loop):
    """Rows 1 and 4 of the TPU kernel table, in interpret mode."""
    cost, inten = _volume((8, 21, 16), seed=17)
    acc, _ = _volume((8, 21, 16), seed=18, hi=500)
    want = np.asarray(pallas_agg._fused_pass(
        jnp.asarray(cost.numpy()), jnp.asarray(inten.numpy()),
        jnp.asarray(acc.numpy()), reverse, (0, 1, -1), P1, P2,
        interpret=True, loop=loop))
    got = tile_schedule(cost[None], inten[None], acc[None], reverse,
                        (0, 1, -1), P1, P2, 4)[0]
    np.testing.assert_array_equal(got.to(torch.int16).numpy(), want)


@pytest.mark.parametrize("B, tiles, resident, chunks", [
    (2, 106, 264, [(0, 2)]),            # the main path's sweep: one launch
    (2, 106, 132, [(0, 1), (1, 1)]),    # one problem per launch
    (5, 3, 7, [(0, 2), (2, 2), (4, 1)]),
    (3, 1, 264, [(0, 3)]),
    (1, 264, 264, [(0, 1)]),
])
def test_plan_chunks_splits_problems(B, tiles, resident, chunks):
    assert cuda_agg.plan_chunks(B, tiles, resident) == chunks


@pytest.mark.parametrize("B", [1, 4])
def test_plan_chunks_rejects_a_problem_too_large(B):
    with pytest.raises(ValueError, match="265 resident blocks"):
        cuda_agg.plan_chunks(B, 265, 264)
