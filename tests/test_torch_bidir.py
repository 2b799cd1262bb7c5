"""The two-walk form of the vertical sweep kernel, modelled in plain
PyTorch on the CPU and held bit for bit against the plain sweep.

`sgm_sweep3_kernel`'s two-walk form (`smvs_tpu_torch/csrc/sgm_agg.cu`,
"sweep3_bidir" in a plan) serves Pallas row 3's vertical pair: one launch
carries the forward and the backward sweep. Block (b, tile) owns T lines
of problem b and walks them both ways, so at step t its forward warps are
at scan position t and its backward warps at X - 1 - t, and both add their
paths into one accumulator in place. Each warp reads its position's
accumulator through a ring of S scan positions that is filled S - 1 steps
ahead, at the start of step t - S + 1, before any store of that step lands.
A position p is visited at steps p and X - 1 - p, so where the two visits
are fewer than S steps apart the ring's copy of the second one would miss
the first one's add: there the second visit reads the accumulator itself
(after the barrier that ends the first visit's step), and the middle
position of an odd X, which both walks visit in one step, takes the
backward add after the forward store.

`bidir_schedule` below does what the blocks do, one block step at a time
in an order that a seeded random scheduler picks among the blocks whose
neighbours have finished the previous step (the edge words that carry the
diagonals across blocks, each walk its own slots), with the ring's copies
taken as early as the kernel may take them. It is bit-equal to the plain
sweep; the same model that takes every accumulator from the ring (no
crossing rule) is not, at every X; and the launch run through
`cuda_agg.run_plan` on the CPU is bit-equal to the TPU kernel
(`_fused_pass_bidir` in interpret mode).
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
S = 4  # the ring's stages at K <= 4 (Sweep3<K>::kStages)


def _volume(shape, seed, hi=63):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=shape).astype(np.int16)
    inten = rng.integers(0, 255, size=shape[:-1]).astype(np.int32)
    return torch.from_numpy(cost), torch.from_numpy(inten)


def bidir_schedule(cost, inten, acc, shifts: tuple, p1: int, p2: int,
                   T: int, seed: int = 0, crossing: bool = True
                   ) -> torch.Tensor:
    """acc plus the forward and the backward paths of ``shifts``, block by
    block as the two-walk form computes them. ``crossing``: the second
    visit of a position fewer than S steps after the first reads the
    accumulator itself, and the middle position's backward add follows
    the forward store; without it every visit takes the ring's copy."""
    B, X, L, D = cost.shape
    tiles = -(-L // T)
    out = acc.to(torch.int32, copy=True)
    inten = inten.to(torch.int32)
    orders = (list(range(X)), list(range(X - 1, -1, -1)))  # walk 0, 1
    diag = any(shifts)
    p2min = p1 * 3 // 2
    big = torch.full((1, D), BIG, dtype=torch.int32)

    progress = [[-1] * tiles for _ in range(B)]
    carried = {}  # (b, tile, walk) -> own straight line of the last step
    shared = {}   # (b, tile, walk, parity, shift) -> the diagonal lines
    edge = {}     # (b, tile, walk, parity, shift) -> (step, edge line)
    ring = {}     # (b, tile, walk, step) -> the accumulator's copy

    def from_out(s, walk):
        g = 2 * s + 1 - X
        return crossing and (0 < g < S or (g == 0 and walk == 1))

    def fill(b, k, s):
        if s >= X:
            return
        l0 = k * T
        for walk in (0, 1):
            if not from_out(s, walk):
                x = orders[walk][s]
                ring[(b, k, walk, s)] = out[b, x, l0:l0 + T].clone()

    def p2a(it, pi):
        return torch.clamp(p2 // (torch.abs(it - pi) + 1), min=p2min)

    def neighbour_edge(b, k, walk, par, shift, t):
        step, line = edge[(b, k, walk, par, shift)]
        assert step == t - 1, f"edge slot of step {step} read at step {t}"
        return line[None]

    def paths(b, k, walk, t):
        """The sum of the walk's new path lines at step t."""
        l0 = k * T
        n = min(T, L - l0)
        order = orders[walk]
        x = order[t]
        c = cost[b, x, l0:l0 + n].to(torch.int32)
        total = torch.zeros_like(c)
        par, pp = t & 1, (t - 1) & 1
        for shift in shifts:
            if t == 0:
                new = c
            else:
                pi_line = inten[b, order[t - 1]]
                if shift == 0:
                    prev = carried[(b, k, walk)]
                    pi = pi_line[l0:l0 + n]
                elif shift == 1:  # line l takes line l-1's value
                    own = shared[(b, k, walk, pp, 1)][:-1]
                    left = (big if k == 0 else
                            neighbour_edge(b, k - 1, walk, pp, 1, t))
                    prev = torch.cat([left, own])
                    pi = torch.cat([pi_line[:1] if k == 0 else
                                    pi_line[l0 - 1:l0],
                                    pi_line[l0:l0 + n - 1]])
                else:  # line l takes line l+1's value
                    own = shared[(b, k, walk, pp, -1)][1:]
                    right = (big if k == tiles - 1 else
                             neighbour_edge(b, k + 1, walk, pp, -1, t))
                    prev = torch.cat([own, right])
                    pi = torch.cat([pi_line[l0 + 1:l0 + n],
                                    pi_line[L - 1:] if k == tiles - 1 else
                                    pi_line[l0 + n:l0 + n + 1]])
                new = cuda_agg._min_plus(prev, c, p1,
                                         p2a(inten[b, x, l0:l0 + n], pi))
            if shift == 0:
                carried[(b, k, walk)] = new
            else:
                shared[(b, k, walk, par, shift)] = new
                edge[(b, k, walk, par, shift)] = (
                    t, new[-1 if shift == 1 else 0])
            total += new
        return total

    def step(b, k, t):
        if t == 0:
            for s in range(S - 1):
                fill(b, k, s)
        fill(b, k, t + S - 1)  # copies taken before this step's stores
        l0 = k * T
        late = None
        for walk in (0, 1):
            x = orders[walk][t]
            total = paths(b, k, walk, t)
            if crossing and walk == 1 and 2 * t + 1 == X:
                late = (x, total)  # after the forward walk's store
                continue
            base = (out[b, x, l0:l0 + T] if from_out(t, walk)
                    else ring.pop((b, k, walk, t)))
            out[b, x, l0:l0 + T] = base + total
        if late is not None:
            x, total = late
            out[b, x, l0:l0 + T] += total
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


def _plain(cost, inten, acc, shifts):
    out = cuda_agg.plain_fused_pass_batch(cost, inten, acc, False, shifts,
                                          P1, P2)
    return cuda_agg.plain_fused_pass_batch(cost, inten, out, True, shifts,
                                           P1, P2)


SHIFT_SETS = [(0, 1, -1), (1, -1), (-1, 0)]


@pytest.mark.parametrize("shifts", SHIFT_SETS)
@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("X", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13])
def test_bidir_schedule_equals_plain(X, T, shifts):
    """B = 2 problems of 11 lines: a ragged last tile at T = 3 and 8, fewer
    lines than a block nowhere, one line a block at T = 1; X below, at and
    past the ring's stages, odd and even."""
    cost, inten = _volume((2, X, 11, 16), seed=X * 31 + T)
    acc, _ = _volume((2, X, 11, 16), seed=X + T, hi=500)
    got = bidir_schedule(cost, inten, acc, shifts, P1, P2, T, seed=X + T)
    assert torch.equal(got, _plain(cost, inten, acc, shifts))


@pytest.mark.parametrize("L", [1, 5, 8, 17])
def test_bidir_schedule_at_tile_edges(L):
    """One line (both diagonals restart at every step), fewer lines than a
    block, exactly one block, and one line past two blocks, at an odd and
    an even X."""
    for X in (7, 10):
        cost, inten = _volume((1, X, L, 24), seed=L + X)
        acc, _ = _volume((1, X, L, 24), seed=L, hi=500)
        got = bidir_schedule(cost, inten, acc, (0, 1, -1), P1, P2, 8,
                             seed=L)
        assert torch.equal(got, _plain(cost, inten, acc, (0, 1, -1)))


@pytest.mark.parametrize("X", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13])
def test_bidir_schedule_without_the_crossing_rule_differs(X):
    """The mutation the model guards against: every visit takes the
    ring's copy of the accumulator, so a second visit fewer than S steps
    after the first, and the middle position's two adds in one step, lose
    an add. The sums then differ from plain at every X."""
    cost, inten = _volume((1, X, 11, 16), seed=X + 70)
    acc, _ = _volume((1, X, 11, 16), seed=X + 71, hi=500)
    want = _plain(cost, inten, acc, (0, 1, -1))
    got = bidir_schedule(cost, inten, acc, (0, 1, -1), P1, P2, 3, seed=X)
    assert torch.equal(got, want)
    bad = bidir_schedule(cost, inten, acc, (0, 1, -1), P1, P2, 3, seed=X,
                         crossing=False)
    assert not torch.equal(bad, want)


@pytest.mark.parametrize("X", [1, 2, 3, 8, 9])
def test_bidir_schedule_matches_pallas(X):
    """Row 3 of the TPU kernel table in interpret mode, through the model
    and through the launch run by `cuda_agg.run_plan` on the CPU."""
    cost, inten = _volume((X, 21, 16), seed=X + 17)
    acc, _ = _volume((X, 21, 16), seed=X + 18, hi=500)
    want = np.asarray(pallas_agg._fused_pass_bidir(
        jnp.asarray(cost.numpy()), jnp.asarray(inten.numpy()),
        jnp.asarray(acc.numpy()), (0, 1, -1), P1, P2, interpret=True))
    got = bidir_schedule(cost[None], inten[None], acc[None], (0, 1, -1), P1,
                         P2, 8, seed=X)[0]
    np.testing.assert_array_equal(got.to(torch.int16).numpy(), want)
    plan = [cuda_agg.Launch("sweep3_bidir", 1, False, "add", (0, 1, -1),
                            "fused_pass_bidir", 0, 1, 8)]
    got = cuda_agg.run_plan(plan, cost[None], inten[None], acc[None], P1, P2)
    np.testing.assert_array_equal(got[0].numpy(), want)
