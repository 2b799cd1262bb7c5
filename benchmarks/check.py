"""The comparison that decides ``correct``.

Numbers, each held to a limit of its configuration (``limits`` in its
file; a configuration compares the numbers it gives a limit; `PERF.md`
gives the readings each limit was set from):

- ``sgm_mismatch``: the worst share, over the sampled views, of pixels
  where the program's SGM depth map and the plain reference's
  (`reference.sgm_plain`, computed again from the same inputs) disagree:
  one has depth where the other has none, or the two differ by more than
  ``sgm_rtol`` of the reference. It carries the census, the cost volume,
  the aggregation kernels, WTA and the consistency cut.
- ``opt_gap``: the worst, over the sampled views, of the ``gap_quantile``
  quantile of the relative gap between the program's final depth map and
  the plain reference optimizer's (`reference.opt`, run on the same group
  from the reference's SGM maps), over the pixels where either has depth;
  a pixel with depth in one map only counts as a gap of 1. It carries the
  optimizer and the solver: the Gauss-Newton assembly, the PCG and its
  multigrid, the surface and its subdivision, the batching of views.
- ``depth_err``: the worst, over every view the window completed, of the
  ``err_quantile`` quantile of the final depth map's relative error
  against the scene's true depth (float64), over every pixel that has a
  true depth, a pixel without depth counting as an error of 1. So it
  fails a depth map that is inaccurate, and one that covers less than
  ``err_quantile`` of the view.

Every number is lower-is-better; a run is correct when each number its
configuration compares is at or below its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NAMES = ("sgm_mismatch", "opt_gap", "depth_err")


def sgm_mismatch(program, reference, rtol: float) -> float:
    """Share of pixels where the two SGM depth maps disagree."""
    a = torch.as_tensor(program).to(torch.float64).cpu()
    b = torch.as_tensor(reference).to(torch.float64).cpu()
    if a.shape != b.shape:
        return 1.0
    bad = ((a > 0) != (b > 0)) | ((a - b).abs() > rtol * b.abs())
    return float(bad.to(torch.float64).mean())


def depth_err(depth, truth, quantile: float) -> float:
    """The ``quantile`` quantile (the lower order statistic) of the relative
    error over pixels with a true depth; no depth counts as an error of 1."""
    d = torch.as_tensor(depth).to(torch.float64).cpu().reshape(-1)
    t = torch.as_tensor(truth).to(torch.float64).cpu().reshape(-1)
    if d.shape != t.shape:
        return 1.0
    has = t > 0
    d, t = d[has], t[has]
    if t.numel() == 0:
        return 1.0
    rel = torch.where(d > 0, (d - t).abs() / t, torch.ones_like(t))
    rel, _ = torch.sort(rel)
    k = int(math.floor(quantile * (rel.numel() - 1)))
    return float(rel[k])


def rel_gaps(program, reference) -> torch.Tensor:
    """The sorted relative gaps of two final depth maps over the pixels
    where either has depth: |a - b| / b where both have it, 1 where one
    has. Different shapes, or no depth in either, give a single gap of 1."""
    a = torch.as_tensor(program).to(torch.float64).cpu().reshape(-1)
    b = torch.as_tensor(reference).to(torch.float64).cpu().reshape(-1)
    if a.shape != b.shape:
        return torch.ones(1, dtype=torch.float64)
    both, either = (a > 0) & (b > 0), (a > 0) | (b > 0)
    if not bool(either.any()):
        return torch.ones(1, dtype=torch.float64)
    rel = torch.where(both, (a - b).abs() / torch.where(both, b, 1.0),
                      torch.ones_like(a))[either]
    return torch.sort(rel).values


def gap(gaps, quantile: float) -> float | None:
    """The ``quantile`` quantile (the lower order statistic) of sorted
    gaps (`rel_gaps`); None for no gaps (nothing was compared)."""
    if gaps is None:
        return None
    k = int(math.floor(quantile * (gaps.numel() - 1)))
    return float(gaps[k])


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest), what
    a TF32 matrix product takes its operands as."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for the numbers that
    ``limits`` names. A number that could not be read (None) fails."""
    unknown = set(limits) - set(NAMES)
    if unknown or not limits:
        raise ValueError(f"limits name no number compared: {sorted(unknown)}")
    checks, ok = {}, True
    for name in NAMES:
        if name not in limits:
            continue
        value = numbers.get(name)
        limit = float(limits[name])
        good = value is not None and np.isfinite(value) and value <= limit
        ok &= bool(good)
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
