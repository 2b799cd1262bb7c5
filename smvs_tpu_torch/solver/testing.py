"""Seeded stencil systems for checking the PCG loop, and one system solved
on both of its paths: the CUDA graph that a card replays from the second
pass on, and the loop launched op by op (tests/test_torch_solver.py,
tests/test_torch_pcg_graph.py, `chip_smoke.py`)."""

from __future__ import annotations

import time

import numpy as np
import torch

from smvs_tpu_torch.solver import cg, mg, stencil
from smvs_tpu_torch.utils.perview import per_view
from smvs_tpu_torch.utils.timing import pcg_passes

# The card's checks of the graph against the loop launched op by op: the
# fine grids of the `dtu49` cells' multigrid hierarchies (37 x 49, 75 x 99
# and 151 x 199 nodes, one system as `cg.solve` takes it; 151 x 199 in a
# batch of 4 whose views exit at different passes, one not running), and
# `rect2mp`'s finest grid; the block-Jacobi preconditioner and the
# flexible beta at 75 x 99.
GRAPH_CASES = {
    "dtu49-s4": dict(grid=(37, 49)),
    "dtu49-s3": dict(grid=(75, 99)),
    "dtu49-s2": dict(grid=(151, 199)),
    "dtu49-s2-batch4": dict(grid=(151, 199), views=4,
                            tol_scale=[1.0, 1e-2, 1.0, 1e-4],
                            running=[True, True, False, True]),
    "rect2mp-s2": dict(grid=(359, 359)),
    "jacobi": dict(grid=(75, 99), precond="jacobi"),
    "flexible": dict(grid=(75, 99), flexible=True),
}


def stencil_system(ny1: int, nx1: int, views: int = 0, dtype=torch.float32,
                   device="cpu", seed: int = 0) -> tuple:
    """A seeded positive definite system on an ny1 x nx1 node grid: (Hb,
    b, active) with Hb [3, 3, 4, 4, (V,) ny1, nx1], b [4, (V,) ny1, nx1]
    and active [(V,) ny1, nx1], the view axis present when ``views`` >= 1.
    Each patch's 16 x 16 block is J^T J + 0.01 I for a J [8, 16] of
    normal entries, put on its four corners' nodes as the assembly puts
    it (`stencil.scatter_patch_systems`); about a tenth of the nodes is
    inactive."""
    gen = torch.Generator().manual_seed(seed)
    lead = (views,) if views else ()
    ny, nx = ny1 - 1, nx1 - 1
    J = torch.randn((8, 16, *lead, ny, nx), generator=gen,
                    dtype=torch.float64)
    H = torch.einsum("ka...,kb...->ab...", J, J)
    H = H + 0.01 * torch.eye(16, dtype=H.dtype).reshape(
        16, 16, *([1] * (H.ndim - 2)))
    g = torch.randn((16, *lead, ny, nx), generator=gen, dtype=torch.float64)
    active = torch.rand((*lead, ny1, nx1), generator=gen) > 0.1
    patch_valid = torch.ones((*lead, ny, nx), dtype=torch.bool)
    b, Hb = stencil.scatter_patch_systems(g, H, active, patch_valid)
    return (Hb.to(device=device, dtype=dtype),
            b.to(device=device, dtype=dtype), active.to(device))


def _precond(Hb: torch.Tensor, active: torch.Tensor, precond: str):
    if precond == "mg":
        levels = mg.build(Hb, active)
        return lambda x: mg.apply(levels, x)
    P = stencil.block_jacobi_inverse(Hb, active)
    return lambda x: stencil.apply_block_diag(P, x)


def solve(Hb: torch.Tensor, b: torch.Tensor, active: torch.Tensor,
          precond: str = "mg", flexible: bool = False,
          tol_scale=None, running=None, eager: bool = False
          ) -> cg.CGBatchResult:
    """``cg.solve_batch`` on the system as the optimizer sets it up:
    ``error_tolerance`` 0.01 of each view's ||b|| (times ``tol_scale``,
    one a view), ``q_tolerance`` 1e-3, at most 200 passes. A system
    without a view axis is solved as `cg.solve` solves it. ``eager``
    passes an identity ``reduce``: it changes no value, and keeps the
    loop op by op on a card."""
    A = lambda x: stencil.spmv(Hb, x)  # noqa: E731
    P = _precond(Hb, active, precond)
    if b.ndim == 3:  # one system, as `cg.solve` takes it
        A1, P1 = A, P
        A = lambda x: A1(x[:, 0])[:, None]  # noqa: E731
        P = lambda x: P1(x[:, 0])[:, None]  # noqa: E731
        b = b[:, None]
    gnorm = per_view(lambda x: torch.linalg.vector_norm(x.reshape(-1)), b,
                     dim=1)
    tol = gnorm * 0.01
    if tol_scale is not None:
        tol = tol * torch.as_tensor(tol_scale, dtype=b.dtype,
                                    device=b.device)
    return cg.solve_batch(A, b, precond=P, max_iterations=200,
                          error_tolerance=tol, q_tolerance=1e-3,
                          running=running, flexible=flexible,
                          reduce=(lambda v: v) if eager else None)


def _timed(fn, device: torch.device) -> tuple:
    """(fn's result, what it cost): its seconds to the end of its work on
    ``device``, its `pcg_passes`, and on a card the bytes the allocator
    reserved above what it held before, at most during ``fn`` and still
    after it, and the bytes still held after it in segments of a pool
    other than the allocator's own (a CUDA graph's pool is reserved, not
    allocated)."""
    pcg_passes.clear()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    cost = {"seconds": time.perf_counter() - t0,
            "pcg_passes": dict(pcg_passes)}
    if cuda:
        cost["reserved_peak_b"] = torch.cuda.max_memory_reserved(device) - held
        cost["reserved_left_b"] = torch.cuda.memory_reserved(device) - held
        cost["pool_left_b"] = sum(
            seg["total_size"] for seg in torch.cuda.memory._snapshot()[
                "segments"] if tuple(seg["segment_pool_id"]) != (0, 0))
    return out, cost


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs included."""
    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def compare_paths(Hb, b, active, reps: int = 2, **kw) -> dict:
    """The system solved ``reps`` times on its device's path and op by op
    (`solve`'s ``eager``), in turns: whether every solve gives the first
    one's x, residual and iterations bit for bit, each path's iterations,
    its median seconds, and its last solve's `pcg_passes` and reserved
    bytes (`_timed`)."""
    runs = {"path": [], "eager": []}
    for _ in range(reps):
        for name in runs:
            runs[name].append(_timed(lambda: solve(
                Hb, b, active, eager=name == "eager", **kw), b.device))
    first = runs["eager"][0][0]
    equal = all(_same(r.x, first.x) and _same(r.residual, first.residual)
                and np.array_equal(r.iterations, first.iterations)
                for side in runs.values() for r, _ in side)
    out = {"equal": equal, "iterations": first.iterations.tolist()}
    for name, side in runs.items():
        out[name] = dict(side[-1][1], seconds=float(np.median(
            [c["seconds"] for _, c in side])))
    return out


def check_case(name: str, device="cuda", seed: int = 7) -> dict:
    """`compare_paths` on ``GRAPH_CASES[name]``'s seeded system, with the
    counts a graph path must show: one pass op by op, one capture and the
    rest replayed (the loop op by op: every pass); every byte its graph's
    pool took given back by the solve's end; and
    for the batch the views' different exits. Raises on any
    difference."""
    kw = dict(GRAPH_CASES[name])
    grid, views = kw.pop("grid"), kw.pop("views", 0)
    Hb, b, active = stencil_system(*grid, views, device=device, seed=seed)
    out = compare_paths(Hb, b, active, **kw)
    passes = max(out["iterations"])
    want = {"eager": 1, "captures": 1, "replayed": passes - 1}
    problems = []
    if not out["equal"]:
        problems.append("the graph's solve differs from the loop's")
    if passes <= 2:
        problems.append(f"{passes} passes: too few to replay")
    if out["eager"]["pcg_passes"] != {"eager": passes}:
        problems.append("the eager loop did not run every pass op by op")
    if out["path"]["pcg_passes"] != want:
        problems.append(f"graph path counts, want {want}")
    if out["path"].get("pool_left_b", 0) != 0:
        problems.append("the graph's pool was not given back")
    its = out["iterations"]
    if views and (its[2] != 0 or len({its[0], its[1], its[3]}) < 2):
        problems.append("the batch's views do not exit apart")
    if problems:
        raise AssertionError(f"{name}: {'; '.join(problems)}: {out}")
    return out
