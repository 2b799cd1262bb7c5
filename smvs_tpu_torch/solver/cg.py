"""Matrix-free preconditioned conjugate gradient (port of
`smvs_tpu/solver/cg.py`, reference `lib/conjugate_gradient.h`).

A host loop replaces JAX's `lax.while_loop`, with the same exits: the
residual test ``||r||^2 < error_tolerance`` and the Nash truncated-Newton
quadratic-model test ``i * (Q1 - Q0) / Q1 < q_tolerance``
(reference :139-177). Each iteration reads one flag back to the host.

`solve_batch` solves a batch of views' systems in one loop, the
counterpart of JAX's `vmap` of the solver: each view keeps its own
iterate, its own exits and its own iteration count, and each iteration
reads one flag per view back. Each view's dot products are the
sequential solver's (`torch.dot` of the view's contiguous vectors,
`utils.perview`), so each view's trajectory is the one it takes alone;
`solve` is a batch of one, which rounds as a single system does.

A pass of the loop is `_step` over the solve's state tensors, written in
place, and reads no host value. On a CUDA device without ``reduce``, the
first pass runs op by op, the second captures `_step` as one CUDA graph,
and every pass from the second on replays it: one launch and one read of
the exit flags a pass, where the ops of a V-cycle, a stencil product and
the dot products were each launched by the host. The graph and its
memory pool live for one solve: the pool's memory (one pass's
temporaries and a cuBLAS workspace) goes back to the device when the
solve ends. On the CPU, and with ``reduce`` (a system split over ranks,
whose collectives stay out of a graph), every pass runs `_step` op by
op. `utils.timing.pcg_passes` counts the passes each way and the
captures.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from smvs_tpu_torch.utils.perview import per_view
from smvs_tpu_torch.utils.timing import host_reads, pcg_passes, span


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # final ||r||^2


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def solve(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    max_iterations: int = 200,
    error_tolerance: torch.Tensor | float = 1e-20,
    q_tolerance: float = 1e-3,
    flexible: bool = False,
) -> CGResult:
    """Solve A x = b from x0 = 0 (Fletcher-Reeves beta, or with
    ``flexible`` Polak-Ribiere): `solve_batch` on a batch of one.

    The iterate after the exit test equals the JAX loop's; the
    preconditioner apply that JAX computes after its final test is
    skipped, since nothing reads it.
    """
    P = precond if precond is not None else (lambda v: v)
    res = solve_batch(lambda x: A(x[:, 0])[:, None], b[:, None],
                      lambda x: P(x[:, 0])[:, None], max_iterations,
                      torch.as_tensor(error_tolerance).reshape(1),
                      q_tolerance, flexible=flexible)
    return CGResult(x=res.x[:, 0], iterations=int(res.iterations[0]),
                    residual=res.residual[0])


class CGBatchResult(NamedTuple):
    x: torch.Tensor
    iterations: np.ndarray  # [V] int, per view
    residual: torch.Tensor  # [V] final ||r||^2


def solve_batch(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    max_iterations: int = 200,
    error_tolerance: torch.Tensor | float = 1e-20,
    q_tolerance: float = 1e-3,
    running: np.ndarray | None = None,
    view_dim: int = 1,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
    flexible: bool = False,
) -> CGBatchResult:
    """Solve a batch of views' systems A x = b from x0 = 0 (Fletcher-Reeves
    beta), the views on axis ``view_dim`` of ``b`` ([4, V, ny1, nx1] in
    the stencil layout).

    ``flexible`` takes the Polak-Ribiere beta
    ``<z, r - r_prev> / <z_prev, r_prev>`` (flexible PCG), which stays
    convergent when the preconditioner varies between applications; the
    optimizer does not use it (the JAX package measured it stalling the
    flagship's Newton trajectory).

    ``error_tolerance`` is a scalar or one per view [V]; ``running`` [V]
    (host bools, default all) says which views take part: the others keep
    x = 0 and 0 iterations. Each view leaves the loop at its own exit
    test, as `solve` does; x, r, d, the dot products and the previous
    quadratic value then stay where they were (``torch.where``, so that a
    stopped view's non-finite values cannot leak into the others). One
    [V] flag vector is read back per iteration.

    ``reduce`` is applied to every [V] vector of dot products before it
    is used: with a system split over ranks by rows (`dist.viewbatch`),
    a SUM all-reduce over the ranks that share the views, so that each
    of them holds every view's whole dot products, reads the same exit
    flags and leaves the loop in the same iteration.

    The solve is the span ``solver.pcg``; each pass of its loop the span
    ``solver.pcg.iteration``, from the search direction's update (after
    the first pass) or the pass's graph launch to the read of the exit
    flags; the capture of the graph before the second pass the span
    ``solver.pcg.capture``.
    """
    with span("solver.pcg"):
        return _solve_batch(A, b, P=precond if precond is not None
                            else (lambda v: v),
                            max_iterations=max_iterations,
                            error_tolerance=error_tolerance,
                            q_tolerance=q_tolerance, running=running,
                            view_dim=view_dim, reduce=reduce,
                            flexible=flexible)


class _State(NamedTuple):
    """A solve's state, the tensors each pass reads and writes in place:
    the iterate, the residual (and the last pass's, for ``flexible``),
    the search direction, <z, r>, the quadratic model's value and its
    value a pass before, the running mask, the pass counter (float32) and
    the exit flags, each [V] or with the views on ``view_dim`` of b."""

    x: torch.Tensor
    r: torch.Tensor
    r_prev: torch.Tensor | None
    d: torch.Tensor
    rdr: torch.Tensor
    q1: torch.Tensor
    q_prev: torch.Tensor
    run: torch.Tensor
    k: torch.Tensor
    stop: torch.Tensor


def _step(s: _State, A, P, b, tol, q_tolerance, vdot, shape_v, flexible,
          first: bool) -> None:
    """One pass of the loop over ``s``, in place: the search direction
    from the last pass's residual (not on the ``first`` pass), the step
    along it, the exit flags ``s.stop``, and the views that stop leave
    ``s.run``. A view out of ``s.run`` keeps its state (``torch.where``,
    so that its non-finite values cannot leak into the others); with
    every view running, the mask's `torch.where` gives the new values
    exactly. Reads no host value, so a CUDA graph can replay it."""

    def keep(new, old):  # new where a view runs, else old; into old
        m = s.run.reshape(shape_v) if new.ndim > 1 else s.run
        torch.where(m, new, old, out=old)

    if not first:
        z = P(s.r)
        new_rdr = vdot(z, s.r)
        num = vdot(z, s.r - s.r_prev) if flexible else new_rdr
        beta = torch.where(s.rdr != 0, num / s.rdr, 0.0).reshape(shape_v)
        keep(z + beta * s.d, s.d)
        keep(new_rdr, s.rdr)
        keep(s.q1, s.q_prev)
    Ad = A(s.d)
    dAd = vdot(s.d, Ad)
    alpha = torch.where(dAd != 0, s.rdr / dAd, 0.0).reshape(shape_v)
    keep(s.x + alpha * s.d, s.x)
    if flexible:
        s.r_prev.copy_(s.r)
    keep(s.r - alpha * Ad, s.r)
    new_rr = vdot(s.r, s.r)
    s.q1.copy_(-vdot(s.x, b + s.r))
    s.k.add_(1)
    zeta = s.k * (s.q1 - s.q_prev) / torch.where(s.q1 != 0, s.q1, 1.0)
    torch.logical_or(new_rr < tol, zeta < q_tolerance, out=s.stop)
    s.run.logical_and_(~s.stop)


def _solve_batch(A, b, P, max_iterations, error_tolerance, q_tolerance,
                 running, view_dim, reduce, flexible) -> CGBatchResult:
    """`solve_batch`'s loop, with the preconditioner ``P``."""
    V = b.shape[view_dim]
    dev = b.device
    shape_v = [1] * b.ndim
    shape_v[view_dim] = V

    def vdot(a, c):  # per view, as the view alone sums it
        if V == 1:
            out = _dot(a, c).reshape(1)
        elif a is c:  # one copy of each view's slice, not two
            out = per_view(lambda v: _dot(v, v), a, dim=view_dim)
        else:
            out = per_view(_dot, a, c, dim=view_dim)
        return out if reduce is None else reduce(out)

    run_h = (np.ones(V, bool) if running is None
             else np.asarray(running, bool).copy())
    iters = np.zeros(V, np.int64)
    r = b.clone()
    d = P(r).clone()  # P may hand r back
    s = _State(x=torch.zeros_like(b), r=r,
               r_prev=torch.empty_like(b) if flexible else None, d=d,
               rdr=vdot(d, r), q1=torch.zeros((V,), dtype=b.dtype, device=dev),
               q_prev=torch.zeros((V,), dtype=b.dtype, device=dev),
               run=(torch.ones((V,), dtype=torch.bool, device=dev)
                    if run_h.all() else torch.tensor(run_h, device=dev)),
               k=torch.zeros((), dtype=torch.float32, device=dev),
               stop=torch.zeros((V,), dtype=torch.bool, device=dev))
    tol = torch.broadcast_to(torch.as_tensor(error_tolerance, dtype=b.dtype,
                                             device=dev), (V,))
    step = functools.partial(_step, s, A, P, b, tol, q_tolerance, vdot,
                             shape_v, flexible)
    graphed = dev.type == "cuda" and reduce is None
    graph = pool = None
    i = 0
    try:
        while i < max_iterations and run_h.any():
            if graphed and i == 1:
                with span("solver.pcg.capture"):
                    graph, pool = _capture(
                        functools.partial(step, first=False), dev)
                pcg_passes["captures"] += 1
            with span("solver.pcg.iteration"):
                if graph is None:
                    step(first=i == 0)
                    pcg_passes["eager"] += 1
                else:
                    graph.replay()
                    pcg_passes["replayed"] += 1
                i += 1
                iters += run_h
                run_h = run_h & ~s.stop.cpu().numpy()
                host_reads["cg"] += 1
    finally:
        # The graph first, which hands the pool back; then the pool, whose
        # memory goes back to the device. The last flags were read.
        graph = None
        pool = None
    return CGBatchResult(x=s.x, iterations=iters, residual=vdot(s.r, s.r))


def _capture(fn, device: torch.device) -> tuple:
    """``fn``'s launches captured as one CUDA graph on a side stream of
    ``device`` (a graph is not captured on the default stream), into a
    memory pool of its own: (graph, pool). The graph replays on the
    current stream. Drop the graph before the pool: the pool's memory goes
    back to the device when both are gone.

    The capture's cuBLAS calls (dot products, the transfers' small
    products) take a workspace for the side stream, 32 MiB by default,
    from the pool. Clearing cuBLAS's workspaces after the capture leaves
    that block to the graph alone, so that the pool holds no allocation
    when the solve drops it. (The current stream's workspace is dropped
    too, and comes back from the allocator's cache at its next cuBLAS
    call.)"""
    with torch.cuda.device(device):
        pool = torch.cuda.MemPool()
        stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool.id,
                                    capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    graph.capture_end()
        except BaseException:
            graph = None  # before its pool
            raise
        finally:
            torch._C._cuda_clearCublasWorkspaces()
        current.wait_stream(stream)
    return graph, pool
