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
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from smvs_tpu_torch.utils.perview import per_view
from smvs_tpu_torch.utils.timing import host_reads


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
    """
    P = precond if precond is not None else (lambda v: v)
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

    def keep(m, new, old):  # new where a view runs (m None: all), else old
        if m is None:
            return new
        return torch.where(m.reshape(shape_v) if new.ndim > 1 else m,
                           new, old)

    run_h = (np.ones(V, bool) if running is None
             else np.asarray(running, bool).copy())
    iters = np.zeros(V, np.int64)
    x = torch.zeros_like(b)
    r = b
    d = P(r)
    rdr = vdot(d, r)
    q_prev = torch.zeros((V,), dtype=b.dtype, device=dev)
    tol = torch.broadcast_to(torch.as_tensor(error_tolerance, dtype=b.dtype,
                                             device=dev), (V,))
    # The running mask on the device, None while every view runs.
    run = None if run_h.all() else torch.as_tensor(run_h, device=dev)
    i = 0
    while i < max_iterations and run_h.any():
        Ad = A(d)
        dAd = vdot(d, Ad)
        alpha = torch.where(dAd != 0, rdr / dAd, 0.0).reshape(shape_v)
        x = keep(run, x + alpha * d, x)
        r_prev = r
        r = keep(run, r - alpha * Ad, r)
        new_rr = vdot(r, r)
        q1 = -vdot(x, b + r)
        zeta = (i + 1) * (q1 - q_prev) / torch.where(q1 != 0, q1, 1.0)
        i += 1
        iters += run_h
        stop = (new_rr < tol) | (zeta < q_tolerance)
        run_h = run_h & ~stop.cpu().numpy()
        host_reads["cg"] += 1
        if i >= max_iterations or not run_h.any():
            break
        if not run_h.all():
            run = ~stop if run is None else run & ~stop
        z = P(r)
        new_rdr = vdot(z, r)
        num = vdot(z, r - r_prev) if flexible else new_rdr
        beta = torch.where(rdr != 0, num / rdr, 0.0).reshape(shape_v)
        d = keep(run, z + beta * d, d)
        rdr = keep(run, new_rdr, rdr)
        q_prev = keep(run, q1, q_prev)
    return CGBatchResult(x=x, iterations=iters, residual=vdot(r, r))
