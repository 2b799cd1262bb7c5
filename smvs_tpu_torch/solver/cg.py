"""Matrix-free preconditioned conjugate gradient (port of
`smvs_tpu/solver/cg.py`, reference `lib/conjugate_gradient.h`).

A host loop replaces JAX's `lax.while_loop`, with the same exits: the
residual test ``||r||^2 < error_tolerance`` and the Nash truncated-Newton
quadratic-model test ``i * (Q1 - Q0) / Q1 < q_tolerance``
(reference :139-177). Each iteration reads one flag back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


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
) -> CGResult:
    """Solve A x = b from x0 = 0 (Fletcher-Reeves beta).

    The iterate after the exit test equals the JAX loop's; the
    preconditioner apply that JAX computes after its final test is
    skipped, since nothing reads it.
    """
    P = precond if precond is not None else (lambda v: v)
    x = torch.zeros_like(b)
    r = b
    d = P(r)
    rdr = _dot(d, r)
    q_prev = torch.zeros((), dtype=b.dtype, device=b.device)
    tol = torch.as_tensor(error_tolerance, dtype=b.dtype, device=b.device)
    i = 0
    while i < max_iterations:
        Ad = A(d)
        dAd = _dot(d, Ad)
        alpha = torch.where(dAd != 0, rdr / dAd, 0.0)
        x = x + alpha * d
        r = r - alpha * Ad
        new_rr = _dot(r, r)
        q1 = -_dot(x, b + r)
        zeta = (i + 1) * (q1 - q_prev) / torch.where(q1 != 0, q1, 1.0)
        i += 1
        if bool((new_rr < tol) | (zeta < q_tolerance)):
            break
        z = P(r)
        new_rdr = _dot(z, r)
        beta = torch.where(rdr != 0, new_rdr / rdr, 0.0)
        d = z + beta * d
        rdr = new_rdr
        q_prev = q1
    return CGResult(x=x, iterations=i, residual=_dot(r, r))
