"""A view's node grid split over ranks by rows: the halo exchange of the
stencil product and the sums of the PCG's dot products.

In the JAX package XLA's SPMD partitioner inserts these: the shifted
slices of the 9-point stencil (`smvs_tpu/solver/stencil.py`) become 1-row
halo exchanges and the CG's dot products `psum`s
(`smvs_tpu/dist/viewbatch.py:10-14`). Here each rank holds a band of
rows (`mesh.row_band`) of a ``patch`` group's grid, and these functions
take that group.

gloo's point-to-point send and receive take host tensors only, so where
the band lies on a card and the group runs gloo (ranks that share one
card) the halo rows pass through host memory (`_exchange_rows`); its
collectives take CUDA tensors as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from smvs_tpu_torch.solver import stencil


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` passes through host memory on the way to a peer:
    gloo's send and receive take host tensors only."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _exchange_rows(sends: list, group) -> list:
    """Send each (row, peer) to its peer and receive a row of the same
    shape from it; returns the received rows in the order of ``sends``
    (peers are ranks of the default group)."""
    if not sends:
        return []
    staged = _staged(sends[0][0], group)
    ops, recvs = [], []
    for row, peer in sends:
        out = row.cpu() if staged else row.contiguous()
        buf = torch.empty_like(out)
        ops.append(dist.P2POp(dist.isend, out, peer, group))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        recvs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = sends[0][0].device
    return [r.to(dev) for r in recvs] if staged else recvs


def exchange_halo(x: torch.Tensor, band: range, group) -> torch.Tensor:
    """``x`` [..., r1 - r0, nx1], this rank's band of the grid's rows, with
    the last row of the band above and the first row of the band below
    around it: [..., r1 - r0 + 2, nx1]. At the grid's top and bottom the
    added row is zero, as `stencil._pad_yx` pads the whole grid."""
    if x.shape[-2] != len(band):
        raise ValueError(f"a band of {len(band)} rows, x has {x.shape[-2]}")
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    sends, where = [], []
    if idx > 0:
        sends.append((x[..., :1, :], dist.get_global_rank(group, idx - 1)))
        where.append("above")
    if idx < n - 1:
        sends.append((x[..., -1:, :], dist.get_global_rank(group, idx + 1)))
        where.append("below")
    got = dict(zip(where, _exchange_rows(sends, group)))
    zero = torch.zeros_like(x[..., :1, :])
    return torch.cat([got.get("above", zero), x, got.get("below", zero)],
                     dim=-2)


def spmv(Hb_band: torch.Tensor, x_band: torch.Tensor, band: range, group
         ) -> torch.Tensor:
    """`stencil.spmv` on the grid split by rows: the band's rows of H @ x
    from the band's stencil rows [3, 3, 4, 4, (V,) r1 - r0, nx1] and x's
    band [4, (V,) r1 - r0, nx1]."""
    xh = exchange_halo(x_band, band, group)
    return stencil.spmv_padded(Hb_band, stencil._pad_yx(xh, 0, 0, 1, 1))


def sum_over(v: torch.Tensor, group) -> torch.Tensor:
    """SUM all-reduce of ``v`` (a [V] vector of per-view partial sums)
    over ``group``; every rank gets the same bits."""
    out = v.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
