"""A view's node grid split over ranks by rows: the halo exchange of the
stencil product and the sums of the PCG's dot products.

In the JAX package XLA's SPMD partitioner inserts these: the shifted
slices of the 9-point stencil (`smvs_tpu/solver/stencil.py`) become 1-row
halo exchanges and the CG's dot products `psum`s
(`smvs_tpu/dist/viewbatch.py:10-14`). Here each rank holds a band of
rows (`mesh.row_band`) of a ``patch`` group's grid, and these functions
take that group.

`RowSplit` carries a grid's split (every rank's band) with these
operations, for the Newton step's layout (`viewbatch.RowBands`) and the
multigrid hierarchy (`solver.mg.build`'s ``split``), whose every level
is split as `mesh.coarse_band` derives it from the finer one.

gloo's point-to-point send and receive take host tensors only, so where
the band lies on a card and the group runs gloo (ranks that share one
card) the halo rows pass through host memory (`_exchange_rows`); its
collectives take CUDA tensors as they are.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from smvs_tpu_torch.dist.mesh import GATHER_ROWS, coarse_band, split
from smvs_tpu_torch.solver import stencil

# Collectives this process issued, by kind ("halo": one exchange with the
# band's neighbors; "all_reduce"; "all_gather"), for the counts per PCG
# iteration that `chip_smoke.py` reports.
collectives = Counter()


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
        out = row.contiguous()  # gloo sends contiguous tensors only
        if staged:
            out = out.cpu()
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
    collectives["halo"] += 1
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
    collectives["all_reduce"] += 1
    return out


def gather_rows(x: torch.Tensor, bands: list, group) -> torch.Tensor:
    """The whole grid [..., n, nx] on every rank of ``group``, from each
    rank's rows ``x`` [..., len(band), nx]; ``bands`` lists every rank's
    band in the group's rank order (a band may be empty)."""
    if x.dtype == torch.bool:  # gloo gathers bytes
        return gather_rows(x.to(torch.uint8), bands, group).to(torch.bool)
    width = max(len(b) for b in bands)
    pad = x.new_zeros((*x.shape[:-2], width, x.shape[-1]))
    pad[..., :x.shape[-2], :] = x
    parts = [torch.empty_like(pad) for _ in bands]
    dist.all_gather(parts, pad, group=group)
    collectives["all_gather"] += 1
    return torch.cat([p[..., :len(b), :] for p, b in zip(parts, bands)],
                     dim=-2)


class RowSplit:
    """A grid's rows split over the ranks of a ``patch`` group: every
    rank's band (``bands``, in the group's rank order, covering the grid's
    ``n`` rows), this rank's (``band``), and the band operations above on
    them."""

    def __init__(self, bands: list, group):
        self.bands = list(bands)
        self.group = group
        self.band = self.bands[dist.get_rank(group)]
        self.n = self.bands[-1].stop

    @classmethod
    def of(cls, n: int, group) -> RowSplit:
        """A grid of ``n`` rows split as `mesh.row_band` splits it."""
        parts = dist.get_world_size(group)
        if parts > n:
            raise ValueError(f"{n} node rows cannot be split over {parts} "
                             "ranks of the 'patch' axis: a band would be "
                             "empty")
        return cls([split(n, parts, i) for i in range(parts)], group)

    def coarse(self) -> RowSplit:
        """The next-coarser multigrid level's split."""
        return RowSplit([coarse_band(b) for b in self.bands], self.group)

    @property
    def banded(self) -> bool:
        """Whether a coarse level stays split: every rank holds at least
        `mesh.GATHER_ROWS` rows of it (one that does not is gathered whole
        onto every rank)."""
        return all(len(b) >= GATHER_ROWS for b in self.bands)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole grid [..., n, nx]."""
        return t[..., self.band.start:self.band.stop, :]

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        return exchange_halo(x, self.band, self.group)

    def spmv(self, Hb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return spmv(Hb, x, self.band, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_rows(x, self.bands, self.group)

    def sum(self, v: torch.Tensor) -> torch.Tensor:
        return sum_over(v, self.group)
