"""Per-view reductions for a batch of views.

A reduction over a batch (one sum or one matrix product for every view)
may add in another order than the same reduction over one view alone,
and in float32 it then rounds differently. The batched solver paths
instead apply the sequential operation to each view's slice, laid out
as the view's own tensor is when it runs alone, so that each view's
value is the one its sequential run computes. A slice that is a dense
block of the batch (the view axis outermost in memory, as after a stack
on a leading axis) keeps its strides; any other slice is copied into a
contiguous tensor, the layout of a freshly computed per-view tensor.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

_ALIGN = 256  # bytes; a fresh device or host buffer is at least this


def _dense(x: torch.Tensor) -> bool:
    """Whether x's elements fill one block of memory (strides a
    permutation of a contiguous layout)."""
    expect = 1
    for stride, size in sorted((st, sz) for st, sz in
                               zip(x.stride(), x.shape) if sz != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def view_slice(t: torch.Tensor, dim: int, i: int) -> torch.Tensor:
    """View ``i`` of ``t`` along ``dim``, laid out as the view's own
    tensor, at an aligned address: a dense slice keeps its strides (the
    slice itself when it is aligned), any other is made contiguous."""
    x = t.select(dim, i)
    if not _dense(x):
        return x.contiguous()
    if x.data_ptr() % _ALIGN:
        return x.clone()  # keeps the strides of a dense tensor
    return x


def per_view(fn: Callable[..., torch.Tensor], *ts: torch.Tensor,
             dim: int | Sequence[int] = 0) -> torch.Tensor:
    """``fn`` on each view's slices of ``ts`` (views on axis ``dim``, or
    one axis per tensor), the results stacked on a leading view axis."""
    dims = [dim] * len(ts) if isinstance(dim, int) else list(dim)
    outs = [fn(*(view_slice(t, d, i) for t, d in zip(ts, dims)))
            for i in range(ts[0].shape[dims[0]])]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def split_rows(a: torch.Tensor, counts: Sequence[int]) -> list:
    """The consecutive row blocks of a contiguous ``a`` of sizes
    ``counts``, each at an aligned address."""
    out, lo = [], 0
    for n in counts:
        x = a[lo:lo + n]
        out.append(x.clone() if x.data_ptr() % _ALIGN else x)
        lo += n
    return out


def rows_matmul(a: torch.Tensor, b: torch.Tensor,
                counts: Sequence[int] | None) -> torch.Tensor:
    """``a @ b``; with ``counts`` (a's rows in per-view blocks) one
    product per block, each as the view's own rows alone give it."""
    if counts is None:
        return a @ b
    return torch.cat([x @ b for x in split_rows(a, counts)])
