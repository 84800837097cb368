"""The collectives of the port's ranks, every one an all-reduce.

Gloo takes CUDA tensors for ``broadcast`` and ``all_reduce`` only (it has
no CUDA ``all_gather``), and NCCL takes both.  So the port writes each
collective through ``all_reduce`` alone, which either backend runs on the
tensors where they lie, CPU or card: an all-gather is the all-reduce of a
zero buffer into which each rank writes its own slice (sums of one value
and zeros are exact in any dtype).

The autograd forms:

* :func:`all_reduce_sum`: the sum over a group, whose backward sums the
  gradients over the group (each rank's input feeds every rank's output);
  batch norm's statistics use it;
* :func:`psum_local`: the sum over a group, whose backward passes the
  gradient to the rank's own term only; a loss that each rank
  differentiates for its own share of the batch uses it, and the gradients
  are then summed over the group once, after the backward;
* :class:`ColumnParallel`: the entry to and the exit from a Linear whose
  output channels are split over a group (``enter``: identity, backward
  sums the input's gradient over the group; ``gather``: all-gather of the
  channels, backward keeps the rank's own slice).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_WIDE = (torch.bfloat16, torch.float16)


def _reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (in f32 for 16-bit floats, which
    not every backend sums); a ``None`` group is a group of one."""
    if group is None:
        return x
    if x.dtype in _WIDE:
        y = x.float()
        dist.all_reduce(y, group=group)
        x.copy_(y)
    else:
        dist.all_reduce(x, group=group)
    return x


def gather_cat(x: torch.Tensor, group, index: int, size: int,
               dim: int = -1) -> torch.Tensor:
    """Concatenate the ``size`` ranks' equal ``x`` along ``dim``, rank
    ``index`` of the group in block ``index``, through one all-reduce."""
    dim = dim % x.dim()
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * size
    buf = x.new_zeros(shape)
    buf.narrow(dim, index * n, n).copy_(x)
    return _reduce_(buf, group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.clone(), ctx.group), None


class _PSumLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward sums the gradients over it too."""
    return _AllReduce.apply(x, group)


def psum_local(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward keeps the rank's own gradient."""
    return _PSumLocal.apply(x, group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, index, size):
        ctx.index, ctx.n = index, y.shape[-1]
        return gather_cat(y, group, index, size, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(-1, ctx.index * ctx.n, ctx.n).contiguous(), None,
                None, None)


class ColumnParallel:
    """A Linear split on its output axis over ``group``: this rank holds
    rows ``[index * n, (index + 1) * n)`` of the weight and the bias.
    Every rank of the group computes the same layer input and the same
    downstream, so the gathered output's gradient is the same on each and
    the rank keeps its slice; the input's gradient is the sum of the
    ranks' parts."""

    def __init__(self, group, index: int, size: int):
        self.group: Optional[object] = group
        self.index, self.size = index, size

    def __deepcopy__(self, memo):   # a process group is not copied
        return self

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(y, self.group, self.index, self.size)


class BatchStats:
    """``Norm.reduce`` over the ranks that split a batch: the per-channel
    sums of x and x^2 and the count, summed with gradients (each rank's
    samples move every rank's statistics)."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def __deepcopy__(self, memo):   # a process group is not copied
        return self

    def __call__(self, s: torch.Tensor, ss: torch.Tensor, n: int):
        both = all_reduce_sum(torch.cat([s, ss]), self.group)
        return both[:1], both[1:], n * self.size
