"""Collectives over the point axis for point sharding (the mesh's ``seq``
axis), which autograd differentiates exactly.

Under a ``(data, seq)`` mesh the ``seq`` ranks of one data row each hold a
slice of every cloud's points. The JAX package gets its collectives from
XLA's partitioner and the Pallas wrappers' partitioning rules; here the
sites that reduce over the point axis issue them themselves:

- ``gather_points``: an all-gather along the point axis (the pools take
  every point of the cloud); its adjoint is a reduce-scatter (sum) that
  hands each rank the cotangent of its own points;
- ``sum_over_points``: an all-reduce sum of partial sums over the points
  (the GroupNorms' channel sums); its adjoint is an all-reduce sum.

With exact adjoints every rank seeds its backward with its own loss, and
the sum over the ranks of each rank's gradient is the gradient of the sum
of their losses: the train step's mean over the world gives one process's
gradient.

The sites read the active group (``points_group()``, a context variable of
the calling thread), which the train step sets with
``sharding_points(group)`` around its forward and backward; a remat
recompute, which the autograd engine may run on another thread, enters the
forward's group again. Outside it, or on a group of one, every collective
here is the identity, so that validation, sampling and a world of one issue
none.

gloo takes these forms on CUDA tensors too (``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_reduce``, in fp32 and bf16): two ranks
on one card share it through gloo.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "gather_points",
    "point_shard",
    "points_group",
    "sharding_points",
    "sum_over_points",
]

_ACTIVE: ContextVar[Optional[dist.ProcessGroup]] = ContextVar("points_group", default=None)


def _live(group) -> bool:
    return group is not None and group.size() > 1


@contextmanager
def sharding_points(group: Optional[dist.ProcessGroup]):
    """Make ``group`` (a ``Mesh``'s ``seq_group``, or None) the points'
    group of the model's reducing sites while the block runs."""
    token = _ACTIVE.set(group if _live(group) else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def points_group() -> Optional[dist.ProcessGroup]:
    """The active points' group of more than one rank, or None."""
    return _ACTIVE.get()


def point_shard(group: Optional[dist.ProcessGroup]) -> tuple[int, int]:
    """``(index, count)``: this rank's slice of the point axis in
    ``group``; ``(0, 1)`` on no group."""
    if not _live(group):
        return 0, 1
    return dist.get_rank(group), group.size()


def _to_front(x: torch.Tensor, count: int) -> torch.Tensor:
    """``[..., count * n, C]`` -> ``[count, ..., n, C]``, contiguous."""
    *lead, n, c = x.shape
    return x.reshape(*lead, count, n // count, c).movedim(-3, 0).contiguous()


def _from_front(x: torch.Tensor) -> torch.Tensor:
    """``[count, ..., n, C]`` -> ``[..., count * n, C]``."""
    count, *lead, n, c = x.shape
    return x.movedim(0, -3).reshape(*lead, count * n, c)


class _GatherPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        count = group.size()
        out = x.new_empty((count, *x.shape))
        dist.all_gather_into_tensor(out.view(count * x.shape[0], *x.shape[1:]), x.contiguous(),
                                    group=group)
        return _from_front(out)

    @staticmethod
    def backward(ctx, g):
        count = ctx.group.size()
        stacked = _to_front(g, count)
        out = g.new_empty(stacked.shape[1:])
        dist.reduce_scatter_tensor(out, stacked.view(-1, *stacked.shape[2:]), group=ctx.group)
        return out, None


class _SumOverPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def gather_points(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x [..., n, C]``, this rank's n points, -> ``[..., count * n, C]``:
    every rank's points in the group's rank order (the identity on no
    group or a group of one)."""
    return _GatherPoints.apply(x, group) if _live(group) else x


def sum_over_points(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum over the group's ranks of each rank's partial ``t`` (the
    identity on no group or a group of one)."""
    return _SumOverPoints.apply(t, group) if _live(group) else t
