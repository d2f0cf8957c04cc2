"""Set-level group normalisation (counterpart of ``gecco_tpu/ops/norms.py``).

For a token set ``[..., N, C]`` the statistics of each group are taken over
the group's channels AND all N tokens (the reference's channels-first
GroupNorm), in fp32 whatever the activation dtype. Under point sharding a
point-side norm passes its points' group (``parallel.points_group()``):
its channel sums are summed over the group's ranks and its count is the
global N. The norms on the replicated inducer tokens pass none.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from gecco_tpu_torch.parallel.collectives import point_shard, sum_over_points

__all__ = ["group_norm", "group_norm_stats", "layer_norm", "stats_from_sums"]


def stats_from_sums(
    s1: torch.Tensor, s2: torch.Tensor, n_tokens: int, num_groups: int, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(mean_c, inv_c)`` [..., C] fp32 from the channel sums
    ``s1 = sum x`` and ``s2 = sum x^2`` over ``n_tokens`` tokens."""
    *lead, c = s1.shape
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    per_group = c // num_groups
    g1 = s1.reshape(*lead, num_groups, per_group).sum(-1)
    g2 = s2.reshape(*lead, num_groups, per_group).sum(-1)
    count = n_tokens * per_group
    mean = g1 / count
    var = g2 / count - mean**2
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return (
        mean.repeat_interleave(per_group, dim=-1),
        inv.repeat_interleave(per_group, dim=-1),
    )


def group_norm_stats(
    x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5,
    group: Optional[dist.ProcessGroup] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean_c, inv_c)``, each ``[..., C]`` fp32, so that the norm is the
    elementwise ``(x - mean_c) * inv_c``; ``group``: the points' group of
    ``x``'s shard of the set (None: x holds the whole set)."""
    xf = x.float()
    sums = sum_over_points(torch.stack([xf.sum(-2), (xf * xf).sum(-2)]), group)
    return stats_from_sums(
        sums[0], sums[1], x.shape[-2] * point_shard(group)[1], num_groups, eps
    )


def group_norm(x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Set-level group norm of ``x [..., N, C]`` without affine, in x's
    dtype (``group``: as in ``group_norm_stats``)."""
    mean_c, inv_c = group_norm_stats(x, num_groups, eps, group)
    return ((x.float() - mean_c[..., None, :]) * inv_c[..., None, :]).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-token layer norm of ``x [..., C]`` over the channels, no affine,
    statistics in fp32, the result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
