"""Set-level group normalisation (counterpart of ``gecco_tpu/ops/norms.py``).

For a token set ``[..., N, C]`` the statistics of each group are taken over
the group's channels AND all N tokens (the reference's channels-first
GroupNorm), in fp32 whatever the activation dtype.
"""

from __future__ import annotations

import torch

__all__ = ["group_norm", "group_norm_stats", "stats_from_sums"]


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
    x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean_c, inv_c)``, each ``[..., C]`` fp32, so that the norm is the
    elementwise ``(x - mean_c) * inv_c``."""
    xf = x.float()
    return stats_from_sums(
        xf.sum(-2), (xf * xf).sum(-2), x.shape[-2], num_groups, eps
    )


def group_norm(x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Set-level group norm of ``x [..., N, C]`` without affine, in x's dtype."""
    mean_c, inv_c = group_norm_stats(x, num_groups, eps)
    return ((x.float() - mean_c[..., None, :]) * inv_c[..., None, :]).to(x.dtype)
