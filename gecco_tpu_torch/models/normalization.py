"""Adaptive group norm (counterpart of ``gecco_tpu.models.normalization.AdaGN``).

The scale and bias are affine functions of a per-example embedding (the
noise level), initialised to identity: the scale Linear has weight 0 and
bias 1, the bias Linear weight 0 and bias 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gecco_tpu_torch.ops.norms import group_norm, group_norm_stats, stats_from_sums
from gecco_tpu_torch.utils.modules import Linear

__all__ = ["AdaGN"]


class AdaGN(nn.Module):
    """Set-level group norm with an embedding-conditioned affine."""

    def __init__(
        self,
        num_features: int,
        embed_dim: int,
        num_groups: int = 32,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.scale_linear = Linear(embed_dim, num_features, device=device, generator=generator)
        self.bias_linear = Linear(embed_dim, num_features, device=device, generator=generator)
        with torch.no_grad():
            self.scale_linear.weight.zero_()
            self.scale_linear.bias.fill_(1.0)
            self.bias_linear.weight.zero_()
            self.bias_linear.bias.zero_()
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        # x: [B, N, C], embed: [B, E]
        scale = self.scale_linear(embed)[..., None, :]
        bias = self.bias_linear(embed)[..., None, :]
        normed = group_norm(x, self.num_groups)
        return scale.to(x.dtype) * normed + bias.to(x.dtype)

    def _affine(self, mean_c, inv_c, embed):
        scale = self.scale_linear(embed.float())  # [B, C]
        bias = self.bias_linear(embed.float())
        se = scale * inv_c
        return se, bias - mean_c * se

    def effective_scale_bias(
        self, x: torch.Tensor, embed: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Norm and affine collapsed into ``x * se + be``, both fp32 [B, C]:
        ``se = scale * inv_c``, ``be = bias - mean_c * se`` — the form the
        fused kernels apply inline while streaming the set."""
        return self._affine(*group_norm_stats(x, self.num_groups), embed)

    def scale_bias_from_sums(
        self, sums: torch.Tensor, n_tokens: int, embed: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``effective_scale_bias`` from channel sums ``[B, 2, C]`` (s1, s2
        over the tokens) that a fused kernel emitted for its output."""
        stats = stats_from_sums(sums[:, 0], sums[:, 1], n_tokens, self.num_groups)
        return self._affine(*stats, embed)
