"""Denoiser network around the set-transformer backbone (counterpart of
``gecco_tpu.models.wrappers.UnconditionalPointNetwork``).

Network contract: ``net(t [B], x [B, N, 3]) -> [B, N, 3]`` where ``t`` is
the preconditioned noise level (c_noise) and ``x`` the c_in-scaled points.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from gecco_tpu_torch.models.set_transformer import SetTransformer
from gecco_tpu_torch.ops.norms import group_norm, stats_from_sums
from gecco_tpu_torch.utils.modules import Linear

__all__ = ["UnconditionalPointNetwork"]


def _embed_channel_sums(linear: Linear, x: torch.Tensor) -> torch.Tensor:
    """Channel sums ``[B, 2, C]`` (s1, s2 over tokens) of ``linear(x)`` from
    the [B, D, D] second moments of ``x`` (D = 3), without a pass over the
    [B, N, C] embedded stream: with ``f = x W^T + b``,
    ``s1 = (sum x) W^T + n b`` and
    ``s2_c = w_c M w_c^T + 2 b_c (sum x . w_c) + n b_c^2``."""
    xf = x.float()
    n = xf.shape[-2]
    w = linear.weight.float()  # [C, D]
    proj = xf.sum(-2) @ w.T  # [B, C]
    m = torch.einsum("bni,bnj->bij", xf, xf)
    s2 = (torch.einsum("ci,bij->bcj", w, m) * w[None]).sum(-1)
    s1 = proj
    if linear.bias is not None:
        bias = linear.bias.float()
        s1 = proj + n * bias
        s2 = s2 + 2.0 * bias * proj + n * bias * bias
    return torch.stack([s1, s2], dim=1)


def _folded_head(proj: Linear, num_groups: int, x: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """GroupNorm -> Linear head with the norm folded into per-batch
    projection weights, statistics from the backbone's emitted channel sums:
    ``((x - m) * inv) @ W^T + b = x @ (inv * W^T) + b'``."""
    sums = sums.float()
    mean_c, inv_c = stats_from_sums(sums[:, 0], sums[:, 1], x.shape[1], num_groups)
    w = proj.weight.float()  # [D_out, C]
    wb = inv_c[:, :, None] * w.T[None]  # [B, C, D_out]
    bias = -torch.einsum("bc,dc->bd", mean_c * inv_c, w)
    if proj.bias is not None:
        bias = bias + proj.bias.float()
    y = torch.einsum("bnc,bcd->bnd", x.float(), wb.to(x.dtype).float())
    return y + bias[:, None, :]


class UnconditionalPointNetwork(nn.Module):
    """xyz embed -> backbone -> GroupNorm -> Linear head."""

    def __init__(self, backbone: SetTransformer, feature_dim: int, geometry_dim: int = 3,
                 output_norm_groups: int = 32, *, device=None, generator=None):
        super().__init__()
        self.xyz_embed = Linear(geometry_dim, feature_dim, device=device, generator=generator)
        self.backbone = backbone
        self.output_proj = Linear(feature_dim, geometry_dim, device=device, generator=generator)
        self.output_norm_groups = output_norm_groups

    def forward(self, t: torch.Tensor, x: torch.Tensor, ctx: Any = None) -> torch.Tensor:
        del ctx
        features = self.xyz_embed(x)  # [B, N, C]
        embed = t[..., None]  # [B, 1]: the noise level itself is the embed
        in_sums = _embed_channel_sums(self.xyz_embed, x)
        processed, sums = self.backbone(features, embed, in_sums=in_sums, with_sums=True)
        if sums is not None:
            return _folded_head(self.output_proj, self.output_norm_groups, processed, sums).to(x.dtype)
        normed = group_norm(processed, self.output_norm_groups)
        return self.output_proj(normed).to(x.dtype)
