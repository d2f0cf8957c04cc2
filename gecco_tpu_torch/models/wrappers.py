"""Denoiser networks around the set-transformer backbone (counterpart of
``gecco_tpu.models.wrappers``: ``UnconditionalPointNetwork`` (alias
``LinearLift``), ``GlobalConditioningNetwork`` and ``RayNetwork``).

Network contract: ``net(t [B], x [B, N, 3], ctx, hs=None, return_h=False,
dropout=None) -> [B, N, 3]`` where ``t`` is the preconditioned noise level
(c_noise) and ``x`` the c_in-scaled points; ``return_h=True`` also returns
the backbone's inducer tokens [L, B, I, C], and ``hs`` reuses them (cached
upsampling); ``dropout`` is the backbone MLPs' mask source (the JAX
package's network key).

Under point sharding (``parallel.sharding_points``) ``x`` holds the rank's
slice of each cloud's points: the embedding's channel sums and the output
GroupNorm's statistics are taken over the whole set (summed over the
points' group, normalised by the global N), the projective lookup takes
the rank's own points in the replicated images.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from gecco_tpu_torch.models.set_transformer import SetTransformer
from gecco_tpu_torch.ops.norms import group_norm, stats_from_sums
from gecco_tpu_torch.ops.projective import LOOKUP_IMPLS, lookup_pyramid
from gecco_tpu_torch.parallel.collectives import point_shard, points_group, sum_over_points
from gecco_tpu_torch.utils.modules import Linear

__all__ = ["GlobalConditioningNetwork", "LinearLift", "RayNetwork", "UnconditionalPointNetwork"]


def _embed_channel_sums(linear: Linear, x: torch.Tensor, group=None) -> torch.Tensor:
    """Channel sums ``[B, 2, C]`` (s1, s2 over tokens) of ``linear(x)`` from
    the [B, D, D] second moments of ``x`` (D = 3), without a pass over the
    [B, N, C] embedded stream: with ``f = x W^T + b``,
    ``s1 = (sum x) W^T + n b`` and
    ``s2_c = w_c M w_c^T + 2 b_c (sum x . w_c) + n b_c^2``. ``group``: the
    points' group (the sum and the moments summed over it, n the global
    N)."""
    xf = x.float()
    n = xf.shape[-2] * point_shard(group)[1]
    w = linear.weight.float()  # [C, D]
    moments = sum_over_points(
        torch.cat([xf.sum(-2)[:, None], torch.einsum("bni,bnj->bij", xf, xf)], dim=1), group)
    proj = moments[:, 0] @ w.T  # [B, C]
    m = moments[:, 1:]
    s2 = (torch.einsum("ci,bij->bcj", w, m) * w[None]).sum(-1)
    s1 = proj
    if linear.bias is not None:
        bias = linear.bias.float()
        s1 = proj + n * bias
        s2 = s2 + 2.0 * bias * proj + n * bias * bias
    return torch.stack([s1, s2], dim=1)


def _folded_head(proj: Linear, num_groups: int, x: torch.Tensor, sums: torch.Tensor,
                 n_tokens: Optional[int] = None) -> torch.Tensor:
    """GroupNorm -> Linear head with the norm folded into per-batch
    projection weights, statistics from the backbone's emitted channel sums
    over ``n_tokens`` tokens (x's N where None): ``((x - m) * inv) @ W^T +
    b = x @ (inv * W^T) + b'``."""
    sums = sums.float()
    n = x.shape[1] if n_tokens is None else n_tokens
    mean_c, inv_c = stats_from_sums(sums[:, 0], sums[:, 1], n, num_groups)
    w = proj.weight.float()  # [D_out, C]
    wb = inv_c[:, :, None] * w.T[None]  # [B, C, D_out]
    bias = -torch.einsum("bc,dc->bd", mean_c * inv_c, w)
    if proj.bias is not None:
        bias = bias + proj.bias.float()
    y = torch.einsum("bnc,bcd->bnd", x.float(), wb.to(x.dtype).float())
    return y + bias[:, None, :]


def _head(proj: Linear, num_groups: int, processed: torch.Tensor, sums, dtype,
          group=None) -> torch.Tensor:
    """GroupNorm -> Linear: folded, from the backbone's channel sums, on the
    fused path; as written on the plain path (``sums`` None). ``group``:
    the points' group of ``processed``."""
    if sums is not None:
        n = processed.shape[1] * point_shard(group)[1]
        return _folded_head(proj, num_groups, processed, sums, n).to(dtype)
    return proj(group_norm(processed, num_groups, group=group)).to(dtype)


class UnconditionalPointNetwork(nn.Module):
    """xyz embed -> backbone -> GroupNorm -> Linear head."""

    def __init__(self, backbone: SetTransformer, feature_dim: int, geometry_dim: int = 3,
                 output_norm_groups: int = 32, *, device=None, generator=None):
        super().__init__()
        self.xyz_embed = Linear(geometry_dim, feature_dim, device=device, generator=generator)
        self.backbone = backbone
        self.output_proj = Linear(feature_dim, geometry_dim, device=device, generator=generator)
        self.output_norm_groups = output_norm_groups

    def forward(self, t: torch.Tensor, x: torch.Tensor, ctx: Any = None,
                hs: Optional[torch.Tensor] = None, return_h: bool = False, dropout=None):
        del ctx
        features = self.xyz_embed(x)  # [B, N, C]
        embed = t[..., None]  # [B, 1]: the noise level itself is the embed
        group = points_group()
        in_sums = _embed_channel_sums(self.xyz_embed, x, group)
        processed, *stored, sums = self.backbone(features, embed, hs=hs, return_h=return_h,
                                                 in_sums=in_sums, with_sums=True, dropout=dropout)
        y = _head(self.output_proj, self.output_norm_groups, processed, sums, x.dtype, group)
        return (y, *stored) if return_h else y


# the reference's name for the same computation
LinearLift = UnconditionalPointNetwork


class GlobalConditioningNetwork(nn.Module):
    """Image-conditional denoiser on one global feature: the mean over the
    pixels of the conditioner's single map (``ConvNeXtExtractor(...,
    mode="global")``) is concatenated to t as the backbone's embed (1 + C
    channels); xyz embed -> backbone with its channel sums -> GroupNorm ->
    Linear head, as ``UnconditionalPointNetwork``."""

    def __init__(self, backbone: SetTransformer, feature_dim: int, geometry_dim: int = 3,
                 output_norm_groups: int = 32, *, device=None, generator=None):
        super().__init__()
        self.xyz_embed = Linear(geometry_dim, feature_dim, device=device, generator=generator)
        self.backbone = backbone
        self.output_proj = Linear(feature_dim, geometry_dim, device=device, generator=generator)
        self.output_norm_groups = output_norm_groups

    def forward(self, t: torch.Tensor, x: torch.Tensor, ctx: Any,
                hs: Optional[torch.Tensor] = None, return_h: bool = False, dropout=None):
        (global_features,) = ctx.features  # [B, h, w, C]
        img_embed = global_features.mean(dim=(-3, -2))  # [B, C]
        embed = torch.cat([t[..., None], img_embed.to(t.dtype)], dim=-1)
        features = self.xyz_embed(x)
        group = points_group()
        in_sums = _embed_channel_sums(self.xyz_embed, x, group)
        processed, *stored, sums = self.backbone(features, embed, hs=hs, return_h=return_h,
                                                 in_sums=in_sums, with_sums=True, dropout=dropout)
        y = _head(self.output_proj, self.output_norm_groups, processed, sums, x.dtype, group)
        return (y, *stored) if return_h else y


class RayNetwork(nn.Module):
    """Projective-conditioning denoiser: each point is reprojected into the
    image through the reparam (``diffusion_to_hw``), its features are looked
    up bilinearly in every level of the conditioner's pyramid, reduced to
    ``feature_dim`` by ``ctx_dim_reductor`` and added to the xyz embedding.

    ``reparam`` is the model's own (the JAX pytree holds it twice, as
    ``reparam`` and ``network.reparam``); it is kept out of this module's
    tree, so the model's state dict holds it once. ``lookup_impl``:
    ``"pallas"`` the gather kernels, ``"xla"`` the plain version."""

    def __init__(self, backbone: SetTransformer, reparam: nn.Module, feature_dim: int,
                 input_ctx_dim: int, geometry_dim: int = 3, output_norm_groups: int = 32,
                 lookup_impl: str = "xla", *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.xyz_embed = Linear(geometry_dim, feature_dim, **kw)
        self.backbone = backbone
        self.output_proj = Linear(feature_dim, geometry_dim, **kw)
        self.ctx_dim_reductor = Linear(input_ctx_dim, feature_dim, **kw)
        object.__setattr__(self, "reparam", reparam)
        self.output_norm_groups = output_norm_groups
        self.lookup_impl = lookup_impl

    @property
    def lookup_impl(self) -> str:
        return self._lookup_impl

    @lookup_impl.setter
    def lookup_impl(self, value: str) -> None:
        if value not in LOOKUP_IMPLS:
            raise ValueError(f"lookup_impl must be one of {LOOKUP_IMPLS}, got {value!r}")
        self._lookup_impl = value

    def forward(self, t: torch.Tensor, x: torch.Tensor, ctx: Any,
                hs: Optional[torch.Tensor] = None, return_h: bool = False, dropout=None):
        xyz_features = self.xyz_embed(x)
        hw01 = self.reparam.diffusion_to_hw(x.float(), ctx.K)  # [B, N, 2]
        looked_up = lookup_pyramid(ctx.features, hw01, impl=self.lookup_impl)
        features = xyz_features + self.ctx_dim_reductor(looked_up).to(xyz_features.dtype)
        # no analytic in_sums: the backbone takes the sums of its input stream
        processed, *stored, sums = self.backbone(features, t[..., None], hs=hs,
                                                 return_h=return_h, with_sums=True,
                                                 dropout=dropout)
        y = _head(self.output_proj, self.output_norm_groups, processed, sums, x.dtype,
                  points_group())
        return (y, *stored) if return_h else y
