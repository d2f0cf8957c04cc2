"""Denoiser networks around the set-transformer backbone (counterpart of
``gecco_tpu.models.wrappers``: ``UnconditionalPointNetwork`` and
``RayNetwork``).

Network contract: ``net(t [B], x [B, N, 3], ctx) -> [B, N, 3]`` where ``t``
is the preconditioned noise level (c_noise) and ``x`` the c_in-scaled points.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from gecco_tpu_torch.models.set_transformer import SetTransformer
from gecco_tpu_torch.ops.norms import group_norm, stats_from_sums
from gecco_tpu_torch.ops.projective import LOOKUP_IMPLS, lookup_pyramid
from gecco_tpu_torch.utils.modules import Linear

__all__ = ["RayNetwork", "UnconditionalPointNetwork"]


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


def _head(proj: Linear, num_groups: int, processed: torch.Tensor, sums, dtype) -> torch.Tensor:
    """GroupNorm -> Linear: folded, from the backbone's channel sums, on the
    fused path; as written on the plain path (``sums`` None)."""
    if sums is not None:
        return _folded_head(proj, num_groups, processed, sums).to(dtype)
    return proj(group_norm(processed, num_groups)).to(dtype)


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
        return _head(self.output_proj, self.output_norm_groups, processed, sums, x.dtype)


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

    def forward(self, t: torch.Tensor, x: torch.Tensor, ctx: Any) -> torch.Tensor:
        xyz_features = self.xyz_embed(x)
        hw01 = self.reparam.diffusion_to_hw(x.float(), ctx.K)  # [B, N, 2]
        looked_up = lookup_pyramid(ctx.features, hw01, impl=self.lookup_impl)
        features = xyz_features + self.ctx_dim_reductor(looked_up).to(xyz_features.dtype)
        # no analytic in_sums: the backbone takes the sums of its input stream
        processed, sums = self.backbone(features, t[..., None], with_sums=True)
        return _head(self.output_proj, self.output_norm_groups, processed, sums, x.dtype)
