"""Induced set attention transformer (counterpart of
``gecco_tpu/models/set_transformer.py``).

Three execution strategies compute the same function:

- ``attn_impl="xla"`` (the JAX package's name for its plain path): per-head
  attention through the plain ``rect_attention`` and the modules as
  written;
- ``attn_impl="pallas"``: the same per-head modules, the attention of the
  pool and the unpool through the per-head attention kernels
  (``rect_attention(impl="pallas")``, forward and backward);
- ``attn_impl="folded_pallas"``: each layer runs the four fused functions of
  ``gecco_tpu_torch.ops.kernels`` (pool, h-side, unpool, MLP) with the
  statistics chain: every pre-norm takes its GroupNorm statistics from the
  channel sums that the previous fused function emitted for its output.
  With ``GECCO_UNPOOL_MLP_MEGAKERNEL=1`` in the environment (read at each
  call) and no gradient recorded, the unpool and the MLP run as one
  function, ``fused_unpool_mlp``.

On CUDA tensors the kernel paths launch the Hopper kernels; on CPU tensors
their plain versions. Both are differentiable: the gradients reach every
parameter (on the fused path through the weight folds, the AdaGN affines
and the channel sums), as on the plain path.

The JAX package stacks the layers and scans over them; here they are an
``nn.ModuleList`` walked by a Python loop. ``remat=True`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint`` around the scan body): the same function, with each
forward kernel launched a second time per training step. The
cached-inducer upsampling path (``hs`` / ``return_h``), the XLA-folded
``attn_impl="folded"``, the module-level folded calls of ``AttentionPool``
and ``Unpool`` and ``ref_jax_compat`` are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gecco_tpu_torch.models.activation import GaussianActivation
from gecco_tpu_torch.models.mlp import MLP
from gecco_tpu_torch.models.normalization import AdaGN
from gecco_tpu_torch.ops.attention import rect_attention
from gecco_tpu_torch.ops.kernels import (
    folded_pool_ext,
    folded_unpool,
    fused_h_side,
    fused_mlp_residual,
    fused_unpool_mlp,
)
from gecco_tpu_torch.ops.kernels.folded_attention import group_indicator, unpool_mlp_fits_sm
from gecco_tpu_torch.utils.modules import Linear, resolve_device

__all__ = ["AttentionPool", "Unpool", "Broadcast", "BroadcastingLayer", "SetTransformer"]

ATTN_IMPLS = ("xla", "pallas", "folded_pallas")


def _fold_mlp_operands(mlp: MLP, dt) -> tuple:
    """Alpha (and the normalized-activation affine) folded into a 2-layer
    MLP's weights: ``(w1t [C, W] dt, b1 [1, W] fp32, w2t [W, C] dt,
    b2 [1, C] fp32)``, the operands of the fused MLP and h-side."""
    w1, w2 = mlp.layers
    alpha = mlp.activation.alpha.float()
    w1t = (w1.weight.float() / alpha).T.to(dt).contiguous()
    b1 = (w1.bias.float() / alpha)[None]
    w2t = w2.weight.float().T
    b2 = w2.bias.float()[None]
    if mlp.activation.normalized:
        # fold (g - 0.7) / 0.28 into the second projection
        b2 = b2 - (0.7 / 0.28) * w2t.sum(0, keepdim=True)
        w2t = w2t / 0.28
    return w1t, b1.contiguous(), w2t.to(dt).contiguous(), b2.contiguous()


def _mlp_fusable(mlp: MLP) -> bool:
    """Whether an MLP matches the fused functions' operand convention."""
    return (
        len(mlp.layers) == 2
        and isinstance(mlp.activation, GaussianActivation)
        and all(layer.bias is not None for layer in mlp.layers)
    )


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape  # [B, N, C] -> [B, H, N, D]
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape  # [B, H, N, D] -> [B, N, H*D]
    return x.transpose(1, 2).reshape(b, n, h * d)


class AttentionPool(nn.Module):
    """Cross-attention from learnable inducer queries [H, I, D] to the set."""

    def __init__(self, feature_dim, num_heads, num_inducers, *, device=None, generator=None):
        super().__init__()
        if feature_dim % num_heads:
            raise ValueError(f"feature_dim {feature_dim} not divisible by {num_heads} heads")
        dev = resolve_device(device)
        shape = (num_heads, num_inducers, feature_dim // num_heads)
        self.inducers = nn.Parameter(torch.randn(shape, generator=generator).to(dev))
        self.kv_proj = Linear(feature_dim, 2 * feature_dim, bias=False, device=dev, generator=generator)
        self.out_proj = Linear(feature_dim, feature_dim, bias=False, device=dev, generator=generator)
        self.num_heads = num_heads

    def forward(self, kv: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
        # [B, N, C] -> [B, I, C]; attn_impl "xla" or "pallas" (rect_attention's impl)
        k, v = self.kv_proj(kv).chunk(2, dim=-1)
        q = self.inducers.to(kv.dtype)[None].expand(kv.shape[0], -1, -1, -1)
        attn = rect_attention(q, _split_heads(k, self.num_heads), _split_heads(v, self.num_heads),
                              impl=attn_impl)
        return self.out_proj(_merge_heads(attn))


class Unpool(nn.Module):
    """Multi-head cross-attention: set queries against inducer keys/values."""

    def __init__(self, feature_dim, num_heads, *, device=None, generator=None):
        super().__init__()
        if feature_dim % num_heads:
            raise ValueError(f"feature_dim {feature_dim} not divisible by {num_heads} heads")
        lin = lambda: Linear(feature_dim, feature_dim, bias=False, device=device, generator=generator)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = lin(), lin(), lin(), lin()
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor, h: torch.Tensor, attn_impl: str = "xla") -> torch.Tensor:
        q = _split_heads(self.q_proj(x), self.num_heads)
        k = _split_heads(self.k_proj(h), self.num_heads)
        v = _split_heads(self.v_proj(h), self.num_heads)
        return self.out_proj(_merge_heads(rect_attention(q, k, v, impl=attn_impl)))


class Broadcast(nn.Module):
    """pool -> AdaGN -> MLP -> AdaGN -> unpool."""

    def __init__(self, feature_dim, num_inducers, embed_dim, num_heads=8, mlp_blowup=2,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.pool = AttentionPool(feature_dim, num_heads, num_inducers, **kw)
        self.norm_1 = AdaGN(feature_dim, embed_dim, **kw)
        self.mlp = MLP(feature_dim, feature_dim, mlp_blowup * feature_dim, **kw)
        self.norm_2 = AdaGN(feature_dim, embed_dim, **kw)
        self.unpool = Unpool(feature_dim, num_heads, **kw)

    def forward(self, x, embed, attn_impl="xla"):
        h = self.norm_2(self.mlp(self.norm_1(self.pool(x, attn_impl), embed)), embed)
        return self.unpool(x, h, attn_impl), h


class BroadcastingLayer(nn.Module):
    """Pre-norm residual transformer layer built on Broadcast."""

    def __init__(self, feature_dim, num_inducers, embed_dim, num_heads=8, mlp_blowup=2,
                 skip_scale=0.1, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.broadcast = Broadcast(feature_dim, num_inducers, embed_dim, num_heads, mlp_blowup, **kw)
        self.mlp = MLP(feature_dim, feature_dim, mlp_blowup * feature_dim, **kw)
        self.broadcast_norm = AdaGN(feature_dim, embed_dim, **kw)
        self.mlp_norm = AdaGN(feature_dim, embed_dim, **kw)
        if skip_scale != 1.0:
            # damp the residual branches at init
            with torch.no_grad():
                self.broadcast.unpool.out_proj.weight.mul_(skip_scale)
                self.mlp.layers[-1].weight.mul_(skip_scale)

    def forward(self, x, embed, attn_impl="xla", in_sums: Optional[torch.Tensor] = None):
        """-> (x, h, out_sums). ``in_sums`` [B, 2, C] fp32 are the channel
        sums of ``x`` for the fused path (computed here when absent);
        ``out_sums`` those of the output, or None on the plain path."""
        if attn_impl == "folded_pallas":
            return self._fused_call(x, embed, in_sums)
        x_b, h = self.broadcast(self.broadcast_norm(x, embed), embed, attn_impl)
        x = x + x_b
        return x + self.mlp(self.mlp_norm(x, embed)), h, None

    def _fused_call(self, x, embed, in_sums):
        """The layer through the four fused functions: pool (pre-norm
        inline), h-side, unpool (+ residual + output sums), MLP (+ residual
        + output sums). Same function as the plain path.

        With ``GECCO_UNPOOL_MLP_MEGAKERNEL=1`` (read at each call, as the
        JAX package reads it at trace time), the unpool and the MLP run as
        one megakernel, ``fused_unpool_mlp``, where the JAX package takes
        it: only when no network key is threaded, i.e. in sampling. The
        port threads no key; no gradient being recorded stands in for it
        (``Diffusion.sample`` runs under ``torch.no_grad``, the loss with
        grad on). On CUDA tensors the shapes must also fit the kernel
        (``unpool_mlp_fits_sm``, one SM's shared memory), else the two
        kernels run; the plain version on CPU tensors has no such limit."""
        b, n, c = x.shape
        dt = x.dtype
        bc = self.broadcast
        num_heads = bc.unpool.num_heads
        embed_f = embed.float()
        if in_sums is None:
            xf = x.float()
            in_sums = torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)

        ind2 = bc.pool.inducers.reshape(-1, c // num_heads).to(dt)
        se1, be1 = self.broadcast_norm.scale_bias_from_sums(in_sums, n, embed)
        h0 = folded_pool_ext(
            x, se1, be1, ind2, bc.pool.kv_proj.weight.to(dt), bc.pool.out_proj.weight.to(dt),
            num_heads,
        )
        h, k, v = fused_h_side(
            h0,
            bc.norm_1.scale_linear(embed_f), bc.norm_1.bias_linear(embed_f),
            bc.norm_2.scale_linear(embed_f), bc.norm_2.bias_linear(embed_f),
            group_indicator(c, bc.norm_1.num_groups, x.device),
            *_fold_mlp_operands(bc.mlp, dt),
            bc.unpool.k_proj.weight.to(dt), bc.unpool.v_proj.weight.to(dt),
        )
        wq, wo = bc.unpool.q_proj.weight.to(dt), bc.unpool.out_proj.weight.to(dt)
        mlp_ops = _fold_mlp_operands(self.mlp, dt)
        if (os.environ.get("GECCO_UNPOOL_MLP_MEGAKERNEL") == "1" and not torch.is_grad_enabled()
                and (x.device.type == "cpu"
                     or unpool_mlp_fits_sm(n, c, k.shape[1], mlp_ops[0].shape[1]))):
            groups = self.mlp_norm.num_groups
            x, out_sums = fused_unpool_mlp(
                x, se1, be1, k, v, wq, wo,
                self.mlp_norm.scale_linear(embed_f), self.mlp_norm.bias_linear(embed_f),
                group_indicator(c, groups, x.device), *mlp_ops, num_heads, groups, n,
            )
            return x, h, out_sums
        x, sums = folded_unpool(x, se1, be1, k, v, wq, wo, num_heads)
        se2, be2 = self.mlp_norm.scale_bias_from_sums(sums, n, embed)
        x, out_sums = fused_mlp_residual(x, se2, be2, *mlp_ops)
        return x, h, out_sums


class SetTransformer(nn.Module):
    """A stack of broadcasting layers: ``(features [B, N, C], embed [B, E])
    -> [B, N, C]``, computed in ``compute_dtype``."""

    def __init__(self, n_layers, feature_dim, num_inducers, embed_dim, num_heads=8, mlp_blowup=2,
                 skip_scale=0.1, compute_dtype=torch.bfloat16, attn_impl="xla", remat=False,
                 *, device=None, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            BroadcastingLayer(feature_dim, num_inducers, embed_dim, num_heads, mlp_blowup,
                              skip_scale, device=device, generator=generator)
            for _ in range(n_layers)
        )
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.remat = remat

    @property
    def attn_impl(self) -> str:
        return self._attn_impl

    @attn_impl.setter
    def attn_impl(self, value: str) -> None:
        if value not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {value!r}")
        if value == "folded_pallas":
            for layer in self.layers:
                norms = (layer.broadcast_norm, layer.mlp_norm, layer.broadcast.norm_1,
                         layer.broadcast.norm_2)
                if not (_mlp_fusable(layer.mlp) and _mlp_fusable(layer.broadcast.mlp)
                        and all(isinstance(m, AdaGN) for m in norms)
                        and layer.broadcast.norm_1.num_groups == layer.broadcast.norm_2.num_groups):
                    raise ValueError("folded_pallas needs fusable MLPs and AdaGN norms")
        self._attn_impl = value

    def forward(self, features, embed, in_sums=None, with_sums=False):
        """``in_sums`` ([B, 2, C] fp32, optional): channel sums of
        ``features``, seeding the fused path's statistics chain.
        ``with_sums=True`` also returns the output's channel sums (None on
        the plain path)."""
        in_dtype = features.dtype
        x = features.to(self.compute_dtype)
        # the embed (sigma itself, up to sigma_max) is rounded to the compute
        # dtype before the AdaGN linears, as in the JAX package
        embed = embed.to(self.compute_dtype)
        sums = None
        if self.attn_impl == "folded_pallas":
            if in_sums is not None:
                sums = in_sums.float()
            else:
                xf = x.float()
                sums = torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x, _, sums = checkpoint(layer, x, embed, self.attn_impl, sums, use_reentrant=False)
            else:
                x, _, sums = layer(x, embed, self.attn_impl, in_sums=sums)
        x = x.to(in_dtype)
        return (x, sums) if with_sums else x
