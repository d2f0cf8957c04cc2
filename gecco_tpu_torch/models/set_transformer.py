"""Induced set attention transformer (counterpart of
``gecco_tpu/models/set_transformer.py``).

Four execution strategies compute the same function:

- ``attn_impl="xla"`` (the JAX package's name for its plain path): per-head
  attention through the plain ``rect_attention`` and the modules as
  written;
- ``attn_impl="pallas"``: the same per-head modules, the attention of the
  pool and the unpool through the per-head attention kernels
  (``rect_attention(impl="pallas")``, forward and backward);
- ``attn_impl="folded"``: the same modules, the pool and the unpool through
  the folded attention in plain PyTorch (``pool_attention_folded`` /
  ``unpool_attention_folded``, ``impl="xla"``);
- ``attn_impl="folded_pallas"``: ``AttentionPool`` and ``Unpool`` alone
  take the folded attention's kernels (the resident pool without its
  pre-norm, the unpool without pre-norm and residual); each layer runs the
  four fused functions of ``gecco_tpu_torch.ops.kernels`` (pool, h-side,
  unpool, MLP) with the statistics chain: every pre-norm takes its
  GroupNorm statistics from the channel sums that the previous fused
  function emitted for its output. A layer called without those sums takes
  the resident pool (``folded_pool_layer``, the statistics computed on the
  card) where no gradient is recorded, the statistics in PyTorch and the
  tiled pool with one. With ``GECCO_UNPOOL_MLP_MEGAKERNEL=1`` in the
  environment (read at each call) and no gradient recorded, the unpool and
  the MLP run as one function, ``fused_unpool_mlp``.

On CUDA tensors the kernel paths launch the Hopper kernels; on CPU tensors
their plain versions. Both are differentiable: the gradients reach every
parameter (on the fused path through the weight folds, the AdaGN affines
and the channel sums), as on the plain path.

The JAX package stacks the layers and scans over them; here they are an
``nn.ModuleList`` walked by a Python loop. ``remat=True`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint`` around the scan body): the same function, with each
forward kernel launched a second time per training step. ``return_h=True``
returns the layers' inducer tokens ``[L, B, I, C]``, and ``hs=...`` reuses
them (the pool side skipped: the cached evaluations of
``Diffusion.upsample``). ``ref_jax_compat`` is not ported yet.
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
from gecco_tpu_torch.ops.attention import (
    pool_attention_folded,
    rect_attention,
    unpool_attention_folded,
)
from gecco_tpu_torch.ops.kernels import (
    folded_pool_ext,
    folded_pool_layer,
    folded_unpool,
    fused_h_side,
    fused_mlp_residual,
    fused_unpool_mlp,
)
from gecco_tpu_torch.ops.kernels.folded_attention import group_indicator, unpool_mlp_fits_sm
from gecco_tpu_torch.utils.modules import Linear, resolve_device

__all__ = ["AttentionPool", "Unpool", "Broadcast", "BroadcastingLayer", "SetTransformer"]

ATTN_IMPLS = ("xla", "pallas", "folded", "folded_pallas")
FOLDED = ("folded", "folded_pallas")


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
        # [B, N, C] -> [B, I, C]
        if attn_impl in FOLDED:
            return pool_attention_folded(
                kv, self.inducers, self.kv_proj.weight, self.out_proj.weight, self.num_heads,
                impl="pallas" if attn_impl == "folded_pallas" else "xla",
            )
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
        # x [B, N, C] queries, h [B, I, C] keys/values -> [B, N, C]
        if attn_impl in FOLDED:
            return unpool_attention_folded(
                x, h, self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
                self.out_proj.weight, self.num_heads,
                impl="pallas" if attn_impl == "folded_pallas" else "xla",
            )
        q = _split_heads(self.q_proj(x), self.num_heads)
        k = _split_heads(self.k_proj(h), self.num_heads)
        v = _split_heads(self.v_proj(h), self.num_heads)
        return self.out_proj(_merge_heads(rect_attention(q, k, v, impl=attn_impl)))


class Broadcast(nn.Module):
    """pool -> AdaGN -> MLP -> AdaGN -> unpool; with a cached inducer state
    ``h`` the pool side is skipped."""

    def __init__(self, feature_dim, num_inducers, embed_dim, num_heads=8, mlp_blowup=2,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.pool = AttentionPool(feature_dim, num_heads, num_inducers, **kw)
        self.norm_1 = AdaGN(feature_dim, embed_dim, **kw)
        self.mlp = MLP(feature_dim, feature_dim, mlp_blowup * feature_dim, **kw)
        self.norm_2 = AdaGN(feature_dim, embed_dim, **kw)
        self.unpool = Unpool(feature_dim, num_heads, **kw)

    def forward(self, x, embed, h=None, attn_impl="xla"):
        if h is None:
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

    def forward(self, x, embed, attn_impl="xla", in_sums: Optional[torch.Tensor] = None,
                h: Optional[torch.Tensor] = None, kv: Optional[tuple] = None):
        """-> (x, h, out_sums). ``in_sums`` [B, 2, C] fp32 are the channel
        sums of ``x`` for the fused path; ``out_sums`` those of the output,
        or None on the plain paths. ``h`` [B, I, C]: a cached inducer state
        (the pool side is skipped); ``kv``: its unpool k/v projections,
        hoisted by the caller (fused path only)."""
        if attn_impl == "folded_pallas":
            return self._fused_call(x, embed, in_sums, h, kv)
        x_b, h = self.broadcast(self.broadcast_norm(x, embed), embed, h=h, attn_impl=attn_impl)
        x = x + x_b
        return x + self.mlp(self.mlp_norm(x, embed)), h, None

    def _fused_call(self, x, embed, in_sums, h, kv):
        """The layer through the four fused functions: pool (pre-norm
        inline), h-side, unpool (+ residual + output sums), MLP (+ residual
        + output sums). Same function as the plain path.

        The pool's pre-norm takes its statistics from ``in_sums``. Without
        them it takes the resident pool, which computes them on the card,
        where no gradient is recorded (the port's stand-in for the JAX
        package's "no network key"), and the statistics in PyTorch and the
        tiled pool with one, as the JAX package does in training. With a
        cached ``h`` the pool and the h-side are skipped: the unpool's
        pre-norm takes ``in_sums`` (or the statistics of x) and its k/v are
        ``kv`` or the projections of h.

        With ``GECCO_UNPOOL_MLP_MEGAKERNEL=1`` (read at each call, as the
        JAX package reads it at trace time), the unpool and the MLP run as
        one megakernel, ``fused_unpool_mlp``, where the JAX package takes
        it: only when no network key is threaded, i.e. in sampling. The
        port threads no key; no gradient being recorded stands in for it
        (``Diffusion.sample`` runs under ``torch.no_grad``, the loss with
        grad on). On CUDA tensors a body of the kernel must also take the
        shapes (``unpool_mlp_fits_sm``: the Hopper body's cluster, or the
        WMMA body's point tile in one SM's shared memory), else the two
        kernels run; the plain version on CPU tensors has no such limit."""
        b, n, c = x.shape
        dt = x.dtype
        bc = self.broadcast
        num_heads = bc.unpool.num_heads
        embed_f = embed.float()
        norm = self.broadcast_norm
        if h is not None:
            if in_sums is not None:
                se1, be1 = norm.scale_bias_from_sums(in_sums, n, embed)
            else:
                se1, be1 = norm.effective_scale_bias(x, embed)
            if kv is None:
                hd = h.to(dt)
                kv = (hd @ bc.unpool.k_proj.weight.to(dt).T,
                      hd @ bc.unpool.v_proj.weight.to(dt).T)
            k, v = kv
        else:
            ind2 = bc.pool.inducers.reshape(-1, c // num_heads).to(dt)
            kvw, wo_p = bc.pool.kv_proj.weight.to(dt), bc.pool.out_proj.weight.to(dt)
            # Grad mode stands in for the JAX package's network key, but
            # the two part in the exact likelihood: there grad is on (its
            # divergence is a VJP) and JAX threads no key. They route alike
            # only because the fused chain always supplies ``in_sums``
            # (``SetTransformer.forward``, as JAX's chain does), so both
            # take folded_pool_ext; the sums-less branches below run only
            # for a layer called on its own. (Under the opt-in megakernel
            # JAX's likelihood takes fused_unpool_mlp, whose gradient is the
            # separate kernels'; the port runs those kernels under grad.)
            if in_sums is not None:
                se1, be1 = norm.scale_bias_from_sums(in_sums, n, embed)
                h0 = folded_pool_ext(x, se1, be1, ind2, kvw, wo_p, num_heads)
            elif torch.is_grad_enabled():
                se1, be1 = norm.effective_scale_bias(x, embed)
                h0 = folded_pool_ext(x, se1, be1, ind2, kvw, wo_p, num_heads)
            else:
                h0, mean_c, inv_c = folded_pool_layer(
                    x, norm.scale_linear(embed_f), norm.bias_linear(embed_f), ind2, kvw, wo_p,
                    group_indicator(c, norm.num_groups, x.device), num_heads, True,
                )
                se1, be1 = norm._affine(mean_c, inv_c, embed)
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
                     or unpool_mlp_fits_sm(n, c, k.shape[1], mlp_ops[0].shape[1], num_heads,
                                           dt))):
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

    def forward(self, features, embed, hs=None, return_h=False, in_sums=None, with_sums=False):
        """``features`` [B, N, C], ``embed`` [B, E] -> [B, N, C], followed
        by the layers' inducer tokens [L, B, I, C] where ``return_h`` and by
        the output's channel sums (None off the fused path) where
        ``with_sums``. ``hs`` [L, B, I, C]: cached inducer tokens, each
        layer's pool side skipped (on the fused path the unpool's k/v
        projections of all layers go first, in two batched products).
        ``in_sums`` ([B, 2, C] fp32): channel sums of ``features``, seeding
        the fused path's statistics chain."""
        in_dtype = features.dtype
        x = features.to(self.compute_dtype)
        # the embed (sigma itself, up to sigma_max) is rounded to the compute
        # dtype before the AdaGN linears, as in the JAX package
        embed = embed.to(self.compute_dtype)
        fused = self.attn_impl == "folded_pallas"
        sums = None
        if fused:
            if in_sums is not None:
                sums = in_sums.float()
            else:
                xf = x.float()
                sums = torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)
        kvs = [None] * len(self.layers)
        if hs is not None and fused:
            hd = hs.to(x.dtype)
            unpools = [layer.broadcast.unpool for layer in self.layers]
            kw = torch.stack([u.k_proj.weight for u in unpools]).to(x.dtype)
            vw = torch.stack([u.v_proj.weight for u in unpools]).to(x.dtype)
            kvs = list(zip(torch.einsum("lbic,ldc->lbid", hd, kw),
                           torch.einsum("lbic,ldc->lbid", hd, vw)))
        remat = self.remat and torch.is_grad_enabled() and hs is None
        stored = []
        for q, layer in enumerate(self.layers):
            if remat:
                x, h, sums = checkpoint(layer, x, embed, self.attn_impl, sums, use_reentrant=False)
            else:
                h = None if hs is None else hs[q].to(x.dtype)
                x, h, sums = layer(x, embed, self.attn_impl, in_sums=sums, h=h, kv=kvs[q])
            stored.append(h)
        out = (x.to(in_dtype),)
        if return_h:
            out += (hs if hs is not None else torch.stack(stored),)
        if with_sums:
            out += (sums,)
        return out if len(out) > 1 else out[0]
