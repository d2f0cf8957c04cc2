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
``Diffusion.upsample``).

``activation`` (default the Gaussian) is every MLP's; ``ref_jax_compat=True``
applies each layer's second MLP to the un-normed residual stream, as
gecco-jax does (its ``mlp_norm`` is computed and discarded there, and kept
here, unused, so that its checkpoints load): the function of the released
``.eqx`` weights (``gecco_tpu_torch.compat``). ``dropout=`` on ``forward``
is the mask source of the MLPs' dropout (``models/mlp.py``), the port's
counterpart of the JAX package's network key.

On ``folded_pallas`` a part that the fused functions cannot take runs
unfused, as in the JAX package: an MLP that is not fusable (``_mlp_fusable``:
two layers with biases, the Gaussian activation, no dropout where a mask
source is threaded) takes its h-side (norm_1, MLP, norm_2, then the k/v
projections) or its residual MLP (with ``mlp_norm`` where the model is not
in compat) in PyTorch; the statistics chain runs only where every layer's
parts all fuse (the JAX package's ``chain_sums``), else each layer's pool
takes its statistics itself. Under ``ref_jax_compat`` the fused MLP takes
the identity pre-norm (``se2 = 1``, ``be2 = 0``) and the megakernel is off.

Under point sharding (``parallel.sharding_points``: each rank of the
points' group holds a slice of every cloud's points) the layers issue the
collectives that the JAX package's partitioning rules insert: every pool
takes the points gathered over the group (``gather_points``), so the pool
kernel runs at the global N and its backward's dx goes back through the
gather's adjoint; the point-side norms' channel sums (the statistics
chain's, the unpool's and the MLP's emitted sums, the plain paths'
GroupNorms) are summed over the group (``sum_over_points``) and normalised
by the global N; the h-side, on the replicated inducer tokens, and the
unpool and the MLP, on the rank's own points, issue none. The megakernel
is off there, as in the JAX package: its statistics would be the shard's.
A point-side MLP's dropout masks are drawn at the global N and the rank's
slice kept.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gecco_tpu_torch.models.activation import GaussianActivation
from gecco_tpu_torch.models.mlp import MLP, DropoutFn, shard_point_dropout
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
from gecco_tpu_torch.parallel.collectives import (
    gather_points,
    point_shard,
    points_group,
    sharding_points,
    sum_over_points,
)
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


def _mlp_fusable(mlp: MLP, dropout: Optional[DropoutFn]) -> bool:
    """Whether an MLP matches the fused functions' operand convention (with
    a mask source threaded, only an MLP without dropout does)."""
    return (
        len(mlp.layers) == 2
        and isinstance(mlp.activation, GaussianActivation)
        and (dropout is None or mlp.dropout_p == 0.0)
        and all(layer.bias is not None for layer in mlp.layers)
    )


def _hside_fusable(bc: "Broadcast", dropout: Optional[DropoutFn]) -> bool:
    """Whether the h-side (norm_1, MLP, norm_2) runs as ``fused_h_side``."""
    return (
        _mlp_fusable(bc.mlp, dropout)
        and isinstance(bc.norm_1, AdaGN)
        and isinstance(bc.norm_2, AdaGN)
        and bc.norm_1.num_groups == bc.norm_2.num_groups
    )


class _Replay:
    """A layer's dropout masks: drawn from ``draw`` on the first pass and
    replayed, from ``rewind()``, when the backward pass recomputes the layer
    (``remat``), as the JAX package's checkpointed layer reuses its key."""

    def __init__(self, draw: DropoutFn):
        self.draw, self.masks, self.pos = draw, [], 0

    def rewind(self) -> None:
        self.pos = 0

    def __call__(self, p_keep: float, shape: tuple) -> torch.Tensor:
        if self.pos == len(self.masks):
            self.masks.append(self.draw(p_keep, shape))
        self.pos += 1
        return self.masks[self.pos - 1]


def _point_dropout(dropout: Optional[DropoutFn], group) -> Optional[DropoutFn]:
    """The mask source of a point-side MLP: its masks drawn at every rank's
    points and this rank's slice kept under point sharding."""
    return None if dropout is None else shard_point_dropout(dropout, *point_shard(group))


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
        # [B, N, C] -> [B, I, C], over every point of the points' group
        kv = gather_points(kv, points_group())
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
                 activation=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.pool = AttentionPool(feature_dim, num_heads, num_inducers, **kw)
        self.norm_1 = AdaGN(feature_dim, embed_dim, **kw)
        self.mlp = MLP(feature_dim, feature_dim, mlp_blowup * feature_dim,
                       activation=activation, **kw)
        self.norm_2 = AdaGN(feature_dim, embed_dim, **kw)
        self.unpool = Unpool(feature_dim, num_heads, **kw)

    def forward(self, x, embed, h=None, attn_impl="xla", dropout: Optional[DropoutFn] = None):
        if h is None:
            h = self.norm_1(self.pool(x, attn_impl), embed)
            h = self.norm_2(self.mlp(h, dropout), embed)
        return self.unpool(x, h, attn_impl), h


class BroadcastingLayer(nn.Module):
    """Pre-norm residual transformer layer built on Broadcast."""

    def __init__(self, feature_dim, num_inducers, embed_dim, num_heads=8, mlp_blowup=2,
                 skip_scale=0.1, activation=None, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.broadcast = Broadcast(feature_dim, num_inducers, embed_dim, num_heads, mlp_blowup,
                                   activation, **kw)
        self.mlp = MLP(feature_dim, feature_dim, mlp_blowup * feature_dim,
                       activation=activation, **kw)
        self.broadcast_norm = AdaGN(feature_dim, embed_dim, **kw)
        self.mlp_norm = AdaGN(feature_dim, embed_dim, **kw)
        if skip_scale != 1.0:
            # damp the residual branches at init
            with torch.no_grad():
                self.broadcast.unpool.out_proj.weight.mul_(skip_scale)
                self.mlp.layers[-1].weight.mul_(skip_scale)

    def forward(self, x, embed, attn_impl="xla", in_sums: Optional[torch.Tensor] = None,
                h: Optional[torch.Tensor] = None, kv: Optional[tuple] = None,
                dropout: Optional[DropoutFn] = None, mlp_on_unnormed: bool = False):
        """-> (x, h, out_sums). ``in_sums`` [B, 2, C] fp32 are the channel
        sums of ``x`` for the fused path; ``out_sums`` those of the output,
        or None on the plain paths and where the MLP runs unfused. ``h``
        [B, I, C]: a cached inducer state (the pool side is skipped);
        ``kv``: its unpool k/v projections, hoisted by the caller (fused
        path only). ``dropout``: the MLPs' mask source (the broadcast's MLP
        draws first). ``mlp_on_unnormed``: the second MLP takes the
        un-normed stream (``ref_jax_compat``). Under point sharding
        ``in_sums`` and ``out_sums`` are the whole set's."""
        group = points_group()
        if attn_impl == "folded_pallas":
            return self._fused_call(x, embed, in_sums, h, kv, dropout, mlp_on_unnormed, group)
        x_b, h = self.broadcast(self.broadcast_norm(x, embed, group), embed, h=h,
                                attn_impl=attn_impl, dropout=dropout)
        x = x + x_b
        y = x if mlp_on_unnormed else self.mlp_norm(x, embed, group)
        return x + self.mlp(y, _point_dropout(dropout, group)), h, None

    def _fused_call(self, x, embed, in_sums, h, kv, dropout, mlp_on_unnormed, group):
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
        kernels run; the plain version on CPU tensors has no such limit.
        The megakernel applies ``mlp_norm``, so it is off under
        ``mlp_on_unnormed``, and where the MLP does not fuse.

        An MLP that does not fuse (``_mlp_fusable``) runs in PyTorch: the
        h-side's as norm_1, MLP, norm_2 and the k/v projections; the
        residual MLP after the unpool kernel, on ``mlp_norm``'s output or,
        under ``mlp_on_unnormed``, on the stream itself. Under
        ``mlp_on_unnormed`` the fused MLP takes the identity pre-norm.

        ``group``: the points' group under point sharding. The pool takes
        the gathered points (its pre-norm's statistics, where no sums are
        given, those of the gathered points); the unpool's and the MLP's
        emitted sums are summed over the group; every count of tokens is
        the global N; the megakernel is off."""
        b, n, c = x.shape
        n_all = n * point_shard(group)[1]
        dt = x.dtype
        bc = self.broadcast
        num_heads = bc.unpool.num_heads
        embed_f = embed.float()
        norm = self.broadcast_norm
        if h is not None:
            if in_sums is not None:
                se1, be1 = norm.scale_bias_from_sums(in_sums, n_all, embed)
            else:
                se1, be1 = norm.effective_scale_bias(x, embed, group)
            k, v = kv if kv is not None else (None, None)
        else:
            ind2 = bc.pool.inducers.reshape(-1, c // num_heads).to(dt)
            kvw, wo_p = bc.pool.kv_proj.weight.to(dt), bc.pool.out_proj.weight.to(dt)
            # Grad mode stands in for the JAX package's network key in the
            # routing of a sums-less pool, but the two part in the exact
            # likelihood and under ``train_in_inference_mode``: there grad
            # is on and JAX threads no key. Where the statistics chain runs
            # (every fusable model), ``in_sums`` is given and both take
            # folded_pool_ext. Without the chain (an MLP that does not
            # fuse) the JAX package takes the resident pool there and the
            # port the tiled one: the same function through another kernel.
            # (Under the opt-in megakernel JAX's likelihood takes
            # fused_unpool_mlp, whose gradient is the separate kernels'; the
            # port runs those kernels under grad.)
            x_all = gather_points(x, group)
            if in_sums is not None:
                se1, be1 = norm.scale_bias_from_sums(in_sums, n_all, embed)
                h0 = folded_pool_ext(x_all, se1, be1, ind2, kvw, wo_p, num_heads)
            elif torch.is_grad_enabled():
                se1, be1 = norm.effective_scale_bias(x_all, embed)
                h0 = folded_pool_ext(x_all, se1, be1, ind2, kvw, wo_p, num_heads)
            else:
                h0, mean_c, inv_c = folded_pool_layer(
                    x_all, norm.scale_linear(embed_f), norm.bias_linear(embed_f), ind2, kvw, wo_p,
                    group_indicator(c, norm.num_groups, x.device), num_heads, True,
                )
                se1, be1 = norm._affine(mean_c, inv_c, embed)
            if _hside_fusable(bc, dropout):
                h, k, v = fused_h_side(
                    h0,
                    bc.norm_1.scale_linear(embed_f), bc.norm_1.bias_linear(embed_f),
                    bc.norm_2.scale_linear(embed_f), bc.norm_2.bias_linear(embed_f),
                    group_indicator(c, bc.norm_1.num_groups, x.device),
                    *_fold_mlp_operands(bc.mlp, dt),
                    bc.unpool.k_proj.weight.to(dt), bc.unpool.v_proj.weight.to(dt),
                )
            else:
                h = bc.norm_2(bc.mlp(bc.norm_1(h0, embed), dropout), embed)
                k = None
        if k is None:
            hd = h.to(dt)
            k = hd @ bc.unpool.k_proj.weight.to(dt).T
            v = hd @ bc.unpool.v_proj.weight.to(dt).T
        wq, wo = bc.unpool.q_proj.weight.to(dt), bc.unpool.out_proj.weight.to(dt)
        mlp_ok = _mlp_fusable(self.mlp, dropout)
        mlp_ops = _fold_mlp_operands(self.mlp, dt) if mlp_ok else None
        if (mlp_ok and not mlp_on_unnormed and os.environ.get("GECCO_UNPOOL_MLP_MEGAKERNEL") == "1"
                and not torch.is_grad_enabled() and group is None
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
        if not mlp_ok:
            y = x if mlp_on_unnormed else self.mlp_norm(x, embed, group)
            return x + self.mlp(y, _point_dropout(dropout, group)), h, None
        if mlp_on_unnormed:
            # the identity pre-norm: the unpool's sums go unused
            se2 = torch.ones((b, c), dtype=torch.float32, device=x.device)
            be2 = torch.zeros((b, c), dtype=torch.float32, device=x.device)
        else:
            se2, be2 = self.mlp_norm.scale_bias_from_sums(sum_over_points(sums, group), n_all,
                                                           embed)
        x, out_sums = fused_mlp_residual(x, se2, be2, *mlp_ops)
        return x, h, sum_over_points(out_sums, group)


class SetTransformer(nn.Module):
    """A stack of broadcasting layers: ``(features [B, N, C], embed [B, E])
    -> [B, N, C]``, computed in ``compute_dtype``."""

    def __init__(self, n_layers, feature_dim, num_inducers, embed_dim, num_heads=8, mlp_blowup=2,
                 skip_scale=0.1, compute_dtype=torch.bfloat16, attn_impl="xla", remat=False,
                 activation=None, ref_jax_compat=False, *, device=None, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            BroadcastingLayer(feature_dim, num_inducers, embed_dim, num_heads, mlp_blowup,
                              skip_scale, activation, device=device, generator=generator)
            for _ in range(n_layers)
        )
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.remat = remat
        self.ref_jax_compat = ref_jax_compat

    @property
    def attn_impl(self) -> str:
        return self._attn_impl

    @attn_impl.setter
    def attn_impl(self, value: str) -> None:
        if value not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {value!r}")
        self._attn_impl = value

    def chains_sums(self, dropout: Optional[DropoutFn] = None) -> bool:
        """Whether ``folded_pallas`` runs the statistics chain: every
        layer's MLPs fuse and its norms are AdaGNs (JAX's ``chain_sums``)."""
        return all(
            _mlp_fusable(layer.mlp, dropout) and _mlp_fusable(layer.broadcast.mlp, dropout)
            and all(isinstance(m, AdaGN) for m in (layer.broadcast_norm, layer.mlp_norm,
                                                   layer.broadcast.norm_1, layer.broadcast.norm_2))
            for layer in self.layers
        )

    def forward(self, features, embed, hs=None, return_h=False, in_sums=None, with_sums=False,
                dropout: Optional[DropoutFn] = None):
        """``features`` [B, N, C], ``embed`` [B, E] -> [B, N, C], followed
        by the layers' inducer tokens [L, B, I, C] where ``return_h`` and by
        the output's channel sums (None off the fused path) where
        ``with_sums``. ``hs`` [L, B, I, C]: cached inducer tokens, each
        layer's pool side skipped (on the fused path the unpool's k/v
        projections of all layers go first, in two batched products).
        ``in_sums`` ([B, 2, C] fp32): channel sums of ``features``, seeding
        the fused path's statistics chain (ignored where it does not run).
        ``dropout``: the MLPs' mask source; the cached layers (``hs``) take
        none, as in the JAX package."""
        in_dtype = features.dtype
        x = features.to(self.compute_dtype)
        # the embed (sigma itself, up to sigma_max) is rounded to the compute
        # dtype before the AdaGN linears, as in the JAX package
        embed = embed.to(self.compute_dtype)
        if hs is not None:
            dropout = None
        fused = self.attn_impl == "folded_pallas"
        chain = fused and self.chains_sums(dropout)
        group = points_group()
        sums = None
        if chain:
            if in_sums is not None:
                sums = in_sums.float()
            else:
                xf = x.float()
                sums = sum_over_points(torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1), group)
        kvs = [None] * len(self.layers)
        if hs is not None and fused:
            hd = hs.to(x.dtype)
            unpools = [layer.broadcast.unpool for layer in self.layers]
            kw = torch.stack([u.k_proj.weight for u in unpools]).to(x.dtype)
            vw = torch.stack([u.v_proj.weight for u in unpools]).to(x.dtype)
            kvs = list(zip(torch.einsum("lbic,ldc->lbid", hd, kw),
                           torch.einsum("lbic,ldc->lbid", hd, vw)))
        remat = self.remat and torch.is_grad_enabled() and hs is None
        unnormed = self.ref_jax_compat
        stored = []
        for q, layer in enumerate(self.layers):
            if remat:
                drop = None if dropout is None else _Replay(dropout)

                # the recompute runs in the backward pass: it issues the
                # forward's collectives again, under the forward's group
                def run(x, sums, layer=layer, drop=drop):
                    if drop is not None:
                        drop.rewind()
                    with sharding_points(group):
                        return layer(x, embed, self.attn_impl, in_sums=sums, dropout=drop,
                                     mlp_on_unnormed=unnormed)

                x, h, out_sums = checkpoint(run, x, sums, use_reentrant=False)
            else:
                h = None if hs is None else hs[q].to(x.dtype)
                x, h, out_sums = layer(x, embed, self.attn_impl, in_sums=sums, h=h, kv=kvs[q],
                                       dropout=dropout, mlp_on_unnormed=unnormed)
            sums = out_sums if chain else None
            stored.append(h)
        out = (x.to(in_dtype),)
        if return_h:
            out += (hs if hs is not None else torch.stack(stored),)
        if with_sums:
            out += (sums,)
        return out if len(out) > 1 else out[0]
