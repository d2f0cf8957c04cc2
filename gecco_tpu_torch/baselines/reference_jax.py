"""The reference's (gecco-jax's) computational structure in plain fp32
PyTorch (counterpart of ``gecco_tpu/baselines/reference_jax.py``; the name
is the structure's, nothing here imports JAX): the yardstick of a benchmark
arm, computing the same function as the port's ``ref_jax_compat=True`` model
by the reference's means:

- per-example calls, batched only by an outer ``torch.func.vmap`` (the
  reference's per-example equinox modules under ``vmap``);
- per-token ``torch.func.vmap`` of every Linear (the reference's
  ``jax.vmap(proj)(x)``);
- separate key and value projections (the port's ``kv_proj`` rows split
  back) and the reference's ``[I, H, D]`` inducers; per-head unfused
  dot-product attention, vmapped over the heads, in the pool and in the
  ``MultiheadAttention``-style unpool;
- a Python loop over the layers;
- channels-first GroupNorm (the reference's MoveChannels transpose);
- each layer's ``mlp_norm`` computed and discarded, its second MLP on the
  un-normed stream;
- fixed-grid Heun sampling, two evaluations a transition.

The weights are read from a port ``Diffusion`` (an unconditional network
over a ``SetTransformer``) and used in fp32 whatever its compute dtype.
No kernel runs and nothing of ``ops/kernels`` is used.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

__all__ = ["ref_denoise", "ref_denoise_single", "ref_sample", "ref_sample_from"]


def _vlinear(lin, x: torch.Tensor) -> torch.Tensor:
    """A Linear applied token by token (``vmap`` over the rows of ``x``)."""
    w = lin.weight.float()
    b = None if lin.bias is None else lin.bias.float()
    return vmap(lambda t: w @ t if b is None else w @ t + b)(x)


def _dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One head: ``[I, D] x [N, D] x [N, D] -> [I, D]``."""
    logits = q @ k.T / math.sqrt(q.shape[-1])
    return torch.softmax(logits, dim=-1) @ v


def _group_norm_cf(x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of ``[N, C]`` channels first: ``[C, N]``, statistics per
    group over its C / G channels and the N tokens."""
    n, c = x.shape
    xt = x.T.reshape(num_groups, -1)
    mean = xt.mean(dim=-1, keepdim=True)
    var = xt.var(dim=-1, unbiased=False, keepdim=True)
    return ((xt - mean) / torch.sqrt(var + eps)).reshape(c, n).T


def _ada_gn(norm, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """AdaGN: GroupNorm, then the embed-conditioned affine."""
    scale = norm.scale_linear.weight.float() @ embed + norm.scale_linear.bias.float()
    bias = norm.bias_linear.weight.float() @ embed + norm.bias_linear.bias.float()
    return scale[None, :] * _group_norm_cf(x, norm.num_groups) + bias[None, :]


def _mlp(mlp, x: torch.Tensor) -> torch.Tensor:
    for lin in mlp.layers[:-1]:
        x = mlp.activation(_vlinear(lin, x))
    return _vlinear(mlp.layers[-1], x)


def _attention_pool(pool, kv: torch.Tensor) -> torch.Tensor:
    """Inducer queries against the set, separate key and value projections,
    a vmap over the heads."""
    n, c = kv.shape
    heads = pool.num_heads
    kw = pool.kv_proj.weight.float()  # rows [k; v]
    key_heads = vmap(lambda t: kw[:c] @ t)(kv).reshape(n, heads, -1)
    value_heads = vmap(lambda t: kw[c:] @ t)(kv).reshape(n, heads, -1)
    query_heads = pool.inducers.float().transpose(0, 1)  # [I, H, D]
    attn = vmap(_dot_product_attention, in_dims=1, out_dims=1)(query_heads, key_heads,
                                                               value_heads)
    return _vlinear(pool.out_proj, attn.reshape(query_heads.shape[0], -1))


def _multihead_attention(unpool, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """``MultiheadAttention``-style unpool: q/k/v/out projections, a vmap over
    the heads."""
    heads = unpool.num_heads
    qh = _vlinear(unpool.q_proj, q).reshape(q.shape[0], heads, -1)
    kh = _vlinear(unpool.k_proj, kv).reshape(kv.shape[0], heads, -1)
    vh = _vlinear(unpool.v_proj, kv).reshape(kv.shape[0], heads, -1)
    attn = vmap(_dot_product_attention, in_dims=1, out_dims=1)(qh, kh, vh)
    return _vlinear(unpool.out_proj, attn.reshape(q.shape[0], -1))


def _broadcast(b, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    h = _attention_pool(b.pool, x)
    h = _ada_gn(b.norm_1, h, embed)
    h = _mlp(b.mlp, h)
    h = _ada_gn(b.norm_2, h, embed)
    return _multihead_attention(b.unpool, x, h)


def _layer(layer, x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    y = _ada_gn(layer.broadcast_norm, x, embed)
    x = x + _broadcast(layer.broadcast, y, embed)
    _ = _ada_gn(layer.mlp_norm, x, embed)  # computed and discarded, as in the reference
    return x + _mlp(layer.mlp, x)


def ref_denoise_single(model, sigma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The preconditioned denoiser of one example ``x [N, D]`` at the 0-d
    ``sigma``, in fp32."""
    sched = model.schedule
    net = model.network
    sigma = sigma.float()
    x = x.float()
    h = _vlinear(net.xyz_embed, sched.c_in(sigma) * x)
    embed = sched.c_noise(sigma).reshape(1)
    for layer in net.backbone.layers:
        h = _layer(layer, h, embed)
    out = _vlinear(net.output_proj, _group_norm_cf(h, net.output_norm_groups))
    return sched.c_skip(sigma) * x + sched.c_out(sigma) * out


def ref_denoise(model, sigma, x: torch.Tensor) -> torch.Tensor:
    """``ref_denoise_single`` vmapped over the batch ``x [B, N, D]``;
    ``sigma`` a scalar or [B]."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).expand(x.shape[:1])
    return vmap(lambda s, xi: ref_denoise_single(model, s, xi))(sigma, x.float())


@torch.no_grad()
def ref_sample_from(model, latent: torch.Tensor, n_solver_steps: int = 128) -> torch.Tensor:
    """Heun over the Karras grid, every transition two evaluations, from
    the diffusion-space state ``latent [B, N, D]`` at sigma_max (each
    example's own draw times sigma_max), to data space."""
    sigmas = model.schedule.solver_grid(n_solver_steps, latent.device).float()
    x = latent.float()
    for s_cur, s_next in zip(sigmas[:-1], sigmas[1:]):
        d = (x - ref_denoise(model, s_cur, x)) / s_cur
        x_e = x + (s_next - s_cur) * d
        d2 = (x_e - ref_denoise(model, s_next, x_e)) / s_next
        x = x + (s_next - s_cur) * 0.5 * (d + d2)
    return model.reparam.diffusion_to_data(x, None)


def ref_sample(model, generator: torch.Generator, shape: tuple,
               n_solver_steps: int = 128) -> torch.Tensor:
    """``ref_sample_from`` a latent drawn example by example from
    ``generator`` (on its device), moved to the model's device."""
    device = next(model.parameters()).device
    sigma_max = model.schedule.solver_grid(n_solver_steps, device)[0].float()
    latent = torch.stack([
        torch.randn(tuple(shape[1:]), generator=generator, device=generator.device)
        for _ in range(shape[0])]).to(device)
    return ref_sample_from(model, sigma_max * latent, n_solver_steps)
