"""Rectangular multi-head attention (counterpart of
``gecco_tpu/ops/attention.py``).

``rect_attention``: ``impl="xla"`` is the plain function: the set
transformer's plain path (``attn_impl="xla"``) runs on it, and it is the
module-level reference that the kernel paths are checked against.
``impl="pallas"`` (the JAX package's name) routes to the per-head attention
kernels (``ops/kernels/induced_attention.py``), as the set transformer's
``attn_impl="pallas"`` does.

``pool_attention_folded`` / ``unpool_attention_folded``: the same two
attentions with the head projections folded into full-width products
against the (few) inducers, the modules' ``attn_impl="folded"`` (plain
PyTorch, ``impl="xla"``) and ``"folded_pallas"`` (``impl="pallas"``: the
resident pool kernel without its pre-norm, ``folded_pool_layer``, and the
unpool kernel with neither pre-norm nor residual). The same function as the
per-head form, the same weights.
"""

from __future__ import annotations

import math

import torch

from gecco_tpu_torch.ops.kernels.folded_attention import (
    folded_pool_layer,
    folded_unpool,
    group_indicator,
)
from gecco_tpu_torch.ops.kernels.induced_attention import rect_attention_pallas

__all__ = ["rect_attention", "pool_attention_folded", "unpool_attention_folded"]


def rect_attention(
    q: torch.Tensor,  # [B, H, M, D]
    k: torch.Tensor,  # [B, H, N, D]
    v: torch.Tensor,  # [B, H, N, D]
    impl: str = "xla",
) -> torch.Tensor:  # [B, H, M, D]
    """Unmasked scaled dot-product attention: fp32 logits and softmax, the
    output in v's dtype (products of the working dtype summed in fp32)."""
    _check_impl(impl)
    if impl == "pallas":
        return rect_attention_pallas(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    w = _softmax_fp32(torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale, -1)
    out = torch.einsum("bhmn,bhnd->bhmd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def _softmax_fp32(logits: torch.Tensor, dim: int) -> torch.Tensor:
    logits = logits.float()
    w = torch.exp(logits - logits.amax(dim, keepdim=True))
    return w / w.sum(dim, keepdim=True)


def _check_impl(impl: str) -> None:
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")


def _fold_unpool_operands(h, q_weight, k_weight, v_weight, out_weight, num_heads: int, dt):
    """The q/out projections folded against the inducer tokens' keys and
    values: k_folded [B, C, J] and v_folded [B, J, C], J = H*I."""
    b, i, c = h.shape
    d = c // num_heads
    wq = q_weight.to(dt).float().reshape(num_heads, d, c)
    wo = out_weight.to(dt).float().reshape(c, num_heads, d)
    k = (h @ k_weight.to(dt).T).float().reshape(b, i, num_heads, d)
    v = (h @ v_weight.to(dt).T).float().reshape(b, i, num_heads, d)
    k_folded = (1.0 / math.sqrt(d)) * torch.einsum("hdc,bihd->bchi", wq, k)
    v_folded = torch.einsum("bihd,chd->bhic", v, wo)
    return (k_folded.to(dt).reshape(b, c, num_heads * i),
            v_folded.to(dt).reshape(b, num_heads * i, c))


def _fold_pool_operands(inducers, kv_weight, num_heads: int, dt):
    """The k projection folded against the inducer queries [H, I, D]:
    q_folded [C, J] and the value weight transposed [C, C]."""
    _, i, d = inducers.shape
    c = kv_weight.shape[1]
    wk = kv_weight[:c].float().reshape(num_heads, d, c)
    q_folded = (1.0 / math.sqrt(d)) * torch.einsum("hdc,hid->chi", wk, inducers.float())
    return q_folded.reshape(c, num_heads * i).to(dt), kv_weight[c:].to(dt).T


def unpool_attention_folded(
    x: torch.Tensor,  # [B, N, C] queries (points)
    h: torch.Tensor,  # [B, I, C] keys/values (inducer tokens)
    q_weight: torch.Tensor,  # [C, C], out = in @ W^T
    k_weight: torch.Tensor,
    v_weight: torch.Tensor,
    out_weight: torch.Tensor,
    num_heads: int,
    impl: str = "xla",
) -> torch.Tensor:  # [B, N, C]
    """Multi-head attention of the points to the inducer tokens through
    the folded operands; ``impl="pallas"``: the unpool kernel, without its
    pre-norm and residual."""
    _check_impl(impl)
    b, n, c = x.shape
    i = h.shape[1]
    dt = x.dtype
    if impl == "pallas":
        ones = torch.ones((b, c), dtype=torch.float32, device=x.device)
        out, _ = folded_unpool(x, ones, torch.zeros_like(ones), h @ k_weight.to(dt).T,
                               h @ v_weight.to(dt).T, q_weight.to(dt), out_weight.to(dt),
                               num_heads, False, False)
        return out
    k_folded, v_folded = _fold_unpool_operands(h, q_weight, k_weight, v_weight, out_weight,
                                               num_heads, dt)
    logits = torch.einsum("bnc,bcj->bnj", x.float(), k_folded.float())
    p = _softmax_fp32(logits.reshape(b, n, num_heads, i), -1)
    return torch.einsum("bnj,bjc->bnc", p.reshape(b, n, num_heads * i).to(dt).float(),
                        v_folded.float()).to(dt)


def pool_attention_folded(
    x: torch.Tensor,  # [B, N, C] keys/values (points)
    inducers: torch.Tensor,  # [H, I, D] queries
    kv_weight: torch.Tensor,  # [2C, C] the fused k/v projection
    out_weight: torch.Tensor,  # [C, C]
    num_heads: int,
    impl: str = "xla",
) -> torch.Tensor:  # [B, I, C]
    """Multi-head attention of the inducer queries to the points (softmax
    over the points) through the folded operands; ``impl="pallas"``: the
    resident pool kernel without its pre-norm. The kernel takes every shape
    its own limits allow and raises on others; it never falls back to the
    plain path."""
    _check_impl(impl)
    b, n, c = x.shape
    _, i, d = inducers.shape
    dt = x.dtype
    if impl == "pallas":
        ones = torch.ones((b, c), dtype=torch.float32, device=x.device)
        h0, _, _ = folded_pool_layer(
            x, ones, torch.zeros_like(ones), inducers.reshape(num_heads * i, d).to(dt),
            kv_weight.to(dt), out_weight.to(dt), group_indicator(c, 32, x.device), num_heads,
            False,
        )
        return h0
    q_folded, wv_t = _fold_pool_operands(inducers, kv_weight, num_heads, dt)
    logits = torch.einsum("bnc,cj->bnj", x.float(), q_folded.float())
    p = _softmax_fp32(logits.reshape(b, n, num_heads, i), 1)
    v = (x @ wv_t).reshape(b, n, num_heads, d)
    pooled = torch.einsum("bnhi,bnhd->bihd", p.to(dt).float(), v.float()).to(dt)
    return pooled.reshape(b, i, c) @ out_weight.to(dt).T
