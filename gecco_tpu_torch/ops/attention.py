"""Rectangular multi-head attention (counterpart of
``gecco_tpu.ops.attention.rect_attention``).

``impl="xla"`` is the plain function: the set transformer's plain path
(``attn_impl="xla"``) runs on it, and it is the module-level reference that
the kernel paths are checked against. ``impl="pallas"`` (the JAX package's
name) routes to the per-head attention kernels
(``ops/kernels/induced_attention.py``), as the set transformer's
``attn_impl="pallas"`` does.
"""

from __future__ import annotations

import math

import torch

from gecco_tpu_torch.ops.kernels.induced_attention import rect_attention_pallas

__all__ = ["rect_attention"]


def rect_attention(
    q: torch.Tensor,  # [B, H, M, D]
    k: torch.Tensor,  # [B, H, N, D]
    v: torch.Tensor,  # [B, H, N, D]
    impl: str = "xla",
) -> torch.Tensor:  # [B, H, M, D]
    """Unmasked scaled dot-product attention: fp32 logits and softmax, the
    output in v's dtype (products of the working dtype summed in fp32)."""
    if impl == "pallas":
        return rect_attention_pallas(q, k, v)
    if impl != "xla":
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    logits = logits - logits.amax(-1, keepdim=True)
    w = torch.exp(logits)
    w = w / w.sum(-1, keepdim=True)
    out = torch.einsum("bhmn,bhnd->bhmd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
