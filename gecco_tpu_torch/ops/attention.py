"""Plain rectangular multi-head attention (counterpart of
``gecco_tpu.ops.attention.rect_attention`` with ``impl="xla"``).

The set transformer's plain path (``attn_impl="xla"``) runs on it; it is the
module-level reference that the fused kernel path is checked against.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rect_attention"]


def rect_attention(
    q: torch.Tensor,  # [B, H, M, D]
    k: torch.Tensor,  # [B, H, N, D]
    v: torch.Tensor,  # [B, H, N, D]
) -> torch.Tensor:  # [B, H, M, D]
    """Unmasked scaled dot-product attention: fp32 logits and softmax, the
    output in v's dtype (products of the working dtype summed in fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    logits = logits - logits.amax(-1, keepdim=True)
    w = torch.exp(logits)
    w = w / w.sum(-1, keepdim=True)
    out = torch.einsum("bhmn,bhnd->bhmd", w.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
