"""Input embeddings (counterpart of ``gecco_tpu/models/embed.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gecco_tpu_torch.utils.modules import Linear, resolve_device

__all__ = ["LinearSpaceEmbedding", "LinearTimeEmbedding"]

# a space embedding is a Linear over the last (xyz) axis
LinearSpaceEmbedding = Linear


class LinearTimeEmbedding(nn.Module):
    """``t -> t * w`` with ``w [E]`` drawn as 0.1 N(0, 1)."""

    def __init__(self, dim: int, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weights = nn.Parameter(
            (0.1 * torch.randn(dim, generator=generator)).to(resolve_device(device)))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        # t: [...] -> [..., E]
        return t[..., None] * self.weights.to(t.dtype)
