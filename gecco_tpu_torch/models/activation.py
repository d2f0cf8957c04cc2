"""Gaussian bump activation (counterpart of ``gecco_tpu/models/activation.py``)."""

from __future__ import annotations

import torch
from torch import nn

from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["GaussianActivation"]


class GaussianActivation(nn.Module):
    """``exp(-x^2 / (2 alpha^2))`` with a trainable scalar ``alpha``;
    ``normalized`` maps it to ``(y - 0.7) / 0.28``."""

    def __init__(self, alpha: float = 1.0, normalized: bool = False, *, device=None):
        super().__init__()
        self.alpha = nn.Parameter(
            torch.tensor(alpha, dtype=torch.float32, device=resolve_device(device))
        )
        self.normalized = normalized

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)
        y = torch.exp(-(x**2) / (2 * alpha**2))
        if self.normalized:
            y = (y - 0.7) / 0.28
        return y
