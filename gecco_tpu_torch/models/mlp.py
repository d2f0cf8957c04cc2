"""Feed-forward network over the last axis (counterpart of
``gecco_tpu/models/mlp.py`` without dropout: the flagship's MLPs have
``dropout_p == 0``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gecco_tpu_torch.models.activation import GaussianActivation
from gecco_tpu_torch.utils.modules import Linear

__all__ = ["MLP"]


class MLP(nn.Module):
    def __init__(
        self,
        in_size: int,
        out_size: int,
        width_size: int,
        depth: int = 1,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        lin = lambda i, o: Linear(i, o, device=device, generator=generator)
        if depth == 0:
            layers = [lin(in_size, out_size)]
        else:
            layers = [lin(in_size, width_size)]
            layers += [lin(width_size, width_size) for _ in range(depth - 1)]
            layers.append(lin(width_size, out_size))
        self.layers = nn.ModuleList(layers)
        self.activation = GaussianActivation(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
        return self.layers[-1](x)
