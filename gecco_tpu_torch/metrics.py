"""Set-to-set distances for the generative benchmark (counterpart of
``gecco_tpu/metrics.py``'s Chamfer distances)."""

from __future__ import annotations

import torch

from gecco_tpu_torch.geometry import distance_matrix

__all__ = ["chamfer_distance", "chamfer_distance_squared"]


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """Symmetric Chamfer distance, ``[..., N, D] x [..., M, D] -> [...]``:
    the mean of the two directions' mean nearest-neighbour distances."""
    dist_m = distance_matrix(a, b, squared=squared)
    min_a = dist_m.amin(dim=-2).mean(dim=-1)
    min_b = dist_m.amin(dim=-1).mean(dim=-1)
    return (min_a + min_b) / 2


def chamfer_distance_squared(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return chamfer_distance(a, b, squared=True)
