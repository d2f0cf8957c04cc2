"""Data <-> diffusion space maps (counterpart of ``gecco_tpu/reparam.py``:
``Reparam`` and ``GaussianReparam``)."""

from __future__ import annotations

import torch
from torch import nn

from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["Reparam", "GaussianReparam"]


class Reparam(nn.Module):
    """Identity."""

    def data_to_diffusion(self, data, ctx=None):
        return data

    def diffusion_to_data(self, diff, ctx=None):
        return diff


class GaussianReparam(Reparam):
    """Per-axis affine normalisation ``(data - mean) / std``."""

    def __init__(self, mean, std, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32).to(dev))
        self.register_buffer("std", torch.as_tensor(std, dtype=torch.float32).to(dev))

    def data_to_diffusion(self, data, ctx=None):
        return (data - self.mean.to(data.dtype)) / self.std.to(data.dtype)

    def diffusion_to_data(self, diff, ctx=None):
        return diff * self.std.to(diff.dtype) + self.mean.to(diff.dtype)
