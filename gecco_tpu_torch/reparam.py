"""Data <-> diffusion space maps (counterpart of ``gecco_tpu/reparam.py``:
``Reparam``, ``GaussianReparam`` and ``UVLReparam``). The statistics are
buffers, so they take no gradient (the JAX package's ``stop_gradient``).
The log-det-Jacobians belong to the likelihood and are not ported yet."""

from __future__ import annotations

import torch
from torch import nn

from gecco_tpu_torch.geometry import project_points, unproject_points
from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["Reparam", "GaussianReparam", "UVLReparam"]


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


class UVLReparam(Reparam):
    """Camera-frustum reparameterisation: xyz -> (h, w) image coordinates
    in [0, 1]^2 and the distance d from the camera -> (arctanh, arctanh,
    log) -> normalised by ``uvl_mean``/``uvl_std``. ``ctx`` is anything with
    the camera matrices ``K [B, 3, 3]`` (the raw ``Context3d`` on the way in,
    the conditioner's output on the way out)."""

    def __init__(self, uvl_mean=(1.1159e-03, -3.6975e-03, 1.3792e00),
                 uvl_std=(0.5989, 0.6476, 1.0569), logit_scale: float = 1.1, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.logit_scale = logit_scale
        self.register_buffer("uvl_mean", torch.as_tensor(uvl_mean, dtype=torch.float32).to(dev))
        self.register_buffer("uvl_std", torch.as_tensor(uvl_std, dtype=torch.float32).to(dev))

    def _real_to_01(self, r):
        return (torch.tanh(r) * self.logit_scale + 1.0) / 2

    def _01_to_real(self, s):
        return torch.atanh((2 * s - 1.0) / self.logit_scale)

    def xyz_to_hwd(self, xyz, K):
        hw = project_points(xyz, K[..., None, :, :]).flip(-1)
        d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
        return torch.cat([hw, d], dim=-1)

    def hwd_to_xyz(self, hwd, K):
        return unproject_points(hwd[..., :2].flip(-1), hwd[..., 2], K[..., None, :, :])

    def hwd_to_uvl(self, hwd):
        uvl = torch.stack([self._01_to_real(hwd[..., 0]), self._01_to_real(hwd[..., 1]),
                           torch.log(hwd[..., 2])], dim=-1)
        return (uvl - self.uvl_mean) / self.uvl_std

    def uvl_to_hwd(self, uvl_norm):
        uvl = uvl_norm * self.uvl_std + self.uvl_mean
        return torch.stack([self._real_to_01(uvl[..., 0]), self._real_to_01(uvl[..., 1]),
                            torch.exp(uvl[..., 2])], dim=-1)

    def data_to_diffusion(self, data, ctx=None):
        return self.hwd_to_uvl(self.xyz_to_hwd(data, ctx.K))

    def diffusion_to_data(self, diff, ctx=None):
        return self.hwd_to_xyz(self.uvl_to_hwd(diff), ctx.K)

    def diffusion_to_hw(self, diff, K=None):
        """uvl -> (h, w) in [0, 1]^2 (``K`` unused: the frustum coordinates
        are image coordinates already)."""
        return self.uvl_to_hwd(diff)[..., :2]
