"""EDM diffusion model: preconditioned denoiser and the deterministic
sampler (counterpart of ``gecco_tpu/diffusion/diffusion.py``: ``NoCond``,
``Diffusion.denoise`` and ``Diffusion.sample``; inference only).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from gecco_tpu_torch.diffusion.samplers import heun_sampler
from gecco_tpu_torch.diffusion.schedule import Schedule
from gecco_tpu_torch.reparam import Reparam
from gecco_tpu_torch.types import SampleDetails
from gecco_tpu_torch.utils.checks import check_points, check_sigma_batch

__all__ = ["Diffusion", "NoCond"]


class NoCond(nn.Module):
    """Identity conditioner for unconditional models."""

    def forward(self, raw_ctx):
        return raw_ctx


class Diffusion(nn.Module):
    def __init__(self, network: nn.Module, schedule: Schedule,
                 reparam: Optional[Reparam] = None, cond: Optional[nn.Module] = None):
        super().__init__()
        self.network = network
        self.cond = cond if cond is not None else NoCond()
        self.reparam = reparam if reparam is not None else Reparam()
        self.schedule = schedule

    def _broadcast_sigma(self, sigma, x):
        check_points(x, "x")
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        check_sigma_batch(sigma, x.shape[0])
        return sigma.expand(x.shape[:1])  # [B]

    @torch.no_grad()
    def denoise(self, sigma, x: torch.Tensor, ctx: Any = None) -> torch.Tensor:
        """D(x; sigma) with EDM pre/post-conditioning; ``sigma`` scalar or [B]."""
        sig = self._broadcast_sigma(sigma, x)
        s = self.schedule
        out = self.network(s.c_noise(sig), s.c_in(sig)[:, None, None] * x, ctx)
        return s.c_skip(sig)[:, None, None] * x + s.c_out(sig)[:, None, None] * out

    def sample(self, generator: torch.Generator, shape: tuple, raw_ctx: Any = None,
               ctx: Any = None, n_solver_steps: Optional[int] = None,
               return_details: bool = False):
        """Deterministic Heun probability-flow sampler over the Karras grid:
        the latent is drawn from ``generator`` (on its device) and moved to
        the model's device."""
        if len(shape) != 3:
            raise ValueError(f"shape must be (B, N, D), got {shape}")
        device = next(self.network.parameters()).device
        latent = self.schedule.sample_latent(generator, shape, device)
        return self.sample_from_latent(latent, raw_ctx, ctx, n_solver_steps, return_details)

    @torch.no_grad()
    def sample_from_latent(self, latent: torch.Tensor, raw_ctx: Any = None, ctx: Any = None,
                           n_solver_steps: Optional[int] = None, return_details: bool = False):
        """``sample`` from a given latent [B, N, D] in diffusion space."""
        if (ctx is not None) and (raw_ctx is not None):
            raise ValueError("Both `ctx` and `raw_ctx` were provided.")
        check_points(latent, "latent")
        if ctx is None:
            ctx = self.cond(raw_ctx)
        sigmas = self.schedule.solver_grid(n_solver_steps, device=latent.device)
        x_final, traj = heun_sampler(
            lambda sigma, x: self.denoise(sigma, x, ctx), sigmas, latent,
            save_trajectory=return_details,
        )
        sample_data = self.reparam.diffusion_to_data(x_final, ctx)
        if not return_details:
            return sample_data
        return SampleDetails(
            latent=latent,
            sample_diff=x_final,
            sample_data=sample_data,
            trajectory_diff=traj,
            trajectory_data=self.reparam.diffusion_to_data(traj, ctx),
        )
