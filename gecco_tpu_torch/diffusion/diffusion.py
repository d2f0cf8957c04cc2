"""EDM diffusion model: preconditioned denoiser, the denoising loss and
the deterministic sampler (counterpart of
``gecco_tpu/diffusion/diffusion.py``: ``NoCond``, ``mse``,
``Diffusion.denoise``, ``Diffusion.loss`` and ``Diffusion.sample``). The
conditioner runs once per batch: in the loss, and once per ``sample`` call,
its output shared by every solver step.

The JAX loss draws sigma and the noise from a key inside the function; here
the draw (``draw_sigma_noise``, from a ``torch.Generator``) and the loss from
a given sigma and noise (``loss_from``) are two steps, so that a test can
feed the port the numbers that ``jax.random`` drew.
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

__all__ = ["Diffusion", "NoCond", "mse"]


def _tile_ctx(ctx: Any, n: int) -> Any:
    """Repeat every batched tensor of ``ctx`` (a tensor, or a (named) tuple
    of them, nested) ``n`` times along the batch axis, each example's copies
    next to each other: n samples share one conditioned context."""
    if n == 1:
        return ctx
    if isinstance(ctx, torch.Tensor):
        return ctx.repeat_interleave(n, dim=0) if ctx.ndim >= 1 else ctx
    if isinstance(ctx, tuple) and hasattr(ctx, "_fields"):
        return type(ctx)(*(_tile_ctx(v, n) for v in ctx))
    if isinstance(ctx, (tuple, list)):
        return type(ctx)(_tile_ctx(v, n) for v in ctx)
    return ctx


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-example mean squared divergence: [B, N, D] x [B, N, D] -> [B]."""
    return ((a - b) ** 2).mean(dim=(-2, -1))


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

    def denoise(self, sigma, x: torch.Tensor, ctx: Any = None) -> torch.Tensor:
        """D(x; sigma) with EDM pre/post-conditioning; ``sigma`` scalar or [B].
        Differentiable: the sampling entry points turn autograd off."""
        sig = self._broadcast_sigma(sigma, x)
        s = self.schedule
        out = self.network(s.c_noise(sig), s.c_in(sig)[:, None, None] * x, ctx)
        return s.c_skip(sig)[:, None, None] * x + s.c_out(sig)[:, None, None] * out

    def draw_sigma_noise(self, generator: torch.Generator, points: torch.Tensor):
        """The loss's random draws for a batch ``points`` [B, N, D]: sigma [B]
        from the schedule and standard normal noise of the points' shape,
        both made on the generator's device and moved to the points'."""
        check_points(points, "points")
        sigma = self.schedule.sample_sigma(generator, points.shape[0])
        noise = torch.randn(points.shape, generator=generator, device=generator.device)
        return sigma.to(points.device, points.dtype), noise.to(points.device, points.dtype)

    def loss_from(self, points: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor,
                  raw_ctx: Any = None, loss_scale: float = 1.0) -> torch.Tensor:
        """Denoising score-matching loss of data-space ``points`` [B, N, D]
        at the given ``sigma`` [B] and ``noise`` [B, N, D]: the mean over the
        batch of ``lambda(sigma) * mse(D(x + sigma * noise; sigma), x)``."""
        check_points(points, "points")
        x = self.reparam.data_to_diffusion(points, raw_ctx)
        ctx = self.cond(raw_ctx)
        x_hat = self.denoise(sigma, x + sigma[:, None, None] * noise, ctx)
        weight = self.schedule.loss_weight(sigma)
        return loss_scale * torch.mean(weight * mse(x_hat, x))

    def loss(self, points: torch.Tensor, generator: torch.Generator, raw_ctx: Any = None,
             loss_scale: float = 1.0) -> torch.Tensor:
        """``loss_from`` at sigma and noise drawn from ``generator``."""
        sigma, noise = self.draw_sigma_noise(generator, points)
        return self.loss_from(points, sigma, noise, raw_ctx, loss_scale)

    @torch.no_grad()
    def sample(self, generator: torch.Generator, shape: tuple, raw_ctx: Any = None,
               ctx: Any = None, n_solver_steps: Optional[int] = None,
               return_details: bool = False, n: int = 1):
        """Deterministic Heun probability-flow sampler over the Karras grid:
        the latent is drawn from ``generator`` (on its device) and moved to
        the model's device. The conditioner runs once on ``raw_ctx`` (or
        ``ctx`` is its output); ``n > 1`` draws n samples per context, so
        ``shape[0]`` is the context's batch times n."""
        if len(shape) != 3:
            raise ValueError(f"shape must be (B, N, D), got {shape}")
        device = next(self.network.parameters()).device
        latent = self.schedule.sample_latent(generator, shape, device)
        return self.sample_from_latent(latent, raw_ctx, ctx, n_solver_steps, return_details, n)

    @torch.no_grad()
    def sample_from_latent(self, latent: torch.Tensor, raw_ctx: Any = None, ctx: Any = None,
                           n_solver_steps: Optional[int] = None, return_details: bool = False,
                           n: int = 1):
        """``sample`` from a given latent [B, N, D] in diffusion space."""
        if (ctx is not None) and (raw_ctx is not None):
            raise ValueError("Both `ctx` and `raw_ctx` were provided.")
        check_points(latent, "latent")
        if ctx is None:
            ctx = self.cond(raw_ctx)
        ctx = _tile_ctx(ctx, n)
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
