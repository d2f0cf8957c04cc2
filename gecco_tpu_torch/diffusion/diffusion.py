"""EDM diffusion model: preconditioned denoiser, the denoising loss, the
deterministic sampler and the inducer-cache upsampler (counterpart of
``gecco_tpu/diffusion/diffusion.py``: ``NoCond``, ``mse``,
``Diffusion.denoise``, ``Diffusion.loss``, ``Diffusion.sample`` and
``Diffusion.upsample``). The conditioner runs once per batch: in the loss,
and once per ``sample`` or ``upsample`` call, its output shared by every
solver step.

The JAX loss draws sigma and the noise from a key inside the function; here
the draw (``draw_sigma_noise``, from a ``torch.Generator``) and the loss from
a given sigma and noise (``loss_from``) are two steps, so that a test can
feed the port the numbers that ``jax.random`` drew. ``upsample`` likewise
takes its normal draws through one seam, ``upsample_from``'s ``normal``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from gecco_tpu_torch.diffusion.samplers import churn_gamma, heun_sampler, heun_step
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

    def denoise(self, sigma, x: torch.Tensor, ctx: Any = None, hs: Optional[torch.Tensor] = None,
                return_h: bool = False):
        """D(x; sigma) with EDM pre/post-conditioning; ``sigma`` scalar or [B].
        ``return_h=True`` also returns the network's inducer tokens, and
        ``hs`` reuses them (the network's pool side skipped).
        Differentiable: the sampling entry points turn autograd off."""
        sig = self._broadcast_sigma(sigma, x)
        s = self.schedule
        out = self.network(s.c_noise(sig), s.c_in(sig)[:, None, None] * x, ctx, hs=hs,
                           return_h=return_h)
        f, *stored = out if return_h else (out,)
        x_hat = s.c_skip(sig)[:, None, None] * x + s.c_out(sig)[:, None, None] * f
        return (x_hat, *stored) if return_h else x_hat

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

    @torch.no_grad()
    def upsample(self, generator: torch.Generator, data: torch.Tensor, n_new: int,
                 raw_ctx: Any = None, ctx: Any = None, n_substeps: int = 5, s_churn: float = 0.5,
                 s_noise: float = 1.0) -> torch.Tensor:
        """Inducer-cache upsampler: ``n_new`` new points [B, n_new, D] (data
        space) for the existing clouds ``data`` [B, M, D]. Over the extended
        grid, at each noise level the existing cloud is re-noised and run
        through the whole network once for every layer's inducer tokens;
        the new points then take ``n_substeps`` churned Heun steps against
        the cached tokens (only the unpool side of each layer), re-noised
        back up between substeps but on the last level, whose steps are
        Euler only. The normal draws come from ``generator`` (on its
        device) and are moved to the model's device."""
        device = data.device

        def normal(shape):
            return torch.randn(shape, generator=generator, device=generator.device).to(device)

        return self.upsample_from(data, n_new, normal, raw_ctx, ctx, n_substeps, s_churn, s_noise)

    @torch.no_grad()
    def upsample_from(self, data: torch.Tensor, n_new: int,
                      normal: Callable[[tuple], torch.Tensor], raw_ctx: Any = None,
                      ctx: Any = None, n_substeps: int = 5, s_churn: float = 0.5,
                      s_noise: float = 1.0) -> torch.Tensor:
        """``upsample`` with every standard normal draw taken from
        ``normal(shape)``, in the JAX loop's order: the initial state; then
        per transition the cache refresh's noise of ``data``'s shape, and
        per substep the churn's (where the churn rate is positive) and the
        re-noising's (where it applies), both of the state's shape. The
        state holds ``n_new`` rounded up to a multiple of 128 points (the
        points are exchangeable; the extra ones are dropped at the end)."""
        if (ctx is not None) and (raw_ctx is not None):
            raise ValueError("Both `ctx` and `raw_ctx` were provided.")
        check_points(data, "data")
        if ctx is None:
            ctx = self.cond(raw_ctx)
        data_diff = self.reparam.data_to_diffusion(data, ctx)
        sigmas = self.schedule.extended_solver_grid(device=data.device)
        n_transitions = sigmas.shape[0] - 1
        gamma = churn_gamma(s_churn, n_transitions)
        b, _, d = data.shape
        n_gen = -(-n_new // 128) * 128
        x = sigmas[0] * normal((b, n_gen, d))
        for t in range(n_transitions):
            s_cur, s_next = sigmas[t], sigmas[t + 1]
            last = t == n_transitions - 1
            # refresh the cache at this noise level
            noisy_data = data_diff + s_cur * normal(tuple(data_diff.shape))
            _, cache = self.denoise(s_cur, noisy_data, ctx, return_h=True)

            def cached_denoise(sigma, x_):
                return self.denoise(sigma, x_, ctx, hs=cache)

            for j in range(n_substeps):
                churn = normal(tuple(x.shape)) if gamma > 0.0 else None
                x = heun_step(cached_denoise, x, s_cur, s_next, gamma, s_noise, churn,
                              second_order=not last)
                if j < n_substeps - 1 and not last:
                    std = torch.sqrt(torch.clamp(s_cur**2 - s_next**2, min=0.0))
                    x = x + std * normal(tuple(x.shape))
        return self.reparam.diffusion_to_data(x[:, :n_new], ctx)
