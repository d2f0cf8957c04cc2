"""EDM diffusion model: preconditioned denoiser and score, the denoising
loss, the samplers (deterministic, stochastic, inpainting), the
inducer-cache upsampler and the exact likelihood (counterpart of
``gecco_tpu/diffusion/diffusion.py``: ``NoCond``, ``mse`` and
``Diffusion``). The conditioner runs once per batch: in the loss, and once
per sampler, upsampler or likelihood call, its output shared by every
solver step.

The JAX package draws from a key inside each function; here the draw and
the computation from given draws are two steps, so that a test can feed the
port the numbers that ``jax.random`` drew: ``draw_sigma_noise`` and
``loss_from``; ``sample_from_latent``; ``sample_stochastic_from``,
``sample_inpaint_from`` and ``upsample_from``, which take every standard
normal draw through one seam, ``normal(shape)``; ``evaluate_logp_from``,
which takes the Rademacher probes. The loss's draws of dropout masks (the
JAX package's network key) go through ``loss_from``'s ``dropout`` seam.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from gecco_tpu_torch.diffusion.samplers import (
    NormalFn,
    churn_gamma,
    heun_sampler,
    heun_step,
    inpaint_sampler,
)
from gecco_tpu_torch.diffusion.schedule import Schedule
from gecco_tpu_torch.models.mlp import DropoutFn, bernoulli_dropout, shard_dropout
from gecco_tpu_torch.reparam import Reparam
from gecco_tpu_torch.types import LogpDetails, SampleDetails
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
    """``divergence_fn(x_hat, x) -> [B]`` is the loss's per-example
    divergence (``mse`` where None)."""

    def __init__(self, network: nn.Module, schedule: Schedule,
                 reparam: Optional[Reparam] = None, cond: Optional[nn.Module] = None,
                 divergence_fn: Optional[Callable] = None):
        super().__init__()
        self.network = network
        self.cond = cond if cond is not None else NoCond()
        self.reparam = reparam if reparam is not None else Reparam()
        self.schedule = schedule
        self.divergence_fn = divergence_fn

    def _broadcast_sigma(self, sigma, x):
        check_points(x, "x")
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        check_sigma_batch(sigma, x.shape[0])
        return sigma.expand(x.shape[:1])  # [B]

    def denoise(self, sigma, x: torch.Tensor, ctx: Any = None, hs: Optional[torch.Tensor] = None,
                return_h: bool = False, dropout: Optional[DropoutFn] = None):
        """D(x; sigma) with EDM pre/post-conditioning; ``sigma`` scalar or [B].
        ``return_h=True`` also returns the network's inducer tokens, and
        ``hs`` reuses them (the network's pool side skipped). ``dropout``:
        the network's dropout masks (None: deterministic, as everywhere but
        the loss). Differentiable: the sampling entry points turn autograd
        off."""
        sig = self._broadcast_sigma(sigma, x)
        s = self.schedule
        # a network without dropout need not take the argument
        kw = {} if dropout is None else {"dropout": dropout}
        out = self.network(s.c_noise(sig), s.c_in(sig)[:, None, None] * x, ctx, hs=hs,
                           return_h=return_h, **kw)
        f, *stored = out if return_h else (out,)
        x_hat = s.c_skip(sig)[:, None, None] * x + s.c_out(sig)[:, None, None] * f
        return (x_hat, *stored) if return_h else x_hat

    def score(self, sigma, x: torch.Tensor, ctx: Any = None) -> torch.Tensor:
        """The (unnormalised) score direction x - D(x; sigma)."""
        return x - self.denoise(sigma, x, ctx)

    def _device(self) -> torch.device:
        """The network's device (the CPU for a network without parameters)."""
        p = next(self.network.parameters(), None)
        return torch.device("cpu") if p is None else p.device

    def _normal(self, generator: torch.Generator) -> NormalFn:
        """Standard normal draws from ``generator`` (on its device), moved
        to the model's device."""
        device = self._device()
        return lambda shape: torch.randn(shape, generator=generator,
                                         device=generator.device).to(device)

    def _context(self, raw_ctx: Any, ctx: Any, n: int = 1) -> Any:
        """The conditioner's output on ``raw_ctx`` (or the given ``ctx``),
        tiled ``n`` times."""
        if (ctx is not None) and (raw_ctx is not None):
            raise ValueError("Both `ctx` and `raw_ctx` were provided.")
        return _tile_ctx(self.cond(raw_ctx) if ctx is None else ctx, n)

    def draw_sigma_noise(self, generator: torch.Generator, points: torch.Tensor,
                         shard: Tuple[int, int] = (0, 1),
                         point_shard: Tuple[int, int] = (0, 1)):
        """The loss's random draws for a batch ``points`` [B, N, D]: sigma [B]
        from the schedule and standard normal noise of the points' shape,
        both made on the generator's device and moved to the points'.

        ``shard=(rank, world)``: ``points`` are a rank's B rows of a global
        batch of ``world * B``; ``point_shard=(index, count)``: they hold
        slice ``index`` of ``count`` of each cloud's points. The draws are
        made for the global batch at every point, as one process training
        on all of it makes them, and the rank's rows and points returned."""
        check_points(points, "points")
        rank, world = shard
        index, count = point_shard
        b, n = points.shape[:2]
        sigma = self.schedule.sample_sigma(generator, b * world)
        noise = torch.randn((b * world, n * count, *points.shape[2:]), generator=generator,
                            device=generator.device)
        rows = slice(rank * b, (rank + 1) * b)
        return (sigma[rows].to(points.device, points.dtype),
                noise[rows, index * n:(index + 1) * n].to(points.device, points.dtype))

    def loss_from(self, points: torch.Tensor, sigma: torch.Tensor, noise: torch.Tensor,
                  raw_ctx: Any = None, loss_scale: float = 1.0,
                  dropout: Optional[DropoutFn] = None) -> torch.Tensor:
        """Denoising score-matching loss of data-space ``points`` [B, N, D]
        at the given ``sigma`` [B] and ``noise`` [B, N, D]: the mean over the
        batch of ``lambda(sigma) * divergence(D(x + sigma * noise; sigma),
        x)``, the network's dropout masks from ``dropout`` (None: none)."""
        check_points(points, "points")
        x = self.reparam.data_to_diffusion(points, raw_ctx)
        ctx = self.cond(raw_ctx)
        x_hat = self.denoise(sigma, x + sigma[:, None, None] * noise, ctx, dropout=dropout)
        weight = self.schedule.loss_weight(sigma)
        div_fn = self.divergence_fn if self.divergence_fn is not None else mse
        return loss_scale * torch.mean(weight * div_fn(x_hat, x))

    def loss(self, points: torch.Tensor, generator: torch.Generator, raw_ctx: Any = None,
             loss_scale: float = 1.0, train_in_inference_mode: bool = False) -> torch.Tensor:
        """``loss_from`` at sigma and noise drawn from ``generator``, then the
        dropout masks (``train_in_inference_mode=True``: no dropout, the JAX
        package's withheld network key)."""
        sigma, noise = self.draw_sigma_noise(generator, points)
        dropout = None if train_in_inference_mode else self.dropout_masks(generator)
        return self.loss_from(points, sigma, noise, raw_ctx, loss_scale, dropout)

    def dropout_masks(self, generator: torch.Generator,
                      shard: Tuple[int, int] = (0, 1)) -> Optional[DropoutFn]:
        """The network's dropout masks drawn from ``generator``, or None
        where no module of the network drops units (``dropout_p > 0``): a
        network without dropout is called as before, without the
        argument. ``shard=(rank, world)``: each mask is drawn for the global
        batch and the rank's rows kept, as in ``draw_sigma_noise``; under
        point sharding the layers keep the rank's points of the masks with
        a point axis (``models.mlp.shard_point_dropout``)."""
        if any(getattr(m, "dropout_p", 0.0) > 0.0 for m in self.network.modules()):
            return shard_dropout(bernoulli_dropout(generator), *shard)
        return None

    @torch.no_grad()
    def sample(self, generator: torch.Generator, shape: tuple, raw_ctx: Any = None,
               ctx: Any = None, n_solver_steps: Optional[int] = None, temperature: float = 1.0,
               return_details: bool = False, n: int = 1):
        """Deterministic Heun probability-flow sampler over the Karras grid:
        the latent is drawn from ``generator`` (on its device), scaled by
        ``temperature`` and moved to the model's device. The conditioner
        runs once on ``raw_ctx`` (or ``ctx`` is its output); ``n > 1`` draws
        n samples per context, so ``shape[0]`` is the context's batch times
        n."""
        if len(shape) != 3:
            raise ValueError(f"shape must be (B, N, D), got {shape}")
        latent = temperature * self.schedule.sample_latent(generator, shape, self._device())
        return self.sample_from_latent(latent, raw_ctx, ctx, n_solver_steps, return_details, n)

    @torch.no_grad()
    def sample_from_latent(self, latent: torch.Tensor, raw_ctx: Any = None, ctx: Any = None,
                           n_solver_steps: Optional[int] = None, return_details: bool = False,
                           n: int = 1):
        """``sample`` from a given latent [B, N, D] in diffusion space."""
        check_points(latent, "latent")
        ctx = self._context(raw_ctx, ctx, n)
        sigmas = self.schedule.solver_grid(n_solver_steps, device=latent.device)
        x_final, traj = heun_sampler(
            lambda sigma, x: self.denoise(sigma, x, ctx), sigmas, latent,
            heun_on_last=True, save_trajectory=return_details,
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
    def sample_stochastic(self, generator: torch.Generator, shape: tuple, raw_ctx: Any = None,
                          ctx: Any = None, s_churn: float = 0.0, s_noise: float = 1.0,
                          n_solver_steps: Optional[int] = None, n: int = 1) -> torch.Tensor:
        """EDM stochastic sampler: churned Heun steps over the extended grid
        ``[t_0 .. t_N]``, the last transition Euler only. The draws come
        from ``generator`` (on its device) and are moved to the model's
        device; ``n > 1`` draws n samples per context."""
        return self.sample_stochastic_from(self._normal(generator), shape, raw_ctx, ctx, s_churn,
                                           s_noise, n_solver_steps, n)

    @torch.no_grad()
    def sample_stochastic_from(self, normal: NormalFn, shape: tuple, raw_ctx: Any = None,
                               ctx: Any = None, s_churn: float = 0.0, s_noise: float = 1.0,
                               n_solver_steps: Optional[int] = None, n: int = 1) -> torch.Tensor:
        """``sample_stochastic`` with every standard normal draw taken from
        ``normal(shape)``, in the JAX loop's order: the initial state, then
        per transition the churn's (where the churn rate is positive)."""
        if len(shape) != 3:
            raise ValueError(f"shape must be (B, N, D), got {shape}")
        ctx = self._context(raw_ctx, ctx, n)
        sigmas = self.schedule.extended_solver_grid(n_solver_steps, self._device())
        x_init = sigmas[0] * normal(tuple(shape))
        x_final, _ = heun_sampler(lambda sigma, x: self.denoise(sigma, x, ctx), sigmas, x_init,
                                  normal, s_churn, s_noise, heun_on_last=False)
        return self.reparam.diffusion_to_data(x_final, ctx)

    @torch.no_grad()
    def sample_inpaint(self, generator: torch.Generator, known: torch.Tensor, m_to_inpaint: int,
                       raw_ctx: Any = None, ctx: Any = None, s_churn: float = 0.0,
                       s_noise: float = 1.0, n_substeps: int = 1) -> torch.Tensor:
        """Completion of the data-space clouds ``known`` [B, M, D] by
        ``m_to_inpaint`` new points [B, m_to_inpaint, D], RePaint-style
        (``inpaint_sampler``) over the extended grid. The draws come from
        ``generator`` (on its device) and are moved to the model's device."""
        return self.sample_inpaint_from(known, m_to_inpaint, self._normal(generator), raw_ctx,
                                        ctx, s_churn, s_noise, n_substeps)

    @torch.no_grad()
    def sample_inpaint_from(self, known: torch.Tensor, m_to_inpaint: int, normal: NormalFn,
                            raw_ctx: Any = None, ctx: Any = None, s_churn: float = 0.0,
                            s_noise: float = 1.0, n_substeps: int = 1) -> torch.Tensor:
        """``sample_inpaint`` with every standard normal draw taken from
        ``normal(shape)`` in ``inpaint_sampler``'s order."""
        check_points(known, "known")
        ctx = self._context(raw_ctx, ctx)
        known_diff = self.reparam.data_to_diffusion(known, ctx)
        sigmas = self.schedule.extended_solver_grid(device=known.device)
        x = inpaint_sampler(lambda sigma, x_: self.denoise(sigma, x_, ctx), sigmas, known_diff,
                            m_to_inpaint, normal, s_churn, s_noise, n_substeps)
        return self.reparam.diffusion_to_data(x, ctx)

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
        return self.upsample_from(data, n_new, self._normal(generator), raw_ctx, ctx, n_substeps,
                                  s_churn, s_noise)

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
        check_points(data, "data")
        ctx = self._context(raw_ctx, ctx)
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

    def evaluate_logp(self, generator: torch.Generator, data: torch.Tensor, raw_ctx: Any = None,
                      ctx: Any = None, n_log_det_jac_samples: int = 1,
                      n_solver_steps: Optional[int] = None, return_details: bool = False):
        """Exact log-likelihood of the data-space clouds ``data`` [B, N, D]
        (``evaluate_logp_from``), its Rademacher probes drawn from
        ``generator`` (on its device) and moved to the data's device."""
        check_points(data, "data")
        shape = (n_log_det_jac_samples, *data.shape)
        eps = torch.randint(0, 2, shape, generator=generator, device=generator.device)
        eps = (2 * eps - 1).to(data.device, data.dtype)
        return self.evaluate_logp_from(data, eps, raw_ctx, ctx, n_solver_steps, return_details)

    def evaluate_logp_from(self, data: torch.Tensor, eps: torch.Tensor, raw_ctx: Any = None,
                           ctx: Any = None, n_solver_steps: Optional[int] = None,
                           return_details: bool = False):
        """Exact log-likelihood by the reverse probability-flow ODE: Heun
        over the increasing grid ``solver_grid(n_solver_steps)[::-1]``
        carries x from the data (diffusion space) to sigma_max and the
        log-volume by the Hutchinson estimate of the flow's divergence,
        e^T J e averaged over the K probes ``eps`` [K, B, N, D] (the same
        probes at every evaluation). The divergence is a vector-Jacobian
        product, ``torch.autograd.grad`` of the field into x only: grad mode
        is on inside (so a caller's ``torch.no_grad()`` does not stop it),
        and no parameter's ``.grad`` is written. logp = the latent's log
        density under N(0, sigma_max^2) + the integrated divergence + the
        reparam's log|det|; per example [B], or ``LogpDetails`` where
        ``return_details``."""
        check_points(data, "data")
        with torch.no_grad():
            ctx = self._context(raw_ctx, ctx)
            x = self.reparam.data_to_diffusion(data, ctx)
            delta_reparam = self.reparam.ladj_data_to_diffusion(data, ctx)
        if eps.shape[1:] != x.shape:
            raise ValueError(f"eps must be [K, *{tuple(x.shape)}], got {tuple(eps.shape)}")
        sigmas = self.schedule.solver_grid(n_solver_steps, x.device).flip(0)

        def aug_field(y, sigma):
            # the field (y - D(y)) / sigma and its divergence's estimate,
            # (J^T e) . e per probe
            with torch.enable_grad():
                y = y.detach().requires_grad_(True)
                f = (y - self.denoise(sigma, y, ctx)) / sigma
                divs = [(torch.autograd.grad(f, y, e, retain_graph=q < eps.shape[0] - 1)[0]
                         * e).sum(dim=(-2, -1)) for q, e in enumerate(eps)]
            return f.detach(), torch.stack(divs).mean(dim=0)

        logv = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        traj = []
        for t in range(sigmas.shape[0] - 1):
            s_cur, s_next = sigmas[t], sigmas[t + 1]
            h = s_next - s_cur
            f1, d1 = aug_field(x, s_cur)
            f2, d2 = aug_field(x + h * f1, s_next)
            x = x + h * 0.5 * (f1 + f2)
            logv = logv + h * 0.5 * (d1 + d2)
            if return_details:
                traj.append(x)
        sigma_max = self.schedule.sigma_max
        prior_logp = (-0.5 * (x / sigma_max) ** 2 - math.log(sigma_max)
                      - 0.5 * math.log(2 * math.pi)).sum(dim=(-2, -1))
        logp = prior_logp + logv + delta_reparam
        if not return_details:
            return logp
        traj = torch.stack(traj)
        with torch.no_grad():
            traj_data = self.reparam.diffusion_to_data(traj, ctx)
        return LogpDetails(logp=logp, prior_logp=prior_logp, delta_reparam=delta_reparam,
                           delta_jacobian=logv, trajectory_diff=traj, trajectory_data=traj_data,
                           latent=x)
