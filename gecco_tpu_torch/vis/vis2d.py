"""2-D diffusion visualisations for toy data and trajectory debugging
(counterpart of ``gecco_tpu/vis/vis2d.py``): trajectory plots, sample
scatter figures, denoising figures over noise levels and a likelihood
heatmap, logged as matplotlib figures.

Each callback draws from a generator on the model's device seeded by
``seed`` (the JAX callbacks' ``PRNGKey(42)``), the same draws every call;
``latent``, ``eps`` or ``noise`` gives it the draws instead (through the
samplers' ``*_from`` entry points), as the tests give it the JAX ones.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gecco_tpu_torch.vis._common import device_of, generator, numpy, plt

__all__ = [
    "plot_trajectories_2d",
    "make_sample_figures_callback",
    "make_denoise_callback",
    "make_logp_callback",
]


def plot_trajectories_2d(trajectory, max_lines: int = 256):
    """Plot per-point diffusion trajectories ``[T, N, 2]``."""
    traj = numpy(trajectory)
    fig, ax = plt().subplots(tight_layout=True)
    n = min(traj.shape[1], max_lines)
    for i in range(n):
        ax.plot(traj[:, i, 0], traj[:, i, 1], lw=0.3, alpha=0.5, color="C0")
    ax.scatter(traj[-1, :n, 0], traj[-1, :n, 1], s=2, color="C1")
    ax.set_aspect("equal")
    return fig


def make_sample_figures_callback(n_samples: int = 4, n_points: int = 256, geom_dim: int = 2,
                                 seed: int = 42, latent: Optional[torch.Tensor] = None):
    """Scatter figures of fresh samples and their trajectories; ``latent``
    [n_samples, n_points, geom_dim] (diffusion space) replaces the draw."""

    def callback(model, logger, epoch: int):
        shape = (n_samples, n_points, geom_dim)
        if latent is None:
            details = model.sample(generator(model, seed), shape, return_details=True)
        else:
            details = model.sample_from_latent(latent.to(device_of(model)), return_details=True)
        samples = numpy(details.sample_data)
        fig, axes = plt().subplots(1, n_samples, figsize=(4 * n_samples, 4))
        for i, ax in enumerate(np.atleast_1d(axes)):
            ax.scatter(samples[i, :, 0], samples[i, :, 1], s=2)
            ax.set_aspect("equal")
        logger.add_figure("samples/scatter", figure=fig, global_step=epoch)
        traj_fig = plot_trajectories_2d(numpy(details.trajectory_data)[:, 0])
        logger.add_figure("samples/trajectories", figure=traj_fig, global_step=epoch)

    return callback


def make_logp_callback(data_points, grid_range: float = 2.0, grid_res: int = 24,
                       seed: int = 42, eps: Optional[torch.Tensor] = None):
    """Log-likelihood heatmap over a 2-D grid of one-point clouds (8 solver
    steps) with the data [N, 2] overlaid; ``eps`` [1, G, 1, 2] gives the
    Rademacher probes."""
    data_points = numpy(data_points)

    def callback(model, logger, epoch: int):
        lin = np.linspace(-grid_range, grid_range, grid_res)
        gx, gy = np.meshgrid(lin, lin)
        grid = torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], axis=-1)[:, None, :]
                                .astype(np.float32)).to(device_of(model))  # [G, 1, 2]
        if eps is None:
            logp = model.evaluate_logp(generator(model, seed), grid, n_solver_steps=8)
        else:
            logp = model.evaluate_logp_from(grid, eps.to(grid.device), n_solver_steps=8)
        logp = numpy(logp).reshape(grid_res, grid_res)
        fig, ax = plt().subplots(tight_layout=True)
        im = ax.imshow(logp, origin="lower",
                       extent=[-grid_range, grid_range, -grid_range, grid_range])
        ax.scatter(data_points[:, 0], data_points[:, 1], s=2, c="r")
        fig.colorbar(im)
        logger.add_figure("logp/heatmap", figure=fig, global_step=epoch)

    return callback


def make_denoise_callback(data_points, n_sigmas: int = 6, seed: int = 42,
                          noise: Optional[torch.Tensor] = None):
    """``denoise(x + sigma * eps)`` at ``n_sigmas`` noise levels against the
    ground truth [N, D]; ``noise`` [n_sigmas, 1, N, D] gives eps per level
    (else one draw per level, in order)."""
    data_points = numpy(data_points)

    @torch.no_grad()
    def callback(model, logger, epoch: int):
        sigmas = np.geomspace(model.schedule.sigma_min * 10, model.schedule.sigma_max, n_sigmas)
        device = device_of(model)
        x = torch.from_numpy(data_points[None]).to(device)
        gen = generator(model, seed) if noise is None else None
        fig, axes = plt().subplots(1, n_sigmas, figsize=(3 * n_sigmas, 3))
        axes = np.atleast_1d(axes)
        for q, (ax, sigma) in enumerate(zip(axes, sigmas)):
            eps = (torch.randn(x.shape, generator=gen, device=gen.device) if noise is None
                   else noise[q]).to(device, x.dtype)
            denoised = numpy(model.denoise(torch.full((1,), float(sigma), device=device),
                                           x + float(sigma) * eps))[0]
            ax.scatter(data_points[:, 0], data_points[:, 1], s=2, c="g", label="gt")
            ax.scatter(denoised[:, 0], denoised[:, 1], s=2, c="r", label="denoised")
            ax.set_title(f"sigma={sigma:.2f}")
            ax.set_aspect("equal")
        axes[0].legend()
        logger.add_figure("denoising", figure=fig, global_step=epoch)

    return callback
