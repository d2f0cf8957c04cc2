"""Deterministic Heun sampler (counterpart of
``gecco_tpu/diffusion/samplers.py``: ``heun_step`` with churn 0 and
``heun_sampler`` with ``heun_on_last=True``).

The JAX package scans over the sigma grid; here it is a Python loop over
0-d fp32 tensors on the state's device, so no step waits for the host.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["heun_step", "heun_sampler"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (sigma, x) -> x_hat


def heun_step(denoise_fn: DenoiseFn, x: torch.Tensor, s_cur: torch.Tensor,
              s_next: torch.Tensor) -> torch.Tensor:
    """One second-order EDM transition s_cur -> s_next (no churn)."""
    d_cur = (x - denoise_fn(s_cur, x)) / s_cur
    x_euler = x + (s_next - s_cur) * d_cur
    d_prime = (x_euler - denoise_fn(s_next, x_euler)) / s_next
    return x + (s_next - s_cur) * (0.5 * d_cur + 0.5 * d_prime)


def heun_sampler(denoise_fn: DenoiseFn, sigmas: torch.Tensor, x_init: torch.Tensor,
                 save_trajectory: bool = False):
    """Probability-flow ODE over the fixed grid ``sigmas`` [T]: T-1
    transitions, each second order, so 2(T-1) denoiser calls.
    Returns ``(x_final, trajectory [T-1, B, N, D] or None)``."""
    x = x_init
    traj = []
    for t in range(sigmas.shape[0] - 1):
        x = heun_step(denoise_fn, x, sigmas[t], sigmas[t + 1])
        if save_trajectory:
            traj.append(x)
    return x, (torch.stack(traj) if save_trajectory else None)
