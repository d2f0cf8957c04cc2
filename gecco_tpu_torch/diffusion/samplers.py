"""EDM samplers' transition core and the deterministic Heun sampler
(counterpart of ``gecco_tpu/diffusion/samplers.py``: ``churn_gamma``,
``heun_step`` and ``heun_sampler`` with ``heun_on_last=True``).

The JAX package scans over the sigma grid; here it is a Python loop over
0-d fp32 tensors on the state's device, so no step waits for the host. The
churn's normal draw is an argument of ``heun_step``, so that a caller (or a
test) can feed it the numbers that ``jax.random`` drew.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["churn_gamma", "heun_step", "heun_sampler"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (sigma, x) -> x_hat


def churn_gamma(s_churn: float, n_transitions: int) -> float:
    """EDM churn rate per transition, clamped at sqrt(2) - 1."""
    return min(s_churn / n_transitions, math.sqrt(2.0) - 1.0)


def heun_step(denoise_fn: DenoiseFn, x: torch.Tensor, s_cur: torch.Tensor,
              s_next: torch.Tensor, gamma: float = 0.0, s_noise: float = 1.0,
              noise: Optional[torch.Tensor] = None, second_order: bool = True) -> torch.Tensor:
    """One EDM Algorithm-2 transition s_cur -> s_next: with ``gamma > 0``
    the churn first raises the noise to s_cur (1 + gamma) with the standard
    normal ``noise`` of x's shape; then an Euler step and, where
    ``second_order``, Heun's correction. ``gamma == 0`` and
    ``second_order`` is the deterministic sampler's step."""
    if gamma > 0.0:
        if noise is None:
            raise ValueError("churn (gamma > 0) needs a normal draw")
        s_hat = s_cur * (1.0 + gamma)
        churn_std = torch.sqrt(torch.clamp(s_hat**2 - s_cur**2, min=0.0)) * s_noise
        x_hat = x + churn_std * noise.to(x.dtype)
    else:
        s_hat, x_hat = s_cur, x
    d_cur = (x_hat - denoise_fn(s_hat, x_hat)) / s_hat
    x_euler = x_hat + (s_next - s_hat) * d_cur
    if not second_order:
        return x_euler
    d_prime = (x_euler - denoise_fn(s_next, x_euler)) / s_next
    return x_hat + (s_next - s_hat) * (0.5 * d_cur + 0.5 * d_prime)


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
