"""EDM samplers: the transition core, the Heun sampler (deterministic, or
stochastic with churn) and RePaint-style inpainting (counterpart of
``gecco_tpu/diffusion/samplers.py``: ``churn_gamma``, ``heun_step``,
``heun_sampler`` and ``inpaint_sampler``).

The JAX package scans over the sigma grid; here it is a Python loop over
0-d fp32 tensors on the state's device, so no step waits for the host.
Where JAX splits a key, these take ``normal(shape)``, a function that
returns a standard normal draw of that shape: every random number comes
through it, in the order the JAX loop uses its keys, so that a caller (or
a test) can feed in the numbers that ``jax.random`` drew.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["churn_gamma", "heun_step", "heun_sampler", "inpaint_sampler"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (sigma, x) -> x_hat
NormalFn = Callable[[tuple], torch.Tensor]  # shape -> a standard normal draw


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
                 normal: Optional[NormalFn] = None, s_churn: float = 0.0, s_noise: float = 1.0,
                 heun_on_last: bool = False, save_trajectory: bool = False):
    """EDM Algorithm 2 over the fixed grid ``sigmas`` [T]: T-1 transitions.
    With ``s_churn == 0`` and ``heun_on_last`` it is the deterministic Heun
    probability-flow sampler (2(T-1) denoiser calls); with churn, each
    transition first takes a draw of x's shape from ``normal``, and the
    last transition is Euler only unless ``heun_on_last``.
    Returns ``(x_final, trajectory [T-1, B, N, D] or None)``."""
    n_transitions = sigmas.shape[0] - 1
    gamma = churn_gamma(s_churn, n_transitions)
    if gamma > 0.0 and normal is None:
        raise ValueError("churn (s_churn > 0) needs a normal draw function")
    x = x_init
    traj = []
    for t in range(n_transitions):
        noise = normal(tuple(x.shape)) if gamma > 0.0 else None
        x = heun_step(denoise_fn, x, sigmas[t], sigmas[t + 1], gamma, s_noise, noise,
                      second_order=heun_on_last or t < n_transitions - 1)
        if save_trajectory:
            traj.append(x)
    return x, (torch.stack(traj) if save_trajectory else None)


def inpaint_sampler(denoise_fn: DenoiseFn, sigmas: torch.Tensor, known_diff: torch.Tensor,
                    m_to_inpaint: int, normal: NormalFn, s_churn: float = 0.0,
                    s_noise: float = 1.0, n_substeps: int = 1) -> torch.Tensor:
    """RePaint-style completion over the (extended) grid ``sigmas``: the
    state holds ``m_to_inpaint`` generated points followed by the known
    points ``known_diff`` [B, M, D] (diffusion space). At every noise level
    and substep the known points, re-noised to it, are clamped into the
    state's tail; one churned Heun transition follows (Euler only on the
    last level); then, unless it is the last substep, the state is
    re-noised back up, on the last level too, as in the JAX package. The
    draws, in order: the initial state's; then per substep the known
    points' re-noising, the churn's (where the churn rate is positive) and
    the re-noising's (where it applies). Returns the generated points
    [B, m_to_inpaint, D]."""
    b, m, d = known_diff.shape
    n_transitions = sigmas.shape[0] - 1
    gamma = churn_gamma(s_churn, n_transitions)
    x = torch.cat([known_diff.new_zeros(b, m_to_inpaint, d), known_diff], dim=1)
    x = x + sigmas[0] * normal(tuple(x.shape)).to(x.dtype)
    for t in range(n_transitions):
        s_cur, s_next = sigmas[t], sigmas[t + 1]
        for j in range(n_substeps):
            known = known_diff + s_cur * normal(tuple(known_diff.shape)).to(x.dtype)
            x = torch.cat([x[:, :m_to_inpaint], known], dim=1)
            churn = normal(tuple(x.shape)) if gamma > 0.0 else None
            x = heun_step(denoise_fn, x, s_cur, s_next, gamma, s_noise, churn,
                          second_order=t < n_transitions - 1)
            if j < n_substeps - 1:
                std = torch.sqrt(torch.clamp(s_cur**2 - s_next**2, min=0.0))
                x = x + std * normal(tuple(x.shape)).to(x.dtype)
    return x[:, :m_to_inpaint]
