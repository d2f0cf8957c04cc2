"""EDM noise schedules and preconditioning (counterpart of
``gecco_tpu/diffusion/schedule.py``: ``Schedule``, ``LogUniformSchedule``,
``LogNormalSchedule`` and ``low_discrepancy_uniform``).

Coefficients are elementwise over tensors of any shape. ``c_noise`` is sigma
itself (the JAX package's convention) or ``log(sigma) / 4``; the Karras grid
does not append a final 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

__all__ = ["Schedule", "LogUniformSchedule", "LogNormalSchedule", "low_discrepancy_uniform"]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base EDM schedule: sigma(t) = t, scale(t) = 1 (variance exploding)."""

    sigma_max: float = 25.0
    sigma_data: float = 1.0
    n_solver_steps: int = 16
    sigma_min: float = 0.002
    rho: float = 7.0
    c_noise_mode: str = "sigma"  # or "log_quarter"

    def c_skip(self, sigma):
        s_d = self.sigma_data
        return (s_d**2) / (sigma**2 + s_d**2)

    def c_out(self, sigma):
        s_d = self.sigma_data
        return sigma * s_d / torch.sqrt(s_d**2 + sigma**2)

    def c_in(self, sigma):
        return 1.0 / torch.sqrt(sigma**2 + self.sigma_data**2)

    def c_noise(self, sigma):
        if self.c_noise_mode == "log_quarter":
            return torch.log(sigma) / 4
        return sigma

    def loss_weight(self, sigma):
        """lambda(sigma) of the denoising loss."""
        s_d = self.sigma_data
        return (sigma**2 + s_d**2) / ((sigma * s_d) ** 2)

    def t_i(self, i: torch.Tensor) -> torch.Tensor:
        """sigma at solver step ``i``, rho-spaced."""
        a = self.sigma_max ** (1.0 / self.rho)
        b = self.sigma_min ** (1.0 / self.rho)
        return (a + i / (self.n_solver_steps - 1) * (b - a)) ** self.rho

    def solver_grid(self, n_steps: Optional[int] = None, device=None) -> torch.Tensor:
        """fp32 sigmas ``[t_0 .. t_{N-1}]`` (t_0 = sigma_max, t_{N-1} = sigma_min)."""
        if n_steps is not None and n_steps != self.n_solver_steps:
            return dataclasses.replace(self, n_solver_steps=n_steps).solver_grid(device=device)
        return self.t_i(torch.arange(self.n_solver_steps, dtype=torch.float32, device=device))

    def sample_latent(self, generator: torch.Generator, shape, device=None) -> torch.Tensor:
        """A draw from the terminal prior N(0, sigma_max^2), made on the
        generator's device and moved to ``device``."""
        z = torch.randn(shape, generator=generator, device=generator.device)
        return (self.sigma_max * z).to(device if device is not None else z.device)

    def sample_sigma(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n training-time noise levels [n] fp32, on the generator's device."""
        raise NotImplementedError


def low_discrepancy_uniform(generator: torch.Generator, n: int, minval: float = 0.0,
                            maxval: float = 1.0) -> torch.Tensor:
    """Stratified uniform draw: one sample in each of the n strata of width
    1/n of [0, 1), mapped to [minval, maxval)."""
    u = torch.rand(n, generator=generator, device=generator.device) / n
    u = u + torch.arange(n, device=generator.device) / n
    return u * (maxval - minval) + minval


@dataclasses.dataclass(frozen=True)
class LogUniformSchedule(Schedule):
    """The flagship's schedule: sigma ~ exp(U[log sigma_min, log sigma_max]),
    drawn low-discrepancy across the batch."""

    def sample_sigma(self, generator: torch.Generator, n: int) -> torch.Tensor:
        log_sigma = low_discrepancy_uniform(
            generator, n, math.log(self.sigma_min), math.log(self.sigma_max))
        return torch.exp(log_sigma)


@dataclasses.dataclass(frozen=True)
class LogNormalSchedule(Schedule):
    """sigma ~ LogNormal(sigma_log_mean, sigma_log_std)."""

    sigma_log_mean: float = 0.5
    sigma_log_std: float = 1.0

    def sample_sigma(self, generator: torch.Generator, n: int) -> torch.Tensor:
        normal = torch.randn(n, generator=generator, device=generator.device)
        return torch.exp(self.sigma_log_std * normal + self.sigma_log_mean)
