"""Sampler output record (counterpart of ``gecco_tpu.types.SampleDetails``)."""

from __future__ import annotations

from typing import Any, NamedTuple

__all__ = ["SampleDetails"]


class SampleDetails(NamedTuple):
    latent: Any  # [B, N, D] initial state, drawn from N(0, sigma_max^2)
    sample_diff: Any  # [B, N, D] final state in diffusion space
    sample_data: Any  # [B, N, D] final state in data space
    trajectory_diff: Any  # [T-1, B, N, D] state after every transition
    trajectory_data: Any
