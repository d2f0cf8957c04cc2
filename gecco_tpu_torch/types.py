"""Batched records (counterpart of ``gecco_tpu.types``: ``Context3d``,
``Example``, ``SampleDetails`` and ``LogpDetails``). Every tensor carries the batch axis
first; NamedTuples, as in the JAX package."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

__all__ = ["Context3d", "Example", "LogpDetails", "SampleDetails"]


class Context3d(NamedTuple):
    """Conditioning context: image and camera intrinsics."""

    image: Optional[Any]  # [B, H, W, 3] float or uint8, channels-last as in the JAX package
    K: Any  # [B, 3, 3] camera intrinsics
    wmat: Any = ()  # optional [B, 3, 4] world-to-camera


class Example(NamedTuple):
    """One batched training example."""

    points: Any  # [B, N, 3]
    ctx: Optional[Context3d] = None
    extras: Any = ()


class SampleDetails(NamedTuple):
    latent: Any  # [B, N, D] initial state, drawn from N(0, sigma_max^2)
    sample_diff: Any  # [B, N, D] final state in diffusion space
    sample_data: Any  # [B, N, D] final state in data space
    trajectory_diff: Any  # [T-1, B, N, D] state after every transition
    trajectory_data: Any


class LogpDetails(NamedTuple):
    """The exact likelihood's terms (``Diffusion.evaluate_logp``): logp =
    prior_logp + delta_jacobian + delta_reparam, each [B]."""

    logp: Any  # [B] log-density of the data-space cloud
    prior_logp: Any  # [B] the latent under N(0, sigma_max^2)
    delta_reparam: Any  # [B] log|det| of the data -> diffusion map
    delta_jacobian: Any  # [B] the integrated divergence of the flow
    trajectory_diff: Any  # [T-1, B, N, D] state after every transition
    trajectory_data: Any
    latent: Any  # [B, N, D] the state at sigma_max
