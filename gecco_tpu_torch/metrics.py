"""Validation metrics and set-to-set distances (counterpart of
``gecco_tpu/metrics.py``: ``Metric``, ``LossMetric``, ``LogpMetric``,
``SupervisedMetric`` and the Chamfer distances). A metric is called as
``metric(model, points, raw_ctx, generator)`` and returns a dict of
per-batch tensors under the JAX package's keys."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from gecco_tpu_torch.geometry import distance_matrix

__all__ = [
    "Metric",
    "LossMetric",
    "LogpMetric",
    "SupervisedMetric",
    "chamfer_distance",
    "chamfer_distance_squared",
]


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """Symmetric Chamfer distance, ``[..., N, D] x [..., M, D] -> [...]``:
    the mean of the two directions' mean nearest-neighbour distances."""
    dist_m = distance_matrix(a, b, squared=squared)
    min_a = dist_m.amin(dim=-2).mean(dim=-1)
    min_b = dist_m.amin(dim=-1).mean(dim=-1)
    return (min_a + min_b) / 2


def chamfer_distance_squared(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return chamfer_distance(a, b, squared=True)


class Metric:
    """Protocol: ``__call__(model, points, raw_ctx, generator) -> dict`` of
    per-batch tensors."""

    name: str

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class LossMetric(Metric):
    """The validation loss: ``Diffusion.loss`` at sigma and noise drawn
    from the generator, without a gradient."""

    def __init__(self, loss_scale: float = 1.0):
        self.loss_scale = loss_scale
        self.name = "loss"

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return {"loss": model.loss(points, generator, raw_ctx, loss_scale=self.loss_scale)}


class LogpMetric(Metric):
    """The exact likelihood's decomposition (``Diffusion.evaluate_logp``)
    per example: ``"total"`` = ``"prior"`` + ``"det-jac"`` (the integrated
    divergence) + ``"reparam"``. ``n_solver_steps`` overrides the
    schedule's grid for the reverse ODE (the configs take 24): the absolute
    value moves with it, so compare runs only at equal settings."""

    def __init__(self, n_log_det_jac_samples: int = 1, n_solver_steps: Optional[int] = None):
        self.name = "logp"
        self.n_log_det_jac_samples = n_log_det_jac_samples
        self.n_solver_steps = n_solver_steps

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        details = model.evaluate_logp(generator, points, raw_ctx=raw_ctx,
                                      n_log_det_jac_samples=self.n_log_det_jac_samples,
                                      n_solver_steps=self.n_solver_steps, return_details=True)
        return {"total": details.logp, "prior": details.prior_logp,
                "det-jac": details.delta_jacobian, "reparam": details.delta_reparam}


class SupervisedMetric(Metric):
    """Sample conditionally (``Diffusion.sample``) and compare with the
    ground truth, each distance under its function's name."""

    def __init__(self, metrics: Sequence[Callable] = (chamfer_distance,)):
        self.name = "supervised"
        self.metrics = tuple(metrics)

    def __call__(self, model, points, raw_ctx, generator) -> Dict[str, torch.Tensor]:
        samples = model.sample(generator, tuple(points.shape), raw_ctx=raw_ctx)
        return {getattr(m, "__name__", str(m)): m(samples, points) for m in self.metrics}
