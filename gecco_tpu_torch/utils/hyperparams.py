"""Hyperparameters fitted to a dataset (counterpart of
``gecco_tpu/utils/hyperparams.py``): the ``GaussianReparam`` statistics,
sigma_max as the largest pairwise distance in diffusion space, and the
``UVLReparam`` statistics, each from the first ``n_batches`` batches of a
loader. The reparams are made on ``device``, the card unless another is
named; the distances are computed on the CPU.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from gecco_tpu_torch.geometry import distance_matrix
from gecco_tpu_torch.reparam import GaussianReparam, UVLReparam
from gecco_tpu_torch.types import Context3d

__all__ = ["fit_gaussian_reparam", "fit_sigma_max", "fit_uvl_stats"]


def _collect_points(loader, n_batches):
    batches = []
    for i, batch in enumerate(loader):
        batches.append(np.asarray(batch.points))
        if n_batches is not None and i + 1 >= n_batches:
            break
    return np.concatenate(batches, axis=0)


def _cpu_ctx(ctx):
    """A batch's numpy ``Context3d`` as CPU tensors (the image left out)."""
    if ctx is None:
        return None
    return Context3d(image=None, K=torch.as_tensor(np.asarray(ctx.K)))


def fit_gaussian_reparam(loader, n_batches: int = 16, *, device=None) -> GaussianReparam:
    """The per-axis mean and (population) std over the sampled points."""
    pts = _collect_points(loader, n_batches)
    flat = pts.reshape(-1, pts.shape[-1])
    return GaussianReparam(flat.mean(axis=0), flat.std(axis=0), device=device)


def fit_sigma_max(loader, reparam=None, ctx=None, n_batches: int = 16) -> float:
    """sigma_max = the largest distance between two points of one cloud in
    diffusion space: noise at sigma_max must carry any point to any other.
    ``reparam`` (where given) maps the clouds with ``ctx``; a copy of it
    runs on the CPU."""
    x = torch.as_tensor(_collect_points(loader, n_batches))
    if reparam is not None:
        x = copy.deepcopy(reparam).cpu().data_to_diffusion(x, _cpu_ctx(ctx))
    best = 0.0
    for i in range(x.shape[0]):  # one cloud at a time, to bound the memory
        best = max(best, float(distance_matrix(x[i], x[i]).max()))
    return best


def fit_uvl_stats(loader, reparam: UVLReparam, n_batches: int = 16, *,
                  device=None) -> UVLReparam:
    """A ``UVLReparam`` like ``reparam`` with ``uvl_mean``/``uvl_std``
    fitted to image-conditional data: each batch's (points, K) through the
    unnormalised uvl map, the moments over the finite results."""
    base = UVLReparam(uvl_mean=np.zeros(3), uvl_std=np.ones(3), logit_scale=reparam.logit_scale,
                      device="cpu")
    uvls = []
    for i, batch in enumerate(loader):
        xyz = torch.as_tensor(np.asarray(batch.points))
        uvl = base.data_to_diffusion(xyz, _cpu_ctx(batch.ctx))
        uvls.append(uvl.numpy().reshape(-1, 3))
        if n_batches is not None and i + 1 >= n_batches:
            break
    flat = np.concatenate(uvls, axis=0)
    flat = flat[np.isfinite(flat).all(axis=1)]
    return UVLReparam(uvl_mean=flat.mean(axis=0), uvl_std=flat.std(axis=0),
                      logit_scale=reparam.logit_scale, device=device)
