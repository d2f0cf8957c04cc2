"""Generative-quality benchmark: 1-NN accuracy, MMD and COV over a matrix
of set-to-set distances (counterpart of ``gecco_tpu/benchmark.py``'s
scores; the ``BenchmarkCallback`` of its trainer is not ported)."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["batched_pairwise_distance", "cov", "mmd", "one_nn_accuracy"]

# fp32 elements of one block's [s, t, N, M] point-distance tensor
_BLOCK_ELEMENTS = 2**27


def batched_pairwise_distance(a: torch.Tensor, b: torch.Tensor, distance_fn: Callable,
                              block_size: Optional[int] = None) -> torch.Tensor:
    """``a [S, N, D]`` x ``b [T, M, D]`` -> the [S, T] matrix of
    ``distance_fn`` between every pair of sets, computed in blocks of
    ``block_size`` sets per side on the tensors' device (by default the
    largest block whose point-distance tensor holds ``_BLOCK_ELEMENTS``)."""
    if block_size is None:
        block_size = max(1, math.isqrt(_BLOCK_ELEMENTS // (a.shape[1] * b.shape[1])))
    rows = []
    for a_blk in torch.split(a, block_size):
        rows.append(torch.cat([distance_fn(a_blk[:, None], b_blk[None])
                               for b_blk in torch.split(b, block_size)], dim=1))
    return torch.cat(rows, dim=0)


def one_nn_accuracy(d_ss: torch.Tensor, d_sd: torch.Tensor, d_dd: torch.Tensor) -> float:
    """1-NN two-sample classification accuracy from the sample-sample,
    sample-data and data-data distances; 0.5 is ideal. Keeps the
    reference's ``<= n`` (index n is the first data row, so a sample whose
    nearest neighbour is data cloud 0 counts as a hit) for score parity."""
    dist_m = torch.cat([torch.cat([d_ss, d_sd], dim=1), torch.cat([d_sd.T, d_dd], dim=1)], dim=0)
    n = d_ss.shape[0]
    dist_m.fill_diagonal_(float("inf"))
    nearest = dist_m.argmin(dim=0)
    hits = torch.cat([nearest[:n] <= n, nearest[n:] > n])
    return float(hits.float().mean())


def mmd(d_sd: torch.Tensor) -> float:
    """Minimum matching distance: the least sample-to-data distance."""
    return float(d_sd.amin(dim=0).amin())


def cov(d_sd: torch.Tensor) -> float:
    """Coverage: the fraction of data sets that are some sample's nearest
    neighbour."""
    return float(torch.unique(d_sd.argmin(dim=1)).numel() / d_sd.shape[1])
