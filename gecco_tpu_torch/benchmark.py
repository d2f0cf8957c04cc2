"""Generative-quality benchmark: 1-NN accuracy, MMD and COV over a matrix
of set-to-set distances, and ``BenchmarkCallback``, the trainer's callback
that scores the EMA model's samples against held-out clouds each
validation phase (counterpart of ``gecco_tpu/benchmark.py``)."""

from __future__ import annotations

import math
import os
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch

from gecco_tpu_torch.metrics import chamfer_distance, chamfer_distance_squared
from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["BenchmarkCallback", "batched_pairwise_distance", "cov", "extract_data", "mmd",
           "one_nn_accuracy"]

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


def extract_data(loader: Iterable, n_examples: Optional[int]) -> np.ndarray:
    """The first ``n_examples`` clouds of a loader's batches, [S, N, D]
    numpy (all of them where None)."""
    collected, total = [], 0
    for batch in loader:
        pts = np.asarray(batch.points)
        collected.append(pts)
        total += pts.shape[0]
        if n_examples is not None and total >= n_examples:
            break
    return np.concatenate(collected, axis=0)[:n_examples]


# the distances the callback takes by name; the EMD ones wait for ROADMAP A4
_DISTANCES = {"chamfer": chamfer_distance, "chamfer_squared": chamfer_distance_squared}


class BenchmarkCallback:
    """Trainer callback: samples as many clouds as ``data`` holds from the
    model (``Diffusion.sample``, batches of ``batch_size``, latents from one
    generator seeded ``rng_seed``), scores them by 1-NN accuracy, MMD and
    COV against ``data`` under ``distance_fn`` and logs the three; with a
    ``save_path`` it keeps the model of the best 1-NN so far under
    ``benchmark-checkpoints/<distance>/<epoch>/model.pt``. The distances
    are computed on ``device``, the card unless another is named."""

    def __init__(
        self,
        data: np.ndarray,  # [S, N, D]
        batch_size: int = 64,
        tag_prefix: str = "benchmark",
        rng_seed: int = 42,
        block_size: int = 16,
        distance_fn: Union[str, Callable] = chamfer_distance,
        save_path: Optional[str] = None,
        device=None,
    ):
        self.data = np.asarray(data)
        self.batch_size, self.block_size = batch_size, block_size
        self.tag_prefix, self.rng_seed = tag_prefix, rng_seed
        self.n_points = self.data.shape[1]
        self.n_batches = int(math.ceil(self.data.shape[0] / batch_size))
        self.device = resolve_device(device)

        if isinstance(distance_fn, str):
            if distance_fn in ("emd", "emd_exact"):
                raise NotImplementedError(
                    f"BenchmarkCallback: distance {distance_fn!r} needs the EMD metrics, which "
                    "are not ported yet (ROADMAP A4); use 'chamfer' or 'chamfer_squared'")
            distance_fn = _DISTANCES[distance_fn]
        self.distance_fn_name = getattr(distance_fn, "func", distance_fn).__name__
        self._distance = distance_fn
        self.d_dd = self.distance_fn(self.data, self.data)

        if save_path is not None:
            save_path = os.path.join(save_path, "benchmark-checkpoints", self.distance_fn_name)
            os.makedirs(save_path, exist_ok=True)
        self.save_path = save_path
        self.lowest_1nn = float("inf")

    def distance_fn(self, a, b) -> np.ndarray:
        """The [S, T] distance matrix of two stacks of clouds, on the
        callback's device."""
        ta, tb = (torch.as_tensor(np.asarray(t)).to(self.device) for t in (a, b))
        d = batched_pairwise_distance(ta.float(), tb.float(), self._distance, self.block_size)
        return d.cpu().numpy()

    @classmethod
    def from_loader(cls, loader, n_examples=None, **kwargs) -> "BenchmarkCallback":
        return cls(extract_data(loader, n_examples), batch_size=loader.batch_size, **kwargs)

    def sample_from_model(self, model) -> np.ndarray:
        generator = torch.Generator().manual_seed(self.rng_seed)
        shape = (self.batch_size, self.n_points, self.data.shape[-1])
        samples = [model.sample(generator, shape).float().cpu().numpy()
                   for _ in range(self.n_batches)]
        return np.concatenate(samples, axis=0)[: self.data.shape[0]]

    def call_without_logging(self, samples: np.ndarray):
        d_ss = self.distance_fn(samples, samples)
        d_sd = self.distance_fn(samples, self.data)
        t = lambda m: torch.from_numpy(m)
        name = self.distance_fn_name
        scalars = {
            f"{self.tag_prefix}/1-nn-acc/{name}": one_nn_accuracy(t(d_ss), t(d_sd),
                                                                  t(self.d_dd)),
            f"{self.tag_prefix}/mmd/{name}": mmd(t(d_sd)),
            f"{self.tag_prefix}/cov/{name}": cov(t(d_sd)),
        }
        return scalars, self._make_plots(d_ss, d_sd)

    def _make_plots(self, d_ss, d_sd):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return {}
        fig, ax = plt.subplots(tight_layout=True)
        kw = dict(histtype="step", bins=np.linspace(0, self.d_dd.max() * 1.3, 20))
        ax.hist(self.d_dd.flatten(), color="r", label="data-data", **kw)
        ax.hist(d_ss.flatten(), color="b", label="sample-sample", **kw)
        ax.hist(d_sd.flatten(), color="g", label="sample-data", **kw)
        fig.legend()
        dist_m = np.concatenate([np.concatenate([d_ss, d_sd], axis=1),
                                 np.concatenate([d_sd.T, self.d_dd], axis=1)], axis=0)
        fig2, ax2 = plt.subplots(tight_layout=True, figsize=(6, 6))
        ax2.imshow(dist_m + np.diag(np.full(dist_m.shape[0], np.inf)), vmax=self.d_dd.max())
        ax2.set_xticks([d_ss.shape[0]])
        ax2.set_yticks([d_ss.shape[0]])
        return {f"{self.tag_prefix}/histograms/{self.distance_fn_name}": fig,
                f"{self.tag_prefix}/dist-mat/{self.distance_fn_name}": fig2}

    def __call__(self, model, logger, epoch: int):
        scalars, plots = self.call_without_logging(self.sample_from_model(model))
        for tag, value in scalars.items():
            logger.add_scalar(tag, scalar_value=value, global_step=epoch)
        for tag, fig in plots.items():
            logger.add_figure(tag, figure=fig, global_step=epoch)
            try:
                import matplotlib.pyplot as plt

                plt.close(fig)
            except Exception:
                pass
        if self.save_path is None:
            return
        one_nn = scalars[f"{self.tag_prefix}/1-nn-acc/{self.distance_fn_name}"]
        if not one_nn < self.lowest_1nn:
            return
        print(f"[benchmark] new best 1-NN {one_nn:.4f} (was {self.lowest_1nn:.4f}); "
              "checkpointing")
        self.lowest_1nn = one_nn
        path = os.path.join(self.save_path, str(epoch))
        os.makedirs(path, exist_ok=True)
        torch.save(model.state_dict(), os.path.join(path, "model.pt"))
