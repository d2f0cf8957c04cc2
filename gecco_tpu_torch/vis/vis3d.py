"""3-D visualisation callbacks (counterpart of ``gecco_tpu/vis/vis3d.py``):
TensorBoard meshes of samples coloured by their latent's norm, matplotlib
scatter, and the ground truth against samples of a fixed validation batch.

The draws come from a generator on the model's device seeded by ``seed``
(the JAX callbacks' ``PRNGKey(42)``), the same every call; ``latent`` or
``normal`` gives them instead, through the samplers' ``*_from`` entry
points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gecco_tpu_torch.diffusion.samplers import NormalFn
from gecco_tpu_torch.types import Example, batch_index, to_device
from gecco_tpu_torch.vis._common import device_of, generator, numpy, plt, sample_stochastic

__all__ = ["plot_3d", "make_unconditional_sample_callback", "PCVisCallback"]


def plot_3d(clouds, colors=("r", "g", "b"), shared_ax: bool = True):
    """Matplotlib scatter of one or more point clouds [N, 3]."""
    if not isinstance(clouds, (list, tuple)):
        clouds = [clouds]
    n = 1 if shared_ax else len(clouds)
    fig, axes = plt().subplots(1, n, subplot_kw={"projection": "3d"}, figsize=(6 * n, 6),
                               squeeze=False)
    for i, cloud in enumerate(clouds):
        ax = axes[0, 0] if shared_ax else axes[0, i]
        pts = numpy(cloud)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c=colors[i % len(colors)])
    return fig


def make_unconditional_sample_callback(geom_dim: int = 3, n_samples: int = 8,
                                       n_points: int = 2048, point_size: float = 0.1,
                                       seed: int = 42, latent: Optional[torch.Tensor] = None):
    """Sampled clouds logged as meshes, coloured by the latent's norm;
    ``latent`` [n_samples, n_points, geom_dim] replaces the draw."""

    def callback(model, logger, epoch: int):
        shape = (n_samples, n_points, geom_dim)
        if latent is None:
            details = model.sample(generator(model, seed), shape, return_details=True)
        else:
            details = model.sample_from_latent(latent.to(device_of(model)), return_details=True)
        points = numpy(details.sample_data)
        latent_r = np.linalg.norm(numpy(details.latent), axis=-1)
        r_normalized = 1.0 - np.clip(latent_r / (2 * model.schedule.sigma_max), 0.0, 1.0)
        colors = plt().get_cmap("viridis")(r_normalized, bytes=True)[..., :3]
        logger.add_mesh(tag="samples", vertices=points, colors=colors, global_step=epoch,
                        config_dict={"material": {"cls": "PointsMaterial", "size": point_size}})

    return callback


class PCVisCallback:
    """Trainer callback: the context images once, then the ground truth
    (green) against stochastic samples (red) of a fixed batch each
    validation phase (``set_batch``: the first ``n`` examples)."""

    def __init__(self, n: int = 8, n_steps: int = 64, point_size: float = 0.1, seed: int = 42,
                 normal: Optional[NormalFn] = None):
        self.n = n
        self.n_steps = n_steps
        self.point_size = point_size
        self.seed = seed
        self.normal = normal
        self.batch: Optional[Example] = None
        self._logged_images = False

    def set_batch(self, batch: Example):
        self.batch = batch_index(batch.discard_extras(), slice(0, self.n))

    def __call__(self, model, logger, epoch: int):
        if self.batch is None:
            return
        batch = self.batch
        has_ctx = batch.ctx is not None and getattr(batch.ctx, "image", None) is not None
        if has_ctx and not self._logged_images:
            self._logged_images = True
            for i, image in enumerate(numpy(batch.ctx.image)):
                logger.add_image(tag=f"val/context_image_{i}", img_tensor=image.transpose(2, 0, 1),
                                 global_step=epoch)
        ctx = to_device(batch.ctx, device_of(model))
        samples = sample_stochastic(model, self.seed, self.normal, tuple(batch.points.shape),
                                    ctx, 0.5, self.n_steps)
        if not has_ctx:
            vertices, colors = samples, None
        else:
            gt = numpy(batch.points)
            vertices = np.concatenate([gt, samples], axis=1)
            colors = np.zeros(vertices.shape, dtype=np.uint8)
            colors[:, : gt.shape[1], 1] = 255  # green ground truth
            colors[:, gt.shape[1]:, 0] = 255  # red samples
        logger.add_mesh(tag="val/samples", vertices=vertices, colors=colors, global_step=epoch,
                        config_dict={"material": {"cls": "PointsMaterial",
                                                  "size": self.point_size}})
