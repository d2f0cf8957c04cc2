"""Conditional-generation render callback (counterpart of
``gecco_tpu/vis/conditional3d.py``): for a fixed conditional validation
batch, (context image | ground truth | sample) rows each validation phase.
The clouds are path-traced with mitsuba where asked and importable, else
drawn as depth-coloured matplotlib scatter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gecco_tpu_torch.diffusion.samplers import NormalFn
from gecco_tpu_torch.types import Example, batch_index, to_device
from gecco_tpu_torch.vis._common import device_of, numpy, plt, sample_stochastic

__all__ = ["ConditionalRenderCallback", "render_cloud"]


def render_cloud(points, ax=None, elev: float = 20.0, azim: float = -60.0,
                 backend: str = "matplotlib"):
    """Render one cloud [N, 3]. ``backend``: "matplotlib" (depth-coloured
    scatter, a figure), "mitsuba" (path-traced spheres, a uint8 image;
    raises ``ImportError`` without mitsuba) or "auto" (mitsuba where it
    imports, else matplotlib)."""
    if backend in ("mitsuba", "auto"):
        from gecco_tpu_torch.vis.mitsuba_render import mitsuba_available, render_cloud_mitsuba

        if mitsuba_available():
            return render_cloud_mitsuba(numpy(points))
        if backend == "mitsuba":
            raise ImportError("mitsuba is not installed; use backend='matplotlib' or 'auto'")
    if ax is None:
        fig = plt().figure(figsize=(4, 4))
        ax = fig.add_subplot(projection="3d")
    pts = numpy(points)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c=pts[:, 2], cmap="viridis")
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    return ax.get_figure()


class ConditionalRenderCallback:
    """(context image | ground truth | stochastic sample) rows for the first
    ``n`` examples of a fixed batch (``set_batch``) each validation phase;
    ``normal`` gives the sampler's draws (else a generator seeded by
    ``seed`` on the model's device)."""

    def __init__(self, n: int = 4, n_steps: int = 64, s_churn: float = 0.5, seed: int = 42,
                 normal: Optional[NormalFn] = None):
        self.n = n
        self.n_steps = n_steps
        self.s_churn = s_churn
        self.seed = seed
        self.normal = normal
        self.batch: Optional[Example] = None

    def set_batch(self, batch: Example):
        self.batch = batch_index(batch.discard_extras(), slice(0, self.n))

    def __call__(self, model, logger, epoch: int):
        if self.batch is None or self.batch.ctx is None:
            return
        batch = self.batch
        ctx = to_device(batch.ctx, device_of(model))
        samples = sample_stochastic(model, self.seed, self.normal, tuple(batch.points.shape),
                                    ctx, self.s_churn, self.n_steps)
        images = numpy(batch.ctx.image) if batch.ctx.image is not None else None
        gt = numpy(batch.points)
        fig = plt().figure(figsize=(9, 3 * self.n), tight_layout=True)
        for i in range(min(self.n, gt.shape[0])):
            if images is not None:
                ax = fig.add_subplot(self.n, 3, 3 * i + 1)
                ax.imshow(np.clip(images[i], 0, 1))
                ax.set_axis_off()
            render_cloud(gt[i], ax=fig.add_subplot(self.n, 3, 3 * i + 2, projection="3d"))
            render_cloud(samples[i], ax=fig.add_subplot(self.n, 3, 3 * i + 3, projection="3d"))
        logger.add_figure("conditional/renders", figure=fig, global_step=epoch)
