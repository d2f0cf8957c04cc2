"""Visualisation callbacks (counterpart of ``gecco_tpu/vis``): figures,
meshes and renders of samples, trajectories, denoising and likelihoods,
logged through a TensorBoard-style writer. matplotlib (and mitsuba, for the
path-traced renders) is imported when a figure is made."""

from gecco_tpu_torch.vis.conditional3d import ConditionalRenderCallback, render_cloud
from gecco_tpu_torch.vis.trajectories import plot_trajectories_3d, trajectories_to_polylines
from gecco_tpu_torch.vis.vis2d import (
    make_denoise_callback,
    make_logp_callback,
    make_sample_figures_callback,
    plot_trajectories_2d,
)
from gecco_tpu_torch.vis.vis3d import (
    PCVisCallback,
    make_unconditional_sample_callback,
    plot_3d,
)

__all__ = [
    "ConditionalRenderCallback",
    "render_cloud",
    "plot_trajectories_3d",
    "trajectories_to_polylines",
    "make_denoise_callback",
    "make_logp_callback",
    "make_sample_figures_callback",
    "plot_trajectories_2d",
    "PCVisCallback",
    "make_unconditional_sample_callback",
    "plot_3d",
]
