"""Interactive 3-D diffusion-trajectory plots (counterpart of
``gecco_tpu/vis/trajectories.py``): per-point trajectories as polylines,
NaN rows splitting the points' segments; k3d where it imports, else a
matplotlib 3-D figure."""

from __future__ import annotations

import numpy as np

from gecco_tpu_torch.vis._common import numpy, plt

__all__ = ["plot_trajectories_3d", "trajectories_to_polylines"]


def trajectories_to_polylines(trajectory, max_lines: int = 512) -> np.ndarray:
    """[T, N, 3] -> one [T*N + N, 3] polyline vertex array, a NaN row after
    each point's segment."""
    traj = numpy(trajectory)[:, :max_lines]
    t, n, d = traj.shape
    nan_row = np.full((1, n, d), np.nan, traj.dtype)
    with_breaks = np.concatenate([traj, nan_row], axis=0)  # [T+1, N, 3]
    return with_breaks.transpose(1, 0, 2).reshape(-1, d)


def plot_trajectories_3d(trajectory, max_lines: int = 512, point_size: float = 0.02):
    """A k3d plot of the trajectories where k3d imports, else a matplotlib
    figure."""
    traj = numpy(trajectory)
    try:
        import k3d
    except ImportError:
        k3d = None
    if k3d is not None:
        plot = k3d.plot()
        plot += k3d.line(trajectories_to_polylines(traj, max_lines).astype(np.float32),
                         width=point_size / 4)
        plot += k3d.points(traj[-1, :max_lines].astype(np.float32), point_size=point_size)
        return plot
    fig = plt().figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    n = min(traj.shape[1], max_lines)
    for i in range(n):
        ax.plot(traj[:, i, 0], traj[:, i, 1], traj[:, i, 2], lw=0.3, alpha=0.4, color="C0")
    ax.scatter(traj[-1, :n, 0], traj[-1, :n, 1], traj[-1, :n, 2], s=2, color="C1")
    return fig
