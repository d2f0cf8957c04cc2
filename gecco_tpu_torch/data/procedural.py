"""Procedural point-cloud mixture for training without a dataset (the
port's copy of ``make_clouds`` in ``scripts/validate_flagship.py``; numpy
only, so the same ``np.random.Generator`` gives the same clouds)."""

from __future__ import annotations

import numpy as np

__all__ = ["make_clouds"]


def make_clouds(
    rng: np.random.Generator, n: int, n_points: int, n_families: int = 4
) -> np.ndarray:
    """Sample n procedural clouds [n, n_points, 3], zero-mean, ~0.35 std:
    ellipsoid shells, box surfaces, two-lobe blends and tori, each rotated
    about z and rescaled."""
    out = np.empty((n, n_points, 3), np.float32)
    for idx in range(n):
        family = rng.integers(n_families)
        u = rng.uniform(0, 2 * np.pi, n_points)
        v = rng.uniform(-1, 1, n_points)
        if family == 0:  # ellipsoid shell
            r = np.sqrt(1 - v**2)
            pts = np.stack([r * np.cos(u), r * np.sin(u), v], -1)
            pts *= rng.uniform(0.4, 1.0, 3)
        elif family == 1:  # box surface
            pts = rng.uniform(-1, 1, (n_points, 3))
            ax = rng.integers(0, 3, n_points)
            pts[np.arange(n_points), ax] = np.sign(pts[np.arange(n_points), ax])
            pts *= rng.uniform(0.4, 0.9, 3)
        elif family == 2:  # two-lobe blend
            r = np.sqrt(1 - v**2)
            pts = np.stack([r * np.cos(u), r * np.sin(u), v], -1) * 0.5
            side = rng.integers(0, 2, n_points) * 2 - 1
            pts[:, 0] += side * rng.uniform(0.3, 0.6)
        else:  # torus
            w = rng.uniform(0, 2 * np.pi, n_points)
            rr = rng.uniform(0.15, 0.35)
            pts = np.stack(
                [
                    (1 + rr * np.cos(w)) * np.cos(u),
                    (1 + rr * np.cos(w)) * np.sin(u),
                    rr * np.sin(w),
                ],
                -1,
            ) * 0.6
        # random rotation about z + global scale to ~0.35 std
        th = rng.uniform(0, 2 * np.pi)
        rot = np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        )
        pts = pts @ rot.T
        pts -= pts.mean(0)
        pts *= 0.35 / (pts.std() + 1e-8)
        out[idx] = pts
    return out
