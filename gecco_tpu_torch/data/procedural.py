"""Procedural data for training without a dataset, numpy only, so the same
``np.random.Generator`` gives the same batch: the point-cloud mixture (the
port's copy of ``make_clouds`` in ``scripts/validate_flagship.py``) and an
image-conditional batch built on it."""

from __future__ import annotations

import numpy as np

__all__ = ["CAMERA_K", "make_clouds", "make_conditional_batch"]

# the intrinsics of the image-conditional benchmark (bench.py)
CAMERA_K = np.array([[0.75, 0.0, 0.5], [0.0, 0.75, 0.5], [0.0, 0.0, 1.0]], np.float32)


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


def make_conditional_batch(rng: np.random.Generator, n: int, n_points: int,
                           image_size: int = 256) -> tuple:
    """An image-conditional batch -> (points [n, n_points, 3], images
    [n, S, S, 3], K [n, 3, 3]), all float32.

    The images are uniform in [0, 1) and every camera is ``CAMERA_K``, as the
    conditional benchmark of ``bench.py`` makes them. The points are
    ``make_clouds`` scaled by 0.5 and shifted to z = 2 in front of the
    camera: the clouds stay within about 0.6 of their centre, so every point
    has z > 1.4 and projects to (h, w) well inside [0, 1]^2."""
    points = make_clouds(rng, n, n_points) * 0.5 + np.array([0.0, 0.0, 2.0], np.float32)
    images = rng.uniform(size=(n, image_size, image_size, 3)).astype(np.float32)
    return points.astype(np.float32), images, np.broadcast_to(CAMERA_K, (n, 3, 3)).copy()
