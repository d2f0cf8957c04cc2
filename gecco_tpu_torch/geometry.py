"""Pinhole camera geometry, batched (counterpart of
``gecco_tpu/geometry.py``'s projections)."""

from __future__ import annotations

import torch

__all__ = ["project_points", "unproject_points"]


def project_points(xyz: torch.Tensor, camera_matrix: torch.Tensor,
                   eps: float = 1e-8) -> torch.Tensor:
    """``xyz [..., 3]`` through ``camera_matrix [..., 3, 3]`` (broadcast
    over the leading axes) -> image-plane ``(w, h)`` ``[..., 2]``. The
    dehomogenisation divides by ``z + eps`` where ``|z| > eps`` and by 1
    elsewhere."""
    xyw = torch.einsum("...ae,...e->...a", camera_matrix, xyz)
    z = xyw[..., 2:]
    scale = torch.where(z.abs() > eps, 1.0 / (z + eps), torch.ones_like(z))
    return xyw[..., :2] * scale


def unproject_points(wh: torch.Tensor, depth: torch.Tensor, camera_matrix: torch.Tensor,
                     normalized: bool = True) -> torch.Tensor:
    """``wh [..., 2]`` and ``depth [...]`` back to 3-D through the inverse
    of ``camera_matrix [..., 3, 3]``. With ``normalized`` the ray is of unit
    length, so ``depth`` is the Euclidean distance from the camera."""
    uvw = torch.cat([wh, torch.ones_like(wh[..., :1])], dim=-1)
    xyw = torch.einsum("...ae,...e->...a", torch.linalg.inv(camera_matrix), uvw)
    if normalized:
        xyw = xyw / torch.linalg.vector_norm(xyw, dim=-1, keepdim=True)
    return xyw * depth[..., None]
