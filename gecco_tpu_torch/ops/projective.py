"""Projective feature lookup: bilinear interpolation into a feature pyramid
(counterpart of ``gecco_tpu/ops/projective.py``).

Normalised ``(h, w)`` in [0, 1]^2 are scaled by each level's ``(H, W)`` into
pixel-index space, with no half-pixel offset, and sampled at order 1: the
corners are ``floor`` and ``floor + 1``, and a corner outside the image
contributes zero. Coordinates and weights are fp32; the gathered features
keep their level's dtype.

``lookup_pyramid(..., impl="xla")`` is the plain version (the JAX package's
four-corner gather); ``impl="pallas"`` (the JAX package's name) runs the
hand-written gather of ``gecco_tpu_torch.ops.kernels.projective_gather``.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["LOOKUP_IMPLS", "bilinear_lookup", "lookup_pyramid"]

LOOKUP_IMPLS = ("xla", "pallas")


def bilinear_lookup(image: torch.Tensor, coords_hw: torch.Tensor) -> torch.Tensor:
    """Sample ``image [B, H, W, C]`` at pixel-space ``coords_hw [B, N, 2]``
    -> ``[B, N, C]``; each corner's weight is rounded to the image's dtype
    and the four products summed in it, as in the JAX package."""
    b, h, w, c = image.shape
    ch, cw = coords_hw[..., 0], coords_hw[..., 1]
    h0, w0 = torch.floor(ch), torch.floor(cw)
    fh, fw = ch - h0, cw - w0
    h0, w0 = h0.long(), w0.long()
    flat = image.reshape(b, h * w, c)

    def corner(dh: int, dw: int, weight: torch.Tensor) -> torch.Tensor:
        hi, wi = h0 + dh, w0 + dw
        valid = (hi >= 0) & (hi < h) & (wi >= 0) & (wi < w)
        idx = hi.clamp(0, h - 1) * w + wi.clamp(0, w - 1)  # [B, N]
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        weight = torch.where(valid, weight, torch.zeros_like(weight))
        return vals * weight[..., None].to(vals.dtype)

    return (corner(0, 0, (1 - fh) * (1 - fw)) + corner(0, 1, (1 - fh) * fw)
            + corner(1, 0, fh * (1 - fw)) + corner(1, 1, fh * fw))


def level_coords(hw01: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """``hw01 [B, N, 2]`` scaled by the level's (H, W), in fp32."""
    _, h, w, _ = level.shape
    return hw01.float() * torch.tensor([h, w], dtype=torch.float32, device=hw01.device)


def lookup_pyramid(features: Sequence[torch.Tensor], hw01: torch.Tensor,
                   impl: str = "xla") -> torch.Tensor:
    """Look up every level ``[B, H_i, W_i, C_i]`` at ``hw01 [B, N, 2]`` and
    concatenate the channels -> ``[B, N, sum C_i]``."""
    if impl == "pallas":
        from gecco_tpu_torch.ops.kernels.projective_gather import projective_gather

        return projective_gather(features, hw01)
    if impl != "xla":
        raise ValueError(f"impl must be one of {LOOKUP_IMPLS}, got {impl!r}")
    return torch.cat([bilinear_lookup(level, level_coords(hw01, level)) for level in features],
                     dim=-1)
