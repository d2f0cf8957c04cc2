"""Shape validation (counterpart of ``gecco_tpu/utils/checks.py``)."""

from __future__ import annotations

__all__ = ["check_image_batch", "check_points", "check_sigma_batch"]


def check_points(x, name: str = "points", dims: int = 3):
    """Raise unless ``x`` is a batched point set [B, N, D]."""
    if x.ndim != dims or x.shape[-1] < 1:
        raise ValueError(f"{name} must be [B, N, D] (got shape {tuple(x.shape)})")
    return x


def check_sigma_batch(sigma, batch: int):
    if sigma.ndim not in (0, 1):
        raise ValueError(f"sigma must be scalar or [B] (got {tuple(sigma.shape)})")
    if sigma.ndim == 1 and sigma.shape[0] != batch:
        raise ValueError(
            f"sigma batch {sigma.shape[0]} does not match points batch {batch}"
        )
    return sigma


def check_image_batch(image, name: str = "ctx.image"):
    """Raise unless ``image`` (where it is an array) is a channels-last
    batch [B, H, W, C]."""
    if image is not None and hasattr(image, "ndim") and image.ndim != 4:
        raise ValueError(
            f"{name} must be [B, H, W, C] channels-last (got {tuple(image.shape)})"
        )
    return image
