"""Image decoding for the data pipeline (counterpart of
``gecco_tpu/data/image_io.py``): cv2 where it imports, PIL otherwise, as
the JAX package decodes, so both packages read the same bits from a jpg.
The result is uint8 RGB; the division by 255 happens on the device, in the
ConvNeXt's compute dtype (``ConvNeXt.forward``), so a batch crosses to the
card at a quarter of the fp32 bytes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_rgb_uint8"]

try:
    import cv2

    def load_rgb_uint8(path: str) -> np.ndarray:
        """[H, W, 3] uint8 RGB."""
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to decode image: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

except ImportError:

    def load_rgb_uint8(path: str) -> np.ndarray:
        """[H, W, 3] uint8 RGB (a grayscale image replicated to three
        channels, an alpha channel dropped)."""
        from PIL import Image

        img = np.asarray(Image.open(path))
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        return img[..., :3]
