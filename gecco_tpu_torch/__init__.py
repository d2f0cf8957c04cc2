"""gecco_tpu_torch — the PyTorch and CUDA port of gecco_tpu for NVIDIA Hopper.

The JAX package ``gecco_tpu`` is the reference; this package mirrors its
layout so each module's counterpart sits at the same path. Its kernels are
written by hand for ``sm_90a`` (``gecco_tpu_torch/csrc``) and built with
``nvcc`` at first use. Entry points run on the card unless the caller
passes ``device="cpu"``. This package imports neither JAX nor gecco_tpu.
"""

from gecco_tpu_torch.diffusion import (
    Diffusion,
    LogNormalSchedule,
    LogUniformSchedule,
    NoCond,
    Schedule,
)
from gecco_tpu_torch.reparam import GaussianReparam, Reparam, UVLReparam
from gecco_tpu_torch.types import Context3d, Example, LogpDetails, SampleDetails

__version__ = "0.1.0"

__all__ = [
    "Diffusion",
    "LogNormalSchedule",
    "LogUniformSchedule",
    "NoCond",
    "Schedule",
    "GaussianReparam",
    "Reparam",
    "UVLReparam",
    "Context3d",
    "Example",
    "LogpDetails",
    "SampleDetails",
    "__version__",
]
