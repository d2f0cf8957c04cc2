"""The reference's structure as a yardstick (counterpart of
``gecco_tpu/baselines``)."""

from gecco_tpu_torch.baselines.reference_jax import (
    ref_denoise,
    ref_denoise_single,
    ref_sample,
    ref_sample_from,
)

__all__ = ["ref_denoise", "ref_denoise_single", "ref_sample", "ref_sample_from"]
