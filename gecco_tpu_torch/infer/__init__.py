"""Inference CLI (counterpart of ``gecco_tpu/infer``):
``python -m gecco_tpu_torch.infer <config.py> [checkpoint]``."""
