"""Training (counterpart of ``gecco_tpu/train``): the train step, the
optimizer and the ``Trainer`` loop; ``python -m gecco_tpu_torch.train
<config.py>`` trains a config."""

from gecco_tpu_torch.train.optim import (
    adabelief,
    apply_updates,
    chain,
    clip_by_global_norm,
    conditional_optimizer,
    flagship_optimizer,
    scale_by_belief,
    scale_by_learning_rate,
    warmup_cosine_decay_schedule,
)
from gecco_tpu_torch.train.step import ema_update, make_ema, make_train_step
from gecco_tpu_torch.train.trainer import Trainer, train

__all__ = [
    "Trainer",
    "adabelief",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "conditional_optimizer",
    "ema_update",
    "flagship_optimizer",
    "make_ema",
    "make_train_step",
    "scale_by_belief",
    "scale_by_learning_rate",
    "train",
    "warmup_cosine_decay_schedule",
]
