"""Config loading and checkpoint discovery (counterpart of
``gecco_tpu/config.py``).

The config contract is the reference's: a config *is* a Python file
(README.md:24-25) exporting ``make_train_loader / make_val_loader /
make_model / train`` (gecco-jax/src/gecco_jax/train/__main__.py:16-23).
Checkpoint directory naming matches gecco-jax/src/gecco_jax/config.py:7-67.
"""

from __future__ import annotations

import os
import re
from importlib.machinery import SourceFileLoader
from typing import Tuple, Union

__all__ = [
    "load_config",
    "latest_checkpoint",
    "CHECKPOINT_SAVE_RE",
    "CHECKPOINT_SAVE_TEMPLATE",
    "FINAL_SAVE_RE",
]

CHECKPOINT_SAVE_TEMPLATE = "checkpoint-step-{}"
CHECKPOINT_SAVE_RE = re.compile(r"checkpoint-step-(\d+)")
FINAL_SAVE_RE = re.compile(r"final-checkpoint-(\d+)")


def load_config(path: str):
    """Import a ``.py`` config file as a module (config.py:11-15)."""
    return SourceFileLoader("config", path).load_module()


def latest_checkpoint(
    save_path: str, return_step_number: bool = False
) -> Union[str, Tuple[str, int]]:
    """Find the newest ``checkpoint-step-N`` directory (config.py:47-67)."""
    candidates = []
    if os.path.isdir(save_path):
        for name in os.listdir(save_path):
            m = CHECKPOINT_SAVE_RE.fullmatch(name) or FINAL_SAVE_RE.fullmatch(name)
            if m is not None:
                candidates.append((int(m.group(1)), name))
    if not candidates:
        raise IOError(f"No checkpoints found in {save_path!r}")
    step, name = max(candidates)
    path = os.path.join(save_path, name)
    if return_step_number:
        return path, step
    return path
