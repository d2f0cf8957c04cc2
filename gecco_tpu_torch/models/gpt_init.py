"""GPT-2-style initialisation (counterpart of ``gecco_tpu/models/gpt_init.py``):
every MLP bias zeroed, and the residual branches' output projections (the
pool's and the unpool's out-projections and each MLP's last layer) divided
by sqrt(2 * n_layers). An alternative to the default 0.1 skip scaling: apply
it to a ``SetTransformer`` built with ``skip_scale=1.0``."""

from __future__ import annotations

import math

import torch

from gecco_tpu_torch.models.mlp import MLP
from gecco_tpu_torch.models.set_transformer import SetTransformer

__all__ = ["gpt_init"]


def _init_mlp(mlp: MLP, out_scale: float) -> None:
    for layer in mlp.layers:
        if layer.bias is not None:
            layer.bias.zero_()
    mlp.layers[-1].weight.mul_(out_scale)


@torch.no_grad()
def gpt_init(backbone: SetTransformer) -> SetTransformer:
    """Apply the GPT-2 init to ``backbone`` in place; returns it."""
    out_scale = 1.0 / math.sqrt(2 * len(backbone.layers))
    for layer in backbone.layers:
        bc = layer.broadcast
        bc.pool.out_proj.weight.mul_(out_scale)
        bc.unpool.out_proj.weight.mul_(out_scale)
        _init_mlp(bc.mlp, out_scale)
        _init_mlp(layer.mlp, out_scale)
    return backbone
