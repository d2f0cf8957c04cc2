from gecco_tpu_torch.models.activation import GaussianActivation
from gecco_tpu_torch.models.mlp import MLP
from gecco_tpu_torch.models.normalization import AdaGN
from gecco_tpu_torch.models.set_transformer import (
    AttentionPool,
    Broadcast,
    BroadcastingLayer,
    SetTransformer,
    Unpool,
)
from gecco_tpu_torch.models.wrappers import UnconditionalPointNetwork

__all__ = [
    "GaussianActivation",
    "MLP",
    "AdaGN",
    "AttentionPool",
    "Broadcast",
    "BroadcastingLayer",
    "SetTransformer",
    "Unpool",
    "UnconditionalPointNetwork",
]
