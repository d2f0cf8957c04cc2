from gecco_tpu_torch.models.activation import GaussianActivation
from gecco_tpu_torch.models.convnext import (
    ConvNeXt,
    ConvNeXtBlock,
    ConvNeXtExtractor,
    FeaturePyramidContext,
)
from gecco_tpu_torch.models.mlp import MLP
from gecco_tpu_torch.models.normalization import AdaGN
from gecco_tpu_torch.models.set_transformer import (
    AttentionPool,
    Broadcast,
    BroadcastingLayer,
    SetTransformer,
    Unpool,
)
from gecco_tpu_torch.models.wrappers import RayNetwork, UnconditionalPointNetwork

__all__ = [
    "ConvNeXt",
    "ConvNeXtBlock",
    "ConvNeXtExtractor",
    "FeaturePyramidContext",
    "GaussianActivation",
    "MLP",
    "AdaGN",
    "AttentionPool",
    "Broadcast",
    "BroadcastingLayer",
    "SetTransformer",
    "Unpool",
    "RayNetwork",
    "UnconditionalPointNetwork",
]
