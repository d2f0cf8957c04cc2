from gecco_tpu_torch.models.activation import GaussianActivation
from gecco_tpu_torch.models.convnext import (
    ConvNeXt,
    ConvNeXtBlock,
    ConvNeXtExtractor,
    FeaturePyramidContext,
    load_torchvision_state_dict,
)
from gecco_tpu_torch.models.embed import LinearSpaceEmbedding, LinearTimeEmbedding
from gecco_tpu_torch.models.mlp import MLP, bernoulli_dropout
from gecco_tpu_torch.models.normalization import AdaGN, AdaLN
from gecco_tpu_torch.models.set_transformer import (
    AttentionPool,
    Broadcast,
    BroadcastingLayer,
    SetTransformer,
    Unpool,
)
from gecco_tpu_torch.models.gpt_init import gpt_init
from gecco_tpu_torch.models.wrappers import (
    GlobalConditioningNetwork,
    LinearLift,
    RayNetwork,
    UnconditionalPointNetwork,
)

__all__ = [
    "ConvNeXt",
    "ConvNeXtBlock",
    "ConvNeXtExtractor",
    "FeaturePyramidContext",
    "load_torchvision_state_dict",
    "GaussianActivation",
    "LinearSpaceEmbedding",
    "LinearTimeEmbedding",
    "gpt_init",
    "MLP",
    "bernoulli_dropout",
    "AdaGN",
    "AdaLN",
    "AttentionPool",
    "Broadcast",
    "BroadcastingLayer",
    "SetTransformer",
    "Unpool",
    "GlobalConditioningNetwork",
    "LinearLift",
    "RayNetwork",
    "UnconditionalPointNetwork",
]
