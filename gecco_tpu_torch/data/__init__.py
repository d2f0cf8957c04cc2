from gecco_tpu_torch.data.loader import (
    ConcatDataset,
    ConcatenatedSampler,
    DataLoader,
    FixedSampler,
    dataloader,
)
from gecco_tpu_torch.data.procedural import CAMERA_K, make_clouds, make_conditional_batch

__all__ = [
    "CAMERA_K",
    "ConcatDataset",
    "ConcatenatedSampler",
    "DataLoader",
    "FixedSampler",
    "dataloader",
    "make_clouds",
    "make_conditional_batch",
]
