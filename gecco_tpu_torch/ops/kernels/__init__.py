"""Hand-written Hopper kernels (sources in ``gecco_tpu_torch/csrc``), each
beside its plain PyTorch version. Importing this package builds nothing."""

from gecco_tpu_torch.ops.kernels.folded_attention import (
    folded_pool_ext,
    folded_unpool,
    fused_mlp_residual,
)
from gecco_tpu_torch.ops.kernels.hside import fused_h_side

KERNELS = (folded_pool_ext, fused_h_side, folded_unpool, fused_mlp_residual)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = [
    "folded_pool_ext",
    "folded_unpool",
    "fused_h_side",
    "fused_mlp_residual",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]
