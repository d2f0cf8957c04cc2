"""Dense layer, ``Frozen``, parameter count and device resolution.

Counterpart of ``gecco_tpu/utils/modules.py``. The JAX package stacks the
per-layer modules of a ``SetTransformer`` leaf-wise (a leading ``[L]`` axis)
and scans over them; here each layer is its own ``nn.Module`` inside an
``nn.ModuleList`` and the scan is a Python loop, so no stacking helpers are
needed. ``gecco_tpu_torch.convert`` splits stacked JAX leaves per layer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["Frozen", "Linear", "count_parameters", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device a module or entry point runs on: CUDA unless the caller
    names another. Raises instead of running on the CPU when no card is
    present and the caller did not ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def uniform_(shape, lim: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-lim, lim) drawn on the CPU from ``generator`` (so one seed gives the
    same weights whichever device the module lands on)."""
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim


class Linear(nn.Module):
    """``x @ W^T + b`` over the last axis, computed in the dtype of ``x``.

    Weight ``[out, in]`` as in the JAX package; both weight and bias are
    initialised U(-1/sqrt(in), 1/sqrt(in)) (equinox ``nn.Linear``).
    Parameters stay fp32 and are cast at use.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        lim = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(
            uniform_((out_features, in_features), lim, generator).to(dev)
        )
        if bias:
            self.bias = nn.Parameter(uniform_((out_features,), lim, generator).to(dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.to(x.dtype).T
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Frozen(nn.Module):
    """Wrap a module so its parameters take no gradient: every call runs
    ``inner`` on detached views of its parameters, so they stay in the
    state dict (and in the optimizer's list, with zero gradients) but never
    reach autograd. The inputs stay differentiable (the JAX package's
    ``stop_gradient`` on the inner module's leaves)."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, *args, **kwargs):
        params = {name: p.detach() for name, p in self.inner.named_parameters()}
        return torch.func.functional_call(self.inner, params, args, kwargs)


def count_parameters(module: nn.Module) -> int:
    """Total number of parameter elements (``gecco_tpu.utils.count_parameters``)."""
    return sum(p.numel() for p in module.parameters())
