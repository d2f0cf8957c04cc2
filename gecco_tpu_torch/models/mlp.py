"""Feed-forward network over the last axis (counterpart of
``gecco_tpu/models/mlp.py``), with its activation and dropout.

The JAX package draws dropout masks from a network key that only its loss
threads (``key=None`` elsewhere: sampling, the likelihood, ``score``). The
port's counterpart of that key is a mask source, ``dropout(p_keep, shape)
-> bool keep-mask``, threaded the same way: ``bernoulli_dropout(generator)``
draws the masks from an explicit ``torch.Generator``; a test passes a
function returning the masks that ``jax.random.bernoulli`` drew. With no
source, or ``dropout_p == 0``, the MLP is deterministic.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
from torch import nn

from gecco_tpu_torch.models.activation import GaussianActivation
from gecco_tpu_torch.utils.modules import Linear, resolve_device

__all__ = ["MLP", "DropoutFn", "bernoulli_dropout", "shard_dropout", "shard_point_dropout"]

# (p_keep, shape) -> bool mask of ``shape``, True where the unit is kept
DropoutFn = Callable[[float, tuple], torch.Tensor]


def bernoulli_dropout(generator: torch.Generator) -> DropoutFn:
    """A mask source drawing from ``generator`` (on its device)."""

    def draw(p_keep: float, shape: tuple) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=generator.device) < p_keep

    return draw


def shard_dropout(draw: DropoutFn, rank: int, world: int) -> DropoutFn:
    """A mask source for rank ``rank`` of ``world``, whose masks' leading
    axis is its rows of a global batch: each mask is drawn from ``draw``
    at the global batch and the rank's rows kept (``draw`` itself on a
    world of one)."""
    if world == 1:
        return draw

    def sharded(p_keep: float, shape: tuple) -> torch.Tensor:
        b = shape[0]
        return draw(p_keep, (b * world, *shape[1:]))[rank * b:(rank + 1) * b]

    return sharded


def shard_point_dropout(draw: DropoutFn, index: int, count: int) -> DropoutFn:
    """A mask source for slice ``index`` of ``count`` of the point axis
    (the masks' second axis) under point sharding: each mask is drawn from
    ``draw`` at every rank's points and the slice kept (``draw`` itself on
    a group of one)."""
    if count == 1:
        return draw

    def sharded(p_keep: float, shape: tuple) -> torch.Tensor:
        n = shape[1]
        return draw(p_keep, (shape[0], n * count, *shape[2:]))[:, index * n:(index + 1) * n]

    return sharded


def _make_activation(activation, device=None):
    """``activation`` for one MLP: ``None`` is ``GaussianActivation()``; a
    module is copied, so that each MLP holds its own parameters (each JAX
    MLP holds its own leaf); any other callable is kept as it is."""
    if activation is None:
        return GaussianActivation(device=device)
    if isinstance(activation, nn.Module):
        return copy.deepcopy(activation).to(resolve_device(device))
    return activation


class MLP(nn.Module):
    def __init__(
        self,
        in_size: int,
        out_size: int,
        width_size: int,
        depth: int = 1,
        activation=None,
        dropout_p: float = 0.0,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        lin = lambda i, o: Linear(i, o, device=device, generator=generator)
        if depth == 0:
            layers = [lin(in_size, out_size)]
        else:
            layers = [lin(in_size, width_size)]
            layers += [lin(width_size, width_size) for _ in range(depth - 1)]
            layers.append(lin(width_size, out_size))
        self.layers = nn.ModuleList(layers)
        self.activation = _make_activation(activation, device)
        self.dropout_p = dropout_p

    def forward(self, x: torch.Tensor, dropout: Optional[DropoutFn] = None) -> torch.Tensor:
        """``dropout``: the mask source (one draw per hidden layer, in
        order), or None for the deterministic MLP."""
        p = self.dropout_p
        for layer in self.layers[:-1]:
            x = self.activation(layer(x))
            if p > 0.0 and dropout is not None:
                keep = dropout(1.0 - p, tuple(x.shape)).to(x.device)
                x = torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))
        return self.layers[-1](x)
