"""Move parameters between the JAX model and the port's ``Diffusion``.

The JAX package's model is a pytree whose leaves are named by their dotted
path (``network.backbone.layers.broadcast.pool.kv_proj.weight``,
``network.backbone.layers.mlp.activation.alpha``, ``reparam.std``, ...).
Its set-transformer layers are stacked: each leaf under
``network.backbone.layers`` carries a leading ``[L]`` axis. The port names
its parameters and buffers by the same paths, with the layer index after
``layers`` (``network.backbone.layers.3.broadcast.pool.kv_proj.weight``).
Flattening the JAX pytree into the ``{path: array}`` mapping is the
caller's job (the port imports no JAX). ``load_jax_params`` copies such a
mapping into the port; ``to_jax_params`` is its inverse, over the port's
values or gradients, with the per-layer tensors stacked back to ``[L, ...]``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params", "to_jax_params"]

_STACKED = re.compile(r"^(network\.backbone\.layers)\.(\d+)\.(.+)$")


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``params`` (dotted JAX path -> array) into ``model`` in place.

    Stacked leaves are split per layer. Raises ``KeyError`` on a missing or
    unused key and ``ValueError`` on a wrong shape; nothing is copied then.
    """
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    staged = {}
    used = set()
    for name, tensor in targets.items():
        m = _STACKED.match(name)
        key = f"{m.group(1)}.{m.group(3)}" if m else name
        if key not in params:
            raise KeyError(f"JAX parameters have no {key!r} (for {name!r})")
        value = np.asarray(params[key])
        if m:
            layer = int(m.group(2))
            if value.ndim == 0 or layer >= value.shape[0]:
                raise ValueError(f"{key!r}: no layer {layer} in shape {value.shape}")
            value = value[layer]
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{name!r}: JAX shape {tuple(value.shape)} != port shape {tuple(tensor.shape)}"
            )
        staged[name] = value
        used.add(key)
    unused = sorted(set(params) - used)
    if unused:
        raise KeyError(f"JAX parameters not used by the port: {unused}")
    with torch.no_grad():
        for name, value in staged.items():
            t = targets[name]
            t.copy_(torch.from_numpy(np.array(value, dtype=np.float32)).to(t.device, t.dtype))
    return model


def to_jax_params(model: nn.Module, grads: bool = False) -> dict:
    """``{dotted JAX path: fp32 numpy array}`` of the port's parameters and
    buffers, the per-layer tensors of ``network.backbone.layers`` stacked
    back to ``[L, ...]``. With ``grads=True`` each parameter's ``.grad``
    (zeros where it has none, and for buffers), the shape of the JAX
    package's gradient pytree."""
    named = [(n, p, True) for n, p in model.named_parameters()]
    named += [(n, b, False) for n, b in model.named_buffers()]
    flat, stacked = {}, {}
    for name, tensor, is_param in named:
        value = tensor.grad if (grads and is_param) else (None if grads else tensor)
        arr = (np.zeros(tuple(tensor.shape), np.float32) if value is None
               else value.detach().float().cpu().numpy())
        m = _STACKED.match(name)
        if m:
            stacked.setdefault(f"{m.group(1)}.{m.group(3)}", {})[int(m.group(2))] = arr
        else:
            flat[name] = arr
    for key, layers in stacked.items():
        flat[key] = np.stack([layers[q] for q in range(len(layers))])
    return flat
