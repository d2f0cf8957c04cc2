"""Move parameters between the JAX model and the port's ``Diffusion``.

The JAX package's model is a pytree whose leaves are named by their dotted
path (``network.backbone.layers.broadcast.pool.kv_proj.weight``,
``network.backbone.layers.mlp.activation.alpha``, ``reparam.std``, ...).
Some of its modules are stacked: each leaf under one of ``STACKED_PREFIXES``
(the set-transformer layers ``network.backbone.layers``, each ConvNeXt stage
``cond.backbone.stages.<k>``, and the same under a ``Frozen`` wrapper's
``cond.inner``) carries a leading axis over the layers or blocks. The port
names its parameters and buffers by the same paths, with the layer or block
index after the prefix (``network.backbone.layers.3.broadcast.pool.kv_proj.weight``,
``cond.backbone.stages.2.8.dw_kernel``). The convolution kernels keep the
JAX package's HWIO layout in the port, so they move unchanged. This covers
a ConvNeXt of any size and stage count, in either mode, and each network
wrapper (``UnconditionalPointNetwork``, ``RayNetwork``,
``GlobalConditioningNetwork``), whose leaves carry the same names in both
packages.

A model whose MLPs take an activation without parameters (the JAX
package's activation module without leaves, a ``torch.nn.SiLU``) has no
``activation.alpha`` leaf in either package, and a ``ref_jax_compat`` model
keeps its unused ``mlp_norm`` in both, so both move like any other.

The JAX pytree of the image-conditional model holds its reparam twice, as
``reparam`` and ``network.reparam``; the port's ``RayNetwork`` keeps the
model's reparam out of its module tree, so the port holds it once. Such a
duplicate JAX leaf (``ALIASES``) is accepted when it equals the leaf it
duplicates, and ``to_jax_params`` writes both paths back.

Flattening the JAX pytree into the ``{path: array}`` mapping is the
caller's job (the port imports no JAX). ``load_jax_params`` copies such a
mapping into the port; ``to_jax_params`` is its inverse, over the port's
values or gradients, with the stacked tensors stacked back.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["ALIASES", "STACKED_PREFIXES", "load_jax_params", "to_jax_params"]

STACKED_PREFIXES = (
    r"network\.backbone\.layers",
    r"cond\.(?:inner\.)?backbone\.stages\.\d+",
)
_STACKED = re.compile(rf"^({'|'.join(STACKED_PREFIXES)})\.(\d+)\.(.+)$")
# duplicate JAX prefix -> the prefix of the leaves it duplicates
ALIASES = {"network.reparam.": "reparam."}


def _alias_of(model: nn.Module, key: str):
    """The path that JAX leaf ``key`` duplicates in ``model``, or None."""
    for dup, orig in ALIASES.items():
        if key.startswith(dup) and _holds_alias(model, dup):
            return orig + key[len(dup):]
    return None


def _holds_alias(model: nn.Module, dup: str) -> bool:
    """Whether the module at ``dup`` (e.g. ``network.reparam``) is, outside
    the module tree, the same object as the model's own."""
    owner_path, attr = dup.rstrip(".").rsplit(".", 1)
    try:
        owner = model.get_submodule(owner_path)
    except AttributeError:
        return False
    held = owner.__dict__.get(attr)
    return held is not None and held is getattr(model, attr, None)


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
    for key in sorted(set(params) - used):
        orig = _alias_of(model, key)
        if orig is None or orig not in params:
            continue
        if not np.array_equal(np.asarray(params[key]), np.asarray(params[orig])):
            raise ValueError(f"{key!r} differs from {orig!r}, the leaf it duplicates")
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
    buffers, the per-layer (per-block) tensors stacked back along a leading
    axis and the duplicated leaves written under both paths. With
    ``grads=True`` each parameter's ``.grad`` (zeros where it has none, and
    for buffers), the shape of the JAX package's gradient pytree."""
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
    for dup, orig in ALIASES.items():
        if _holds_alias(model, dup):
            flat.update({dup + k[len(orig):]: v.copy() for k, v in list(flat.items())
                         if k.startswith(orig)})
    return flat
