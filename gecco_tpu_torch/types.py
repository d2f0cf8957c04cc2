"""Batched records (counterpart of ``gecco_tpu.types``: ``Context3d``,
``Example``, ``SampleDetails``, ``LogpDetails``, the errors ``DataError``
and ``NaNError``, ``to_device`` and ``batch_index``). Every tensor carries
the batch axis first; NamedTuples, as in the JAX package. ``tree_map``
walks such records (NamedTuples, tuples, lists, dicts) as ``jax.tree.map``
walks pytrees."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "Context3d", "DataError", "Example", "LogpDetails", "NaNError", "SampleDetails",
    "batch_index", "to_device", "tree_leaves", "tree_map",
]


class DataError(RuntimeError):
    """Raised on malformed dataset contents."""


class NaNError(RuntimeError):
    """Raised on a non-finite training loss."""


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, of the same
    structure): NamedTuples, tuples, lists and dicts are walked, None and
    empty tuples kept, everything else is a leaf."""
    if tree is None:
        return None
    if _is_record(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


class Context3d(NamedTuple):
    """Conditioning context: image and camera intrinsics."""

    image: Optional[Any]  # [B, H, W, 3] float or uint8, channels-last as in the JAX package
    K: Any  # [B, 3, 3] camera intrinsics
    wmat: Any = ()  # optional [B, 3, 4] world-to-camera


class Example(NamedTuple):
    """One batched training example."""

    points: Any  # [B, N, 3]
    ctx: Optional[Context3d] = None
    extras: Any = ()


class SampleDetails(NamedTuple):
    latent: Any  # [B, N, D] initial state, drawn from N(0, sigma_max^2)
    sample_diff: Any  # [B, N, D] final state in diffusion space
    sample_data: Any  # [B, N, D] final state in data space
    trajectory_diff: Any  # [T-1, B, N, D] state after every transition
    trajectory_data: Any


class LogpDetails(NamedTuple):
    """The exact likelihood's terms (``Diffusion.evaluate_logp``): logp =
    prior_logp + delta_jacobian + delta_reparam, each [B]."""

    logp: Any  # [B] log-density of the data-space cloud
    prior_logp: Any  # [B] the latent under N(0, sigma_max^2)
    delta_reparam: Any  # [B] log|det| of the data -> diffusion map
    delta_jacobian: Any  # [B] the integrated divergence of the flow
    trajectory_diff: Any  # [T-1, B, N, D] state after every transition
    trajectory_data: Any
    latent: Any  # [B, N, D] the state at sigma_max


def to_device(data: Any, device) -> Any:
    """Every array leaf of a record as a tensor on ``device``: numpy arrays
    go through pinned host memory and a non-blocking copy when ``device``
    is a card; tensors already there are kept."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=cuda)
        if isinstance(x, (np.ndarray, np.number)):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if cuda:
                t = t.pin_memory()
            return t.to(device, non_blocking=cuda)
        return x

    return tree_map(put, data)


def batch_index(data: Any, index: Any) -> Any:
    """Every array leaf of a record indexed along its batch axis."""
    return tree_map(lambda x: x[index] if hasattr(x, "__getitem__") and hasattr(x, "shape")
                    else x, data)
