"""One training step: loss -> backward -> optimizer -> EMA (counterpart of
``make_train_step`` and ``ema_update`` in ``gecco_tpu/train/trainer.py``).

The JAX step is a pure function that returns new trees; here the model's
parameters and the EMA copy are updated in place (the counterpart of the
JAX step's donated buffers), and the optimizer state is returned.

Under a mesh of more than one rank the step does by hand what XLA inserts
in the JAX step: sigma, the noise and the dropout masks are drawn for the
global batch from the (identically seeded) generator and the rank's rows
kept (by its data index), and between the backward and the optimizer the
gradients are averaged over the ranks (one all-reduce per dtype), so that
the global-norm clip sees the global gradient; the loss is averaged too. A
mesh of one, or none, issues no collective.

With ``shard_points`` under a mesh whose ``seq`` axis is more than one,
each rank holds its slice of every cloud's points too: the noise (and a
point-side dropout mask) is drawn at every point and the rank's slice kept,
and the forward and backward run under the row's points' group
(``parallel.sharding_points``), whose collectives the model's point
reductions issue. Each rank's loss is the mean over its rows and points, its
backward seeded with it; the collectives' adjoints are exact, so the sum
over the world of the ranks' gradients is the world's size times one
process's, and the mean over the world is one process's gradient. The
returned loss, the mean over the world, is one process's loss.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

import torch
from torch import nn

from gecco_tpu_torch.parallel.collectives import sharding_points
from gecco_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_
from gecco_tpu_torch.train.optim import Transform, apply_updates

__all__ = ["ema_update", "make_ema", "make_train_step"]


def make_ema(model: nn.Module) -> nn.Module:
    """A detached copy of ``model`` to carry the EMA of its parameters."""
    ema = copy.deepcopy(model)
    for p in ema.parameters():
        p.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, alpha: float) -> None:
    """``e <- alpha * e + (1 - alpha) * p`` over the float parameters (one
    multi-tensor op per step of the formula)."""
    pairs = [(e, p) for e, p in zip(ema.parameters(), model.parameters())
             if p.is_floating_point()]
    es, ps = [e for e, _ in pairs], [p for _, p in pairs]
    torch._foreach_mul_(es, alpha)
    torch._foreach_add_(es, torch._foreach_mul(ps, 1.0 - alpha))


def make_train_step(optimizer: Transform, loss_scale: float = 1.0, ema_alpha: float = 0.999,
                    train_in_inference_mode: bool = False, mesh: Optional[Mesh] = None,
                    shard_points: bool = False):
    """The full train step ``step(model, ema, opt_state, points, generator,
    sigma=None, noise=None, raw_ctx=None) -> (loss, opt_state)``.

    ``points`` [B, N, D] are data-space clouds on the model's device and
    ``raw_ctx`` their conditioning (a ``Context3d`` for the image-conditional
    model, None for the unconditional one). Sigma and the noise are drawn
    from ``generator`` unless both are given (the tests feed the JAX
    package's draws), then the network's dropout masks, unless
    ``train_in_inference_mode`` (or no generator is given). After the step
    each parameter's ``.grad`` holds the gradient of that step's loss.

    ``mesh``: under more than one rank, ``points`` are this rank's rows of
    the global batch (and ``sigma`` and ``noise``, where given, theirs);
    the draws are the global batch's rows, the gradients and the returned
    loss the means over the ranks. ``shard_points``: ``points`` (and
    ``noise``, where given) are also the rank's slice of the point axis, by
    its ``seq`` index."""
    mesh = Mesh() if mesh is None else mesh
    shard = (mesh.data_index, mesh.data)
    seq = shard_points and mesh.seq > 1
    point_shard = (mesh.seq_index, mesh.seq) if seq else (0, 1)
    group = mesh.seq_group if seq else None
    if seq and group is None:
        raise ValueError("shard_points over a mesh without its seq group: make it with make_mesh")

    def step(model: nn.Module, ema: nn.Module, opt_state, points: torch.Tensor,
             generator: Optional[torch.Generator] = None, sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, raw_ctx: Any = None):
        params = list(model.parameters())
        if sigma is None or noise is None:
            sigma, noise = model.draw_sigma_noise(generator, points, shard, point_shard)
        for p in params:
            p.grad = None
        dropout = (None if train_in_inference_mode or generator is None
                   else model.dropout_masks(generator, shard))
        with sharding_points(group):
            loss = model.loss_from(points, sigma, noise, raw_ctx, loss_scale=loss_scale,
                                   dropout=dropout)
            loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        loss = loss.detach()
        all_reduce_mean_([*grads, loss], mesh)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state)
            apply_updates(params, updates)
            ema_update(ema, model, ema_alpha)
        return loss, opt_state

    return step
