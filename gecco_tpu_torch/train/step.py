"""One training step: loss -> backward -> optimizer -> EMA (counterpart of
``make_train_step`` and ``ema_update`` in ``gecco_tpu/train/trainer.py``).

The JAX step is a pure function that returns new trees; here the model's
parameters and the EMA copy are updated in place (the counterpart of the
JAX step's donated buffers), and the optimizer state is returned.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

import torch
from torch import nn

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


def make_train_step(optimizer: Transform, loss_scale: float = 1.0, ema_alpha: float = 0.999):
    """The full train step ``step(model, ema, opt_state, points, generator,
    sigma=None, noise=None, raw_ctx=None) -> (loss, opt_state)``.

    ``points`` [B, N, D] are data-space clouds on the model's device and
    ``raw_ctx`` their conditioning (a ``Context3d`` for the image-conditional
    model, None for the unconditional one). Sigma and the noise are drawn
    from ``generator`` unless both are given (the tests feed the JAX
    package's draws). After the step each parameter's ``.grad`` holds the
    gradient of that step's loss."""

    def step(model: nn.Module, ema: nn.Module, opt_state, points: torch.Tensor,
             generator: Optional[torch.Generator] = None, sigma: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, raw_ctx: Any = None):
        params = list(model.parameters())
        if sigma is None or noise is None:
            sigma, noise = model.draw_sigma_noise(generator, points)
        for p in params:
            p.grad = None
        loss = model.loss_from(points, sigma, noise, raw_ctx, loss_scale=loss_scale)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state)
            apply_updates(params, updates)
            ema_update(ema, model, ema_alpha)
        return loss.detach(), opt_state

    return step
