"""Gradient transformations written to match optax 0.2.6 step for step
(the JAX package trains with ``optax``; torch has no AdaBelief, and
``torch.optim`` is no substitute).

A transformation is an ``(init, update)`` pair over a list of tensors, as in
optax over a pytree: ``init(params) -> state`` and ``update(grads, state) ->
(updates, state)``; ``chain`` threads them in order and ``apply_updates``
adds the updates to the parameters in place. Each elementwise step is one
multi-tensor (``torch._foreach_*``) op over the whole list, in optax's order
of operations, rather than one op per tensor: the flagship has 202
parameter tensors. Step counts are host ints, so no step waits for the
device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence, Union

import numpy as np
import torch

__all__ = [
    "Transform",
    "adabelief",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "conditional_optimizer",
    "flagship_optimizer",
    "global_norm",
    "scale_by_belief",
    "scale_by_learning_rate",
    "warmup_cosine_decay_schedule",
]

Schedule = Callable[[int], float]


class Transform(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(max_norm: float) -> Transform:
    """``g`` where the global norm is below ``max_norm``, else
    ``g * (max_norm / norm)`` (optax's select, decided on the device; optax
    divides by the norm, then multiplies: the two differ in the last bit)."""

    def update(grads, state):
        norm = global_norm(grads)
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        return torch._foreach_mul(grads, scale), state

    return Transform(lambda params: (), update)


class BeliefState(NamedTuple):
    count: int
    mu: list
    nu: list


def scale_by_belief(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
                    eps_root: float = 1e-16) -> Transform:
    """AdaBelief's rescaling (optax ``scale_by_belief``): the first moment
    ``mu <- (1-b1) g + b1 mu``; the prediction error against the NEW mu,
    ``nu <- (1-b2) (g-mu)^2 + b2 nu + eps_root``; both bias-corrected by
    the incremented count; update ``mu_hat / (sqrt(nu_hat) + eps)``."""

    def init(params):
        return BeliefState(0, [torch.zeros_like(p) for p in params],
                           [torch.zeros_like(p) for p in params])

    def update(grads, state):
        count = state.count + 1
        # 1 - decay**count in fp32, as optax computes it
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        f = torch
        mu = f._foreach_add(f._foreach_mul(grads, 1 - b1), f._foreach_mul(state.mu, b1))
        err = f._foreach_sub(grads, mu)
        nu = f._foreach_add(f._foreach_mul(f._foreach_mul(err, err), 1 - b2),
                            f._foreach_mul(state.nu, b2))
        f._foreach_add_(nu, eps_root)
        den = f._foreach_sqrt(f._foreach_div(nu, c2))
        f._foreach_add_(den, eps)
        return f._foreach_div(f._foreach_div(mu, c1), den), BeliefState(count, mu, nu)

    return Transform(init, update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> Transform:
    """Multiply by ``-learning_rate``, or by ``-schedule(count)`` with the
    count of earlier updates (0 at the first)."""

    def update(grads, count):
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        return torch._foreach_mul(grads, -lr), count + 1

    return Transform(lambda params: 0, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state):
        states = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s)
            states.append(s)
        return grads, tuple(states)

    return Transform(init, update)


def adabelief(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-16, eps_root: float = 1e-16) -> Transform:
    return chain(scale_by_belief(b1, b2, eps, eps_root), scale_by_learning_rate(learning_rate))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (which counts the warmup), as optax's schedule of the same name."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / cos_steps)) + alpha)

    return schedule


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """``p += u`` in place, for every parameter."""
    with torch.no_grad():
        torch._foreach_add_(list(params), [u.to(p.dtype) for p, u in zip(params, updates)])


def flagship_optimizer(num_steps: int = 1_000_000) -> Transform:
    """The flagship config's optimizer: global-norm clip at 1, then
    AdaBelief at a warmup-cosine learning rate (0 -> 3e-4 over 2000 steps,
    down to 6e-6 at ``num_steps``)."""
    return chain(
        clip_by_global_norm(1.0),
        adabelief(warmup_cosine_decay_schedule(0.0, 3e-4, 2000, num_steps, end_value=6e-6)),
    )


def conditional_optimizer() -> Transform:
    """The image-conditional config's optimizer: global-norm clip at 1, then
    AdaBelief at a constant learning rate of 3e-4."""
    return chain(clip_by_global_norm(1.0), adabelief(3e-4))
