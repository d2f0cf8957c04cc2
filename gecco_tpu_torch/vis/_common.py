"""What the callbacks share: matplotlib on its file backend, the model's
device and generator, tensors as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch


def plt():
    """``matplotlib.pyplot`` on the Agg backend (imported when a figure is
    made)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as pyplot

    return pyplot


def device_of(model) -> torch.device:
    p = next(model.parameters(), None)
    return torch.device("cpu") if p is None else p.device


def generator(model, seed: int) -> torch.Generator:
    """A generator on the model's device seeded by ``seed`` (the JAX
    callbacks' ``jax.random.PRNGKey(seed)``): the same draws every call."""
    return torch.Generator(device=device_of(model)).manual_seed(seed)


def numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def sample_stochastic(model, seed: int, normal, shape: tuple, ctx, s_churn: float,
                      n_steps: int) -> np.ndarray:
    """``model.sample_stochastic`` from a generator seeded by ``seed``, or
    ``sample_stochastic_from`` the draws of ``normal`` where given."""
    kw = dict(raw_ctx=ctx, s_churn=s_churn, n_solver_steps=n_steps)
    if normal is None:
        return numpy(model.sample_stochastic(generator(model, seed), shape, **kw))
    return numpy(model.sample_stochastic_from(normal, shape, **kw))
