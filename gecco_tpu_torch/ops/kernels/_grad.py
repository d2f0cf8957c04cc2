"""Autograd helpers of the kernel wrappers."""

from __future__ import annotations

import torch

__all__ = ["needs_grad", "vjp"]


def needs_grad(*tensors) -> bool:
    """Whether autograd will record a call on ``tensors``: decided by the
    wrapper before ``Function.apply`` (inside ``forward`` grad mode is off
    and ``ctx.needs_input_grad`` ignores ``torch.no_grad``)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def vjp(fn, inputs, cotangents) -> tuple:
    """Gradients of ``fn(*inputs)`` against ``cotangents`` by autograd (the
    plain versions of the backward kernels); zeros for unused inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = torch.autograd.grad(outs, leaves, cotangents, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))
