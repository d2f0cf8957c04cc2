"""Projective gather: Hopper kernels (forward and backward) and their plain
PyTorch version.

Counterpart of ``gecco_tpu/ops/pallas/projective_gather.py``.
``projective_gather(features, hw01)`` looks every point up in every level of
a channels-last feature pyramid and returns the concatenated ``[B, N, sum
C]`` features. It is a ``torch.autograd.Function``: for CUDA tensors the
forward launches ``csrc/projective_gather.cu``'s ``gather_kernel`` once for
all levels (counted in ``projective_gather.launches``) and the backward its
``gather_bwd_kernel`` once (``projective_gather_bwd.launches``); for CPU
tensors both run the plain version, ``lookup_pyramid(..., impl="xla")`` of
``gecco_tpu_torch.ops.projective``, and autograd through it. A CUDA tensor
never falls back to the plain version.

The kernels weigh the corners in fp32 and round once, at the output (the
TPU kernel rounded its one-hot weights to bf16 before its product, the
plain version rounds every corner's product): the three differ by a few
bf16 steps of the output. The backward takes the cotangent in the levels'
dtype, as the TPU kernel does, and sums ``dF`` with fp32 atomics in an
order that changes from run to run.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gecco_tpu_torch.ops.kernels._build import check_cuda, launch
from gecco_tpu_torch.ops.kernels._grad import vjp
from gecco_tpu_torch.ops.projective import lookup_pyramid

__all__ = ["projective_gather", "projective_gather_bwd"]

_BF16, _F32 = torch.bfloat16, torch.float32
_MAX_LEVELS = 4


def _gather_ref(hw01, *levels) -> torch.Tensor:
    """Plain version: the four-corner gather of every level, concatenated."""
    return lookup_pyramid(levels, hw01, impl="xla")


def _level_args(levels) -> list:
    """The C interface's level pointers (None past the last level) and
    (H, W, C) per level (zeros past the last)."""
    ptrs = list(levels) + [None] * (_MAX_LEVELS - len(levels))
    hwc = [d for lv in levels for d in lv.shape[1:]] + [0] * 3 * (_MAX_LEVELS - len(levels))
    return [*ptrs, len(levels), *hwc]


def _check(name, hw01, levels, extra=None, extra_dtypes=None):
    tensors = {"hw01": hw01, **{f"level{q}": lv for q, lv in enumerate(levels)}, **(extra or {})}
    dtypes = {"hw01": _F32, **{f"level{q}": _BF16 for q in range(len(levels))},
              **(extra_dtypes or {})}
    check_cuda(name, tensors, dtypes)
    b, n = hw01.shape[:2]
    if not (hw01.shape == (b, n, 2) and 1 <= len(levels) <= _MAX_LEVELS):
        raise ValueError(f"{name}: hw01 must be [B, N, 2] and 1 to {_MAX_LEVELS} levels")
    for lv in levels:
        if lv.ndim != 4 or lv.shape[0] != b or lv.shape[3] % 2 or lv.data_ptr() % 4:
            raise ValueError(f"{name}: each level must be [B, H, W, C] with C even and "
                             f"4-byte aligned, got {tuple(lv.shape)}")


def _gather_launch(hw01, levels) -> torch.Tensor:
    name = "projective_gather"
    _check(name, hw01, levels)
    b, n = hw01.shape[:2]
    out = torch.empty((b, n, sum(lv.shape[3] for lv in levels)), dtype=_BF16,
                      device=hw01.device)
    args = _level_args(levels)
    launch("projective_gather", "gather_launch", hw01, *args[:_MAX_LEVELS], out, b, n,
           *args[_MAX_LEVELS:])
    projective_gather.launches += 1
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hw01, *levels):
        if hw01.device.type == "cpu":
            out = _gather_ref(hw01, *levels)
        else:
            out = _gather_launch(hw01, levels)
        ctx.save_for_backward(hw01, *levels)
        return out

    @staticmethod
    def backward(ctx, g):
        hw01, *levels = ctx.saved_tensors
        dhw01, dlevels = projective_gather_bwd(levels, hw01, g, ctx.needs_input_grad[0])
        return (dhw01, *dlevels)


def projective_gather(features: Sequence[torch.Tensor], hw01: torch.Tensor) -> torch.Tensor:
    """``features``: levels ``[B, H_l, W_l, C_l]``; ``hw01 [B, N, 2]``
    normalised (h, w) -> ``[B, N, sum C_l]`` in the levels' dtype.
    Differentiable in the levels and the coordinates."""
    return _Gather.apply(hw01.float().contiguous(), *(f.contiguous() for f in features))


projective_gather.launches = 0


def _gather_bwd_ref(levels, hw01, g) -> tuple:
    """Plain version of the backward: autograd through ``_gather_ref`` ->
    (dhw01, [dlevel per level])."""
    d = vjp(_gather_ref, (hw01, *levels), (g,))
    return d[0], list(d[1:])


def projective_gather_bwd(levels, hw01, g, coords_grad: bool = True) -> tuple:
    """Gradients of ``projective_gather`` against ``g [B, N, sum C]`` ->
    (dhw01 [B, N, 2] fp32, or None unless ``coords_grad``; the levels'
    gradients, each in its level's dtype)."""
    if hw01.device.type == "cpu":
        dhw01, dlevels = _gather_bwd_ref(levels, hw01, g)
        return (dhw01 if coords_grad else None), dlevels
    name = "projective_gather_bwd"
    g = g.to(levels[0].dtype).contiguous()
    _check(name, hw01, levels, dict(g=g), dict(g=_BF16))
    b, n = hw01.shape[:2]
    sizes = [lv.numel() for lv in levels]
    df = torch.zeros(sum(sizes), dtype=_F32, device=hw01.device)
    dhw01 = torch.empty((b, n, 2), dtype=_F32, device=hw01.device) if coords_grad else None
    args = _level_args(levels)
    launch("projective_gather", "gather_bwd_launch", hw01, *args[:_MAX_LEVELS], g, df, dhw01,
           b, n, *args[_MAX_LEVELS:])
    projective_gather_bwd.launches += 1
    dlevels = [part.view(lv.shape).to(lv.dtype) for part, lv in zip(df.split(sizes), levels)]
    return dhw01, dlevels


projective_gather_bwd.launches = 0
