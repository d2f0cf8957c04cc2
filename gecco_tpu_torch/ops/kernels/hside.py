"""Fused h-side (inducer tokens) of a broadcasting layer: Hopper kernel and
plain PyTorch version.

Counterpart of ``gecco_tpu/ops/pallas/hside.py``. Between the pool and the
unpool, a layer runs norm_1 -> MLP -> norm_2 on the pooled ``[B, I, C]``
tokens and projects them to the unpool's k and v. ``fused_h_side`` is a
``torch.autograd.Function``: its forward launches ``csrc/hside.cu`` for CUDA
tensors (one block per batch element) and runs the plain version for CPU
tensors, counting its kernel launches in ``fused_h_side.launches``. Its
backward recomputes the plain version under autograd on the [B, I, C]
tokens, exactly as the JAX package's ``custom_vjp`` does: the JAX package
has no h-side backward kernel.
"""

from __future__ import annotations

import torch

from gecco_tpu_torch.ops.kernels._build import check_cuda, launch
from gecco_tpu_torch.ops.kernels._grad import needs_grad, vjp
from gecco_tpu_torch.ops.norms import group_norm_stats

__all__ = ["fused_h_side"]

_BF16, _F32 = torch.bfloat16, torch.float32


def _hside_ref(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv):
    """Plain version (the JAX package's ``_hside_ref``)."""
    num_groups = gind.shape[1]
    dt = h0.dtype
    m1, i1 = group_norm_stats(h0, num_groups)
    y1 = ((h0.float() - m1[:, None]) * (i1 * s1)[:, None] + b1n[:, None]).to(dt)
    a = torch.einsum("bic,cw->biw", y1.float(), w1t.float()) + b1[None]
    g = torch.exp(-0.5 * a * a).to(dt)
    hh = torch.einsum("biw,wc->bic", g.float(), w2t.float()) + b2[None]
    m2, i2 = group_norm_stats(hh, num_groups)
    y2 = ((hh - m2[:, None]) * (i2 * s2)[:, None] + b2n[:, None]).to(dt)
    k = torch.einsum("bic,oc->bio", y2.float(), wk.to(dt).float()).to(dt)
    v = torch.einsum("bic,oc->bio", y2.float(), wv.to(dt).float()).to(dt)
    return y2, k, v


def _register_chunk(i: int, c: int) -> int:
    """Widest column chunk of the [I, C] output that one pass of the
    kernel's register tiles holds (8 warps, each I/16 rows x ceil(CC/128)
    columns of 16 x 16 tiles, at most 12)."""
    for cc in range(c - c % 16, 15, -16):
        if c % cc == 0 and -(-cc // 128) * (i // 16) <= 12:
            return cc
    raise ValueError(f"fused_h_side: no column chunk for I={i}, C={c}")


def _hside_launch(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv):
    name = "fused_h_side"
    b, i, c = h0.shape
    w = w1t.shape[1]
    g = gind.shape[1]
    check_cuda(
        name,
        dict(h0=h0, s1=s1, b1n=b1n, s2=s2, b2n=b2n, w1t=w1t, b1=b1, w2t=w2t, b2=b2, wk=wk, wv=wv),
        dict(h0=_BF16, s1=_F32, b1n=_F32, s2=_F32, b2n=_F32, w1t=_BF16, b1=_F32,
             w2t=_BF16, b2=_F32, wk=_BF16, wv=_BF16),
    )
    if not (i == 64 and c % 16 == 0 and w % 64 == 0 and c % g == 0):
        raise ValueError(
            f"{name}: the CUDA kernel needs I == 64, C % 16, W % 64 and C % G == 0 "
            f"(I={i}, C={c}, W={w}, G={g})"
        )
    h, k, v = (torch.empty_like(h0) for _ in range(3))
    launch("hside", "hside_launch", h0, s1, b1n, s2, b2n, w1t, b1, w2t, b2, wk, wv,
           h, k, v, b, i, c, w, g, _register_chunk(i, c))
    fused_h_side.launches += 1
    return h, k, v


class _HSide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, need_grad, *args):
        run = _hside_ref if args[0].device.type == "cpu" else _hside_launch
        if need_grad:
            ctx.save_for_backward(*args)
        return run(*args)

    @staticmethod
    def backward(ctx, *grads):
        h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv = ctx.saved_tensors
        d = vjp(lambda *a: _hside_ref(*a[:5], gind, *a[5:]),
                 (h0, s1, b1n, s2, b2n, w1t, b1, w2t, b2, wk, wv), grads)
        return (None, *d[:5], None, *d[5:])


def fused_h_side(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv):
    """h0 [B, I, C]; s1/b1n, s2/b2n [B, C] fp32 (AdaGN affines of norm_1 and
    norm_2); gind [C, G] group indicator; w1t [C, W], b1 [1, W] fp32 (alpha
    folded); w2t [W, C], b2 [1, C] fp32; wk/wv [C, C]
    -> (h, k, v), each [B, I, C]. Differentiable in every argument but
    ``gind``."""
    args = (h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv)
    return _HSide.apply(needs_grad(*args), *args)


fused_h_side.launches = 0
