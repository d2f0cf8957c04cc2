"""Fused h-side (inducer tokens) of a broadcasting layer: Hopper kernels and
plain PyTorch version.

Counterpart of ``gecco_tpu/ops/pallas/hside.py``. Between the pool and the
unpool, a layer runs norm_1 -> MLP -> norm_2 on the pooled ``[B, I, C]``
tokens and projects them to the unpool's k and v. ``fused_h_side`` is a
``torch.autograd.Function``: its forward launches, for CUDA tensors, the
body that ``_hside_body`` picks by shape: the Hopper body
(``csrc/hside.cu``: each product one pass over all B I token rows, five
launches, each with its plain piece beside it, ``_hside_*_ref``) or the
WMMA body (``csrc/hside_wmma.cu``, one block per batch element) for the
shapes the first does not take; it runs the plain version for CPU tensors.
The bodies count their launches in ``fused_h_side.launches`` and
``.launches_wmma``. Its backward recomputes the plain version under
autograd on the [B, I, C] tokens, exactly as the JAX package's
``custom_vjp`` does: the JAX package has no h-side backward kernel.
"""

from __future__ import annotations

import torch

from gecco_tpu_torch.ops.kernels import f32
from gecco_tpu_torch.ops.kernels._build import launch
from gecco_tpu_torch.ops.kernels.folded_attention import _check, _i_pad, _pad_points
from gecco_tpu_torch.ops.kernels._grad import needs_grad, vjp
from gecco_tpu_torch.ops.norms import group_norm_stats, stats_from_sums

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


# rows of one statistics slab of the Hopper body (csrc/hside.cu kSlab)
_SLAB = 16


def _hside_norm_ref(z, scale, bias, num_groups: int, dtype, sums=None,
                    i_valid=None) -> torch.Tensor:
    """Plain version of ``hside_norm_kernel``: (z - mean) * (inv * scale) +
    bias rounded to ``dtype``, over z [B, I, C] (h0, or the fp32 hh), the
    set-level group statistics from the channel sums ``sums`` [B, 2, C]
    where given (norm_2's, the out pass's slabs added), else from z's rows
    before ``i_valid`` (the rest a ragged I's padding; None: all)."""
    iv = z.shape[1] if i_valid is None else i_valid
    if sums is None:
        zf = z[:, :iv].float()
        sums = torch.stack([zf.sum(1), (zf * zf).sum(1)], dim=1)
    mean, inv = stats_from_sums(sums[:, 0], sums[:, 1], iv, num_groups)
    return ((z.float() - mean[:, None]) * (inv * scale)[:, None] + bias[:, None]).to(dtype)


def _hside_out_ref(g, w2t, b2) -> tuple:
    """Plain version of ``hside_out_kernel``: hh = g @ w2t + b2 [B, I, C]
    fp32 and each 16-row slab's sums of hh and hh^2 [B, I / 16, 2, C]."""
    hh = torch.einsum("biw,wc->bic", g.float(), w2t.float()) + b2[None]
    b, i, c = hh.shape
    slabs = hh.reshape(b, i // _SLAB, _SLAB, c)
    return hh, torch.stack([slabs.sum(2), (slabs * slabs).sum(2)], dim=2)


def _hside_kv_ref(h, wk, wv) -> tuple:
    """Plain version of ``hside_kv_kernel``: (bf16(h @ wk^T), bf16(h @
    wv^T)) in h's dtype, as one product against [Wk; Wv]."""
    kv = torch.einsum("bic,oc->bio", h.float(), torch.cat([wk, wv]).to(h.dtype).float())
    return kv[..., :wk.shape[0]].to(h.dtype), kv[..., wk.shape[0]:].to(h.dtype)


def _hside_hopper_takes(i: int, c: int, w: int, groups: int) -> bool:
    """The Hopper body's shapes (csrc/hside.cu ``hopper_takes``: change both
    together): I a multiple of 16, C and W of 128, C <= 2048, G dividing
    C."""
    return i % _SLAB == 0 and c % 128 == 0 and w % 128 == 0 and c <= 2048 and c % groups == 0


def _register_chunk(i: int, c: int) -> int:
    """Widest column chunk of the [I, C] output that one pass of the WMMA
    body's register tiles holds (8 warps, each I/16 rows x ceil(CC/128)
    columns of 16 x 16 tiles, at most 12)."""
    for cc in range(c - c % 16, 15, -16):
        if c % cc == 0 and -(-cc // 128) * (i // 16) <= 12:
            return cc
    raise ValueError(f"fused_h_side: no column chunk for I={i}, C={c}")


# a block's shared memory on sm_90 (csrc/common.cuh kMaxSmem)
_MAX_SMEM = 232448


def _hside_wmma_smem(i: int, c: int) -> int:
    """Bytes of one block of the WMMA body (csrc/hside_wmma.cu
    ``hside_wmma_launch``: change both together): y [I, C] bf16, hh [I, C],
    the chunk [I, 64] and the statistics [2, C] fp32, g [I, 64] bf16."""
    return i * c * 2 + (i * c + i * 64 + 2 * c) * 4 + i * 64 * 2


def _hside_takes(i: int, c: int, w: int, groups: int) -> bool:
    """Whether the WMMA body takes these shapes: I in (16, 32, 48, 64) (one
    instance each), C % 16, W % 64 and C % G == 0, and its block within
    the SM's shared memory (at I 64 up to C 640: not the 8k width's 768)."""
    return (i in (16, 32, 48, 64) and c % 16 == 0 and w % 64 == 0 and c % groups == 0
            and _hside_wmma_smem(i, c) <= _MAX_SMEM)


def _hside_body(i: int, c: int, w: int, groups: int, dtype=_BF16) -> str:
    """Which body of ``fused_h_side`` takes these shapes on the card: "f32"
    (``f32.hside_fwd``, any shape with G dividing C) for fp32 operands; for
    bf16 ones "hopper" (csrc/hside.cu: C % 128 == 0, W % 128 == 0, C <= 2048; the
    flagship, the 8k width, the demo, any I: a ragged I zero-padded to 16s,
    its padding rows out of both norms' statistics) where it can, else
    "wmma" (csrc/hside_wmma.cu: I in (16, 32, 48, 64), C % 16 == 0, W % 64
    == 0, its block within the SM's shared memory). Both need G dividing C.
    Raises ValueError with both bodies' conditions otherwise."""
    if dtype == _F32 and c % groups == 0:
        return "f32"
    if dtype != _F32 and _hside_hopper_takes(_i_pad(i), c, w, groups):
        return "hopper"
    if dtype != _F32 and _hside_takes(i, c, w, groups):
        return "wmma"
    raise ValueError(
        f"fused_h_side: no CUDA body takes I={i}, C={c}, W={w}, G={groups}: the Hopper body "
        f"needs C % 128 == 0, W % 128 == 0 and C <= 2048; the WMMA body I in (16, 32, 48, "
        f"64), C % 16 == 0, W % 64 == 0 and its block within {_MAX_SMEM} bytes of shared "
        f"memory; both C % G == 0")


def _hside_launch(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv):
    name = "fused_h_side"
    b, i, c = h0.shape
    w = w1t.shape[1]
    dt = f32.route(name, dict(h0=h0, w1t=w1t, w2t=w2t, wk=wk, wv=wv))
    _check(name,
           dict(h0=h0, s1=s1, b1n=b1n, s2=s2, b2n=b2n, w1t=w1t, b1=b1, w2t=w2t, b2=b2, wk=wk, wv=wv),
           dict(h0=_BF16, s1=_F32, b1n=_F32, s2=_F32, b2n=_F32, w1t=_BF16, b1=_F32, w2t=_BF16,
                b2=_F32, wk=_BF16, wv=_BF16), dt)
    body = _hside_body(i, c, w, gind.shape[1], dt)
    if body == "f32":
        fused_h_side.launches_f32 += 1
        return f32.hside_fwd(h0, s1, b1n, s2, b2n, gind.shape[1], w1t, b1, w2t, b2, wk, wv)
    run = _hside_hopper if body == "hopper" else _hside_wmma
    return run(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv)


def _hside_hopper(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv,
                  mid: dict | None = None) -> tuple:
    """The Hopper body (csrc/hside.cu) -> (h, k, v); ``mid``, where given,
    receives the passes' y1, g, hh and slab sums (at the B I rows; a ragged
    I's at its padded count), which ``chip_smoke.py`` holds against their
    plain pieces. The passes run over the B I rows padded to the 128-row
    block; a ragged I is zero-padded to 16s first and sliced back after."""
    i_valid = h0.shape[1]
    h0 = _pad_points(h0, _i_pad(i_valid))
    b, i, c = h0.shape
    w = w1t.shape[1]
    m = b * i
    mp = -(-m // 128) * 128
    dev = h0.device
    buf = dict(y1=torch.empty((mp, c), dtype=_BF16, device=dev),
               g=torch.empty((mp, w), dtype=_BF16, device=dev),
               hh=torch.empty((mp, c), dtype=_F32, device=dev),
               part=torch.empty((mp // _SLAB, 2, c), dtype=_F32, device=dev))
    # the outputs: [B, I, C], or views of the first B I rows of [Mp, C]
    shape = (b, i, c) if mp == m else (mp, c)
    h, k, v = (torch.empty(shape, dtype=_BF16, device=dev) for _ in range(3))
    launch("hside", "hside_launch", h0, s1, b1n, s2, b2n, w1t, b1, w2t, b2, wk, wv, buf["y1"],
           buf["g"], buf["hh"], buf["part"], h, k, v, b, i, c, w, gind.shape[1], i_valid)
    fused_h_side.launches += 1
    if mid is not None:
        mid.update({name: t[:m // _SLAB if name == "part" else m] for name, t in buf.items()})
    out = (h, k, v) if mp == m else tuple(t[:m].view(b, i, c) for t in (h, k, v))
    return out if i == i_valid else tuple(t[:, :i_valid].contiguous() for t in out)



def _hside_wmma(h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv) -> tuple:
    """The WMMA body (csrc/hside_wmma.cu, one block per batch element) ->
    (h, k, v)."""
    b, i, c = h0.shape
    h, k, v = (torch.empty_like(h0) for _ in range(3))
    launch("hside_wmma", "hside_wmma_launch", h0, s1, b1n, s2, b2n, w1t, b1, w2t, b2, wk, wv,
           h, k, v, b, i, c, w1t.shape[1], gind.shape[1], _register_chunk(i, c))
    fused_h_side.launches_wmma += 1
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
fused_h_side.launches_wmma = 0
fused_h_side.launches_f32 = 0
