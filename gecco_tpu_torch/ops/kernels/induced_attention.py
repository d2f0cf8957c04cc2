"""Per-head rectangular attention: Hopper kernels and their plain PyTorch
versions, forward and backward.

Counterpart of ``gecco_tpu/ops/pallas/induced_attention.py``
(``rect_attention_pallas``). The set transformer's per-head path
(``attn_impl="pallas"``) runs its two thin attention shapes through it: the
pool (I inducer queries against the N points) and the unpool (the N points
against the I inducer tokens).

- ``rect_attention_fwd`` (``csrc/induced_attention.cu``): ``(o, lse)`` of
  unmasked softmax attention per (batch, head), with the algebra of the TPU
  kernel: fp32 logits times 1/sqrt(D), each row's max and sum, ``p =
  exp(s - m) / l`` rounded to v's dtype before ``p @ v``, and ``lse = m +
  log l`` in fp32 (no exp clamp: this kernel never had one).
- ``rect_attention_bwd`` (``csrc/induced_attention_bwd.cu``): ``(dq, dk,
  dv)`` from ``(q, k, v, o, lse, g)``: ``p = exp(s - lse)``, ``ds = p (dp -
  delta)`` with ``delta = sum_d g o`` in fp32 (plain PyTorch, as in the JAX
  package), ``ds`` and ``p`` rounded to bf16 before the three products, dq
  and dk scaled by 1/sqrt(D), the cotangent rounded to bf16.
- ``rect_attention_pallas``: the differentiable function over the two.

CUDA tensors launch the kernels (a CUDA tensor never takes a plain
version): one instance per head width 16 to 128 in steps of 16, 192 and
256 (the backward's in two 128-column slices); a head width between is
zero-padded to the next (its zero columns add
nothing to q k^T and give zero output columns, and the softmax scale is
1/sqrt of the real width, passed in). CPU tensors run the plain versions (the backward is autograd
through the plain forward, as the twins' ``jax.vjp``). The kernels read q,
k and v through their strides: the [B, H, N, D] views that the set
transformer's ``_split_heads`` makes of its [B, N, C] projections (and the
stride-0 batch of the pool's broadcast inducers) are read in place, with no
copy. The outputs are written in the merged-heads layout [B, N, H, D] and
returned as [B, H, N, D] views, so that merging the heads costs no copy.
"""

from __future__ import annotations

import math

import torch

from gecco_tpu_torch.ops.kernels._build import launch
from gecco_tpu_torch.ops.kernels._grad import needs_grad, vjp

__all__ = ["rect_attention_fwd", "rect_attention_bwd", "rect_attention_pallas"]

_BF16, _F32 = torch.bfloat16, torch.float32
# query and key tile of the kernels
_TILE = 64


def _rect_attention_ref(q, k, v):
    """Plain version: q [B, H, M, D], k/v [B, H, N, D] -> (o [B, H, M, D]
    in v's dtype, lse [B, H, M] fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    m = s.amax(-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhmn,bhnd->bhmd", (p / l).to(v.dtype).float(), v.float())
    return o.to(v.dtype), (m + torch.log(l))[..., 0]


def _strided(name: str, tensors: dict, device) -> dict:
    """The operands as the kernels read them: bf16 on ``device``, the last
    stride 1, the other strides and the base 16-byte aligned. An operand in
    another layout is copied to a contiguous one first."""
    out = {}
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if t.dtype != _BF16:
            raise ValueError(f"{name}: {key} must be {_BF16}, got {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            t = t.contiguous()
        out[key] = t
    return out


# the head widths of the kernels' instances (csrc/induced_attention.cu and
# induced_attention_bwd.cu: change both together)
_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128, 192, 256)


def _d_pad(d: int) -> int:
    """The instance that takes head width D: the narrowest of ``_WIDTHS``
    at least D wide."""
    return next(w for w in _WIDTHS if w >= d)


def _check_shapes(name: str, q, k, v) -> None:
    """Raise unless q, k and v form [B, H, M, D] x [B, H, N, D] with D <= 256
    (any narrower D is zero-padded to an instance's width)."""
    b, h, m, d = q.shape
    if k.shape != (b, h, k.shape[2], d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not form [B, H, M, D] x [B, H, N, D]")
    if not 1 <= d <= _WIDTHS[-1]:
        raise ValueError(f"{name}: the CUDA kernel needs 1 <= D <= {_WIDTHS[-1]}, got D={d}")


def _pad_width(t, dp: int):
    """t [..., D] zero-padded on its last axis to dp columns; t itself where
    D is dp."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def _strides(t) -> tuple:
    """(batch, head, row) strides of a [B, H, rows, D] operand."""
    return t.stride(0), t.stride(1), t.stride(2)


def rect_attention_fwd(q, k, v) -> tuple:
    """q [B, H, M, D]; k/v [B, H, N, D] -> (o [B, H, M, D] in v's dtype,
    lse [B, H, M] fp32)."""
    if q.device.type == "cpu":
        return _rect_attention_ref(q, k, v)
    name = "rect_attention_fwd"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must be a CUDA tensor, got {q.device}")
    _check_shapes(name, q, k, v)
    d = q.shape[-1]
    dp = _d_pad(d)
    ops = _strided(name, dict(q=_pad_width(q, dp), k=_pad_width(k, dp), v=_pad_width(v, dp)),
                   q.device)
    q, k, v = ops["q"], ops["k"], ops["v"]
    b, h, m, _ = q.shape
    n = k.shape[2]
    o = torch.empty((b, m, h, dp), dtype=_BF16, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, m), dtype=_F32, device=q.device)
    launch("induced_attention", "rect_attention_fwd_launch", q, k, v, o, lse,
           *_strides(q), *_strides(k), *_strides(v), *_strides(o), b, h, m, n, dp, d)
    rect_attention_fwd.launches += 1
    return (o if dp == d else o[..., :d]), lse


rect_attention_fwd.launches = 0


def _rect_attention_bwd_ref(q, k, v, g) -> tuple:
    """Plain version of the backward: autograd through the plain forward's
    o -> (dq, dk, dv)."""
    return vjp(lambda *a: _rect_attention_ref(*a)[0], (q, k, v), (g,))


def rect_attention_bwd(q, k, v, o, lse, g) -> tuple:
    """Gradients of ``rect_attention_fwd``'s o against ``g`` [B, H, M, D],
    from the forward's inputs, o and lse -> (dq, dk, dv), each of its
    input's shape (dq [B, H, M, D] also where q broadcasts over the batch,
    for autograd to sum). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _rect_attention_bwd_ref(q, k, v, g)
    name = "rect_attention_bwd"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must be a CUDA tensor, got {q.device}")
    _check_shapes(name, q, k, v)
    delta = (g.float() * o.float()).sum(-1).contiguous()
    d = q.shape[-1]
    dp = _d_pad(d)
    ops = _strided(name, dict(q=_pad_width(q, dp), k=_pad_width(k, dp), v=_pad_width(v, dp),
                              g=_pad_width(g.to(_BF16), dp)), q.device)
    q, k, v, g16 = ops["q"], ops["k"], ops["v"], ops["g"]
    if lse.dtype != _F32 or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous {_F32} tensor")
    b, h, m, _ = q.shape
    n = k.shape[2]
    dev = q.device
    dk = torch.empty((b, n, h, dp), dtype=_BF16, device=dev).transpose(1, 2)
    dv = torch.empty_like(dk)
    # one key tile: each block writes its query rows' dq whole; more: the
    # key tiles' parts meet in an fp32 buffer through atomics
    dq = torch.empty((b, m, h, dp), dtype=_BF16, device=dev).transpose(1, 2)
    dq32 = torch.zeros_like(dq, dtype=_F32) if n > _TILE else None
    launch("induced_attention_bwd", "rect_attention_bwd_launch", q, k, v, g16, lse, delta,
           dq32 if dq32 is not None else dq, dk, dv,
           *_strides(q), *_strides(k), *_strides(v), *_strides(g16), *_strides(dq), *_strides(dk),
           b, h, m, n, dp, d, int(dq32 is not None))
    rect_attention_bwd.launches += 1
    if dq32 is not None:
        dq = dq32.to(_BF16)
    if dp != d:
        dq, dk, dv = (t[..., :d] for t in (dq, dk, dv))
    return dq, dk, dv


rect_attention_bwd.launches = 0


class _RectAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, need_grad):
        o, lse = rect_attention_fwd(q, k, v)
        if need_grad:
            ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        return (*rect_attention_bwd(*ctx.saved_tensors, g), None)


def rect_attention_pallas(q, k, v) -> torch.Tensor:
    """[B, H, M, D] x [B, H, N, D] -> [B, H, M, D]: unmasked scaled
    dot-product attention per (batch, head), differentiable in q, k and v."""
    return _RectAttention.apply(q, k, v, needs_grad(q, k, v))
