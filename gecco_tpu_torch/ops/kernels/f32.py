"""The fp32 route through the set transformer's kernels: five SIMT kernels
(``csrc/f32_simt.cu``) and the fused functions chained from them.

The JAX package's Pallas kernels are dtype-generic, and its own tests run
them at fp32 (``tests/test_pallas_ops.py``). The port's Hopper and WMMA
bodies take bf16 operands only. For fp32 operands on the card each wrapper
(``rect_attention_fwd``/``_bwd``, ``folded_pool_ext`` and its backward,
``folded_pool_layer`` and its backward, ``fused_h_side``,
``folded_unpool`` and its backward, ``fused_mlp_residual`` and its
backward; ``fused_unpool_mlp`` through the unpool's and the MLP's) picks
the body ``"f32"`` and runs the function here that computes it, a short chain of these kernels in the
order of the function's plain pieces, all in fp32 arithmetic (FFMA; no
tensor cores, so no TF32):

- ``gemm``: a batched product of strided views with a bias, Gaussian
  activation (or its derivative), residual and accumulate epilogue; a long
  K with no epilogue is split into ranges whose partials ``reduce`` sums
  in order;
- ``softmax`` (and ``softmax_given``, from given statistics) along one axis,
  with its max and sum (or log-sum-exp), and ``softmax_bwd``;
- ``reduce``: sums along one axis of x, x y, x^2 or x (y - mu), in ranges
  summed in order;
- ``affine``: (x - mu) xs + y ys + bs with per-(batch, channel) vectors.

Every sum runs in a fixed order, so a call gives the same bits each time.
Each primitive runs its plain PyTorch version for CPU tensors (its plain
piece), so a route called on CPU tensors composes the plain pieces: the
tests hold that chain against the wrapper's plain version at fp32. A build
or launch failure raises; a CUDA fp32 operand never reaches a plain
version.
"""

from __future__ import annotations

import math
import struct

import torch

from gecco_tpu_torch.ops.kernels._build import launch
from gecco_tpu_torch.ops.norms import stats_from_sums

__all__ = [
    "route", "gemm", "softmax", "softmax_given", "softmax_bwd", "reduce", "affine",
    "rect_fwd", "rect_bwd", "pool_ext_fwd", "pool_ext_bwd", "pool_layer_fwd",
    "pool_layer_bwd", "hside_fwd", "unpool_fwd", "unpool_bwd", "mlp_fwd", "mlp_bwd",
]

_F32 = torch.float32
_LIB = "f32_simt"
# reduce's modes (csrc/f32_simt.cu kSum, kDot, kSquare, kCentred)
_SUM, _DOT, _SQUARE, _CENTRED = range(4)
# a reduction longer than this runs in ranges of _CHUNK, summed in order
_LONG, _CHUNK = 1024, 256
# gemm's output tile (csrc/f32_simt.cu kTM x kTN) and the tiles that fill
# the card twice over (132 SMs)
_TILE, _FILL = 64, 264


def route(name: str, tensors: dict) -> torch.dtype:
    """The dtype of a wrapper's operands that its bf16 bodies take in bf16
    (the activations and weights): fp32 or bf16 where they all agree;
    raises ValueError naming the first operand that differs from the
    first's."""
    first = next(iter(tensors))
    dt = tensors[first].dtype
    for key, t in tensors.items():
        if t.dtype != dt:
            raise ValueError(f"{name}: {key} is {t.dtype} where {first} is {dt}: the operands "
                             "take one dtype, bf16 or fp32")
    return dt


def _bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", x))[0]


def _v4(t: torch.Tensor) -> tuple:
    """The four strides (batch 1, batch 2, row, column) of a view of up to
    four dimensions, missing leading dimensions taking stride 0."""
    s = (0,) * (4 - t.dim()) + tuple(t.stride())
    return s


def _lines(t: torch.Tensor, dim: int) -> tuple:
    """(Z, L, I) and t's (z, l, i) strides for the lines along ``dim`` of a
    tensor whose leading and trailing dimensions each merge into one."""
    dim %= t.dim()
    lead, trail = t.shape[:dim], t.shape[dim + 1:]
    z, i = math.prod(lead), math.prod(trail)
    v = t.reshape(z, t.shape[dim], i) if t.dim() else t
    return (z, t.shape[dim], i), v.stride()


def gemm(a, b, *, alpha: float = 1.0, bias=None, act: int = 0, res=None, out=None,
         accumulate: bool = False) -> torch.Tensor:
    """out = epi(alpha a @ b): a [..., M, K] and b [..., K, N] views with at
    most two (broadcast) batch dimensions; ``bias`` and ``res`` broadcast to
    the output's shape; act 1 takes exp(-v^2 / 2), act 2 res exp(-v^2 / 2)
    (-v), else res is added; ``accumulate`` adds to ``out``. Returns out
    (new and contiguous where not given)."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    if len(batch) > 2:
        raise ValueError(f"f32.gemm: at most two batch dimensions, got {batch}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k:
        raise ValueError(f"f32.gemm: a {tuple(a.shape)} and b {tuple(b.shape)} do not chain")
    shape = (*batch, m, n)
    a, b = a.expand(*batch, m, k), b.expand(*batch, k, n)
    if a.device.type == "cpu":
        v = alpha * torch.matmul(a, b)
        if bias is not None:
            v = v + bias
        if act == 1:
            v = torch.exp(-0.5 * v * v)
        elif act == 2:
            v = res * torch.exp(-0.5 * v * v) * (-v)
        elif res is not None:
            v = v + res
        if out is None:
            return v.contiguous()
        if accumulate:
            out += v
        else:
            out.copy_(v)
        return out
    if out is None:
        out = torch.empty(shape, dtype=_F32, device=a.device)
    for key, t in dict(a=a, b=b, bias=bias, res=res, out=out).items():
        if t is not None and (t.dtype != _F32 or t.device != a.device):
            raise ValueError(f"f32.gemm: {key} must be {_F32} on {a.device}")
    z1, z2 = ((1, 1) + batch)[-2:]
    bias = None if bias is None else bias.expand(shape)
    res = None if res is None else res.expand(shape)
    tiles = z1 * z2 * -(-m // _TILE) * -(-n // _TILE)
    plain = bias is None and res is None and act == 0 and not accumulate
    splits = 1
    if plain and z1 == 1 and tiles < _FILL and k >= 8 * _CHUNK:
        splits = min(-(-_FILL // tiles), k // (4 * _CHUNK))
    if splits > 1:
        kc = -(-k // splits)
        splits = -(-k // kc)
        part = torch.empty((splits, *shape), dtype=_F32, device=a.device)
        dest, stride = part, part[0].numel()
    else:
        kc, dest, stride = k, out, 0
    launch(_LIB, "f32_gemm_launch", a, b, dest, bias, res, z1, z2, m, n, k,
           *_v4(a), *_v4(b), *(_v4(dest[0]) if splits > 1 else _v4(out)),
           *(_v4(bias) if bias is not None else (0,) * 4),
           *(_v4(res) if res is not None else (0,) * 4),
           act, int(accumulate), _bits(alpha), splits, kc, stride)
    if splits > 1:
        out.copy_(reduce(part.reshape(splits, -1), 0).reshape(shape))
    return out


def _softmax_launch(x, p, m, l, dim: int, given: bool, lse: bool) -> None:
    (z, n, i), sx = _lines(x, dim)
    sp = _lines(p, dim)[1] if p is not None else (0, 0, 0)
    launch(_LIB, "f32_softmax_launch", x, p, m, l, z, n, i, *sx, *sp, int(given), int(lse))


def softmax(x, dim: int, *, lse: bool = False) -> tuple:
    """Softmax of x along ``dim`` -> (p, m, l): the lines' max and sum
    (``lse``: m = max + log sum, l None), x's shape without ``dim``."""
    if x.device.type == "cpu":
        mx = x.amax(dim)
        e = torch.exp(x - mx.unsqueeze(dim))
        s = e.sum(dim)
        p = e / s.unsqueeze(dim)
        return (p, mx + torch.log(s), None) if lse else (p, mx, s)
    x = x.contiguous()
    p = torch.empty_like(x)
    stat = x.shape[:dim % x.dim()] + x.shape[dim % x.dim() + 1:]
    m = torch.empty(stat, dtype=_F32, device=x.device)
    l = None if lse else torch.empty_like(m)
    _softmax_launch(x, p, m, l, dim, False, lse)
    return p, m, l


def softmax_given(x, dim: int, m, l=None) -> torch.Tensor:
    """exp(x - m) / l along ``dim`` from given statistics (l None: 1)."""
    if x.device.type == "cpu":
        e = torch.exp(x - m.unsqueeze(dim))
        return e if l is None else e / l.unsqueeze(dim)
    x = x.contiguous()
    p = torch.empty_like(x)
    _softmax_launch(x, p, m.contiguous(), None if l is None else l.contiguous(), dim, True,
                    False)
    return p


def softmax_bwd(p, dp, dim: int, t=None) -> torch.Tensor:
    """ds = p (dp - t) along ``dim``, t [x's shape without dim] given, else
    sum p dp along ``dim``."""
    if p.device.type == "cpu":
        if t is None:
            t = (dp * p).sum(dim)
        return p * (dp - t.unsqueeze(dim))
    p, dp = p.contiguous(), dp.contiguous()
    ds = torch.empty_like(p)
    (z, n, i), sp = _lines(p, dim)
    launch(_LIB, "f32_softmax_bwd_launch", p, dp, ds, None if t is None else t.contiguous(),
           z, n, i, *sp, *_lines(dp, dim)[1], *_lines(ds, dim)[1])
    return ds


def reduce(x, dim: int, y=None, *, square: bool = False, mu=None) -> torch.Tensor:
    """The sum along ``dim`` of x, x y, x^2 (``square``) or x (y - mu)
    (mu of the output's shape) -> x's shape without ``dim``. A line longer
    than 1024 is summed in ranges of 256 whose partials are summed in
    order."""
    if x.device.type == "cpu":
        if mu is not None:
            v = x * (y - mu.unsqueeze(dim))
        elif y is not None:
            v = x * y
        else:
            v = x * x if square else x
        return v.sum(dim)
    mode = _CENTRED if mu is not None else _DOT if y is not None else _SQUARE if square else _SUM
    x = x.contiguous()
    y = None if y is None else y.contiguous()
    (z, n, i), sx = _lines(x, dim)
    sy = _lines(y, dim)[1] if y is not None else (0, 0, 0)
    shape = x.shape[:dim % x.dim()] + x.shape[dim % x.dim() + 1:]
    chunk = _CHUNK if n > _LONG else n
    ranges = -(-n // chunk)
    out = torch.empty((ranges, *shape), dtype=_F32, device=x.device)
    launch(_LIB, "f32_reduce_launch", x, y, None if mu is None else mu.contiguous(), out, z, n,
           i, *sx, *sy, chunk, mode)
    return out[0] if ranges == 1 else reduce(out, 0)


def affine(x, *, mu=None, xs=None, y=None, ys=None, bs=None) -> torch.Tensor:
    """(x - mu) xs + y ys + bs over x [B, R, C] (or [R, C]), the vectors
    [B, C] or [C] broadcast over the rows, each optional."""
    if x.device.type == "cpu":
        vec = lambda t: t if t.dim() == 1 else t[:, None]
        v = x if mu is None else x - vec(mu)
        if xs is not None:
            v = v * vec(xs)
        if y is not None:
            v = v + (y if ys is None else y * vec(ys))
        return v if bs is None else v + vec(bs)
    x = x.contiguous()
    nz, rows, cols = (1, *x.shape) if x.dim() == 2 else x.shape
    vecs = [t for t in (mu, xs, ys, bs) if t is not None]
    vz = cols if vecs and vecs[0].dim() == 2 else 0
    if any((t.dim() == 2) != (vz > 0) for t in vecs):
        raise ValueError("f32.affine: the vectors are all [B, C] or all [C]")
    out = torch.empty_like(x)
    c = lambda t: None if t is None else t.contiguous()
    launch(_LIB, "f32_affine_launch", x, c(mu), c(xs), c(y), c(ys), c(bs), out, nz, rows, cols,
           vz)
    return out


def _sums(o) -> torch.Tensor:
    """[B, 2, C] channel sums of o and o^2 over o [B, N, C]'s points."""
    return torch.stack([reduce(o, 1), reduce(o, 1, square=True)], dim=1)


def _sums_cotangent(o, g, g_sums) -> torch.Tensor:
    """g + gs1 + 2 o gs2: the cotangent of an output o [B, N, C] whose
    channel sums (``_sums``) take the cotangent g_sums [B, 2, C]."""
    return affine(o, xs=2.0 * g_sums[:, 1], y=g, bs=g_sums[:, 0].contiguous())


# --------------------------------------------------------- rect attention --


def rect_fwd(q, k, v) -> tuple:
    """``rect_attention_fwd`` at fp32: q [B, H, M, D], k/v [B, H, N, D]
    views (read through their strides) -> (o [B, H, M, D], a view of the
    merged-heads layout [B, M, H, D], lse [B, H, M])."""
    _, h, m, d = q.shape
    b = max(q.shape[0], k.shape[0])
    s = gemm(q, k.transpose(-1, -2), alpha=1.0 / math.sqrt(d))
    p, lse, _ = softmax(s, -1, lse=True)
    o = torch.empty((b, m, h, d), dtype=_F32, device=q.device).transpose(1, 2)
    gemm(p, v, out=o)
    return o, lse


def rect_bwd(q, k, v, o, lse, g) -> tuple:
    """``rect_attention_bwd`` at fp32 -> (dq, dk, dv): delta = sum_d g o
    from the fp32 o, p = exp(s - lse), ds = p (dp - delta); dq and dk
    scaled by 1/sqrt(D)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    b = max(q.shape[0], k.shape[0])
    g = g.float()
    delta = reduce(g, -1, o)
    s = gemm(q, k.transpose(-1, -2), alpha=scale)
    p = softmax_given(s, -1, lse)
    ds = softmax_bwd(p, gemm(g, v.transpose(-1, -2)), -1, delta)
    dq = gemm(ds, k.expand(b, *k.shape[1:]), alpha=scale)
    dk = gemm(ds.transpose(-1, -2), q.expand(b, *q.shape[1:]), alpha=scale)
    dv = gemm(p.transpose(-1, -2), g)
    return dq, dk, dv


# ------------------------------------------------------------------- pool --


def _fold_qft(ind2, kvw, num_heads: int) -> torch.Tensor:
    """qf^T [J, C]: qf^T[h I + i, c] = sum_d ind2[h I + i, d] Wk[h D + d, c]
    / sqrt(D), per head."""
    j, d = ind2.shape
    c = kvw.shape[1]
    qft = gemm(ind2.reshape(num_heads, j // num_heads, d), kvw[:c].reshape(num_heads, d, c),
               alpha=1.0 / math.sqrt(d))
    return qft.reshape(j, c)


def _heads(t, num_heads: int):
    """[B, R, H K] -> the per-head view [B, H, R, K]."""
    b, r, hk = t.shape
    return t.reshape(b, r, num_heads, hk // num_heads).transpose(1, 2)


def _pool_from_y(y, qft, kvw, wo, num_heads: int) -> tuple:
    """The pool of y [B, N, C] onto the inducers -> (h0, M, L, pooled):
    logits y qf, their softmax over the points with its column max and sum
    [B, J], v = y Wv^T, pooled = p_h^T v_h [B, I, C], h0 = pooled Wo^T."""
    b, n, c = y.shape
    j = qft.shape[0]
    i = j // num_heads
    s = gemm(y, qft.t())
    p, mm, ll = softmax(s, 1)
    v = gemm(y, kvw[c:].t())
    pooled = torch.empty((b, i, c), dtype=y.dtype, device=y.device)
    gemm(_heads(p, num_heads).transpose(-1, -2), _heads(v, num_heads),
         out=_heads(pooled, num_heads))
    return gemm(pooled, wo.t()), mm, ll, pooled


def _pool_bwd_from_y(y, qft, kvw, wo, macc, sacc, g_h0, num_heads: int, pooled=None) -> tuple:
    """The pool's backward from y -> (dy [B, N, C], dqf [C, J], dwv [C, C],
    dwo [C, C]): p from the forward's statistics, dpooled = g Wo, dp_h =
    v_h dpooled_h^T, dv_h = p_h dpooled_h, ds = p (dp - sum_n p dp), dy = ds
    qf^T + dv Wv, the weight gradients over every row."""
    b, n, c = y.shape
    j = qft.shape[0]
    i = j // num_heads
    p = softmax_given(gemm(y, qft.t()), 1, macc, sacc)
    wv = kvw[c:]
    v = gemm(y, wv.t())
    if pooled is None:
        pooled = torch.empty((b, i, c), dtype=_F32, device=y.device)
        gemm(_heads(p, num_heads).transpose(-1, -2), _heads(v, num_heads),
             out=_heads(pooled, num_heads))
    g = g_h0.float()
    dwo = gemm(g.reshape(b * i, c).t(), pooled.reshape(b * i, c))
    dpooled = gemm(g, wo)
    dp = torch.empty((b, n, j), dtype=_F32, device=y.device)
    gemm(_heads(v, num_heads), _heads(dpooled, num_heads).transpose(-1, -2),
         out=_heads(dp, num_heads))
    dv = torch.empty((b, n, c), dtype=_F32, device=y.device)
    gemm(_heads(p, num_heads), _heads(dpooled, num_heads), out=_heads(dv, num_heads))
    ds = softmax_bwd(p, dp, 1)
    dy = gemm(ds, qft)
    gemm(dv, wv, out=dy, accumulate=True)
    dqf = gemm(y.reshape(b * n, c).t(), ds.reshape(b * n, j))
    dwv = gemm(dv.reshape(b * n, c).t(), y.reshape(b * n, c))
    return dy, dqf, dwv, dwo


def pool_ext_fwd(x, se, be, ind2, kvw, wo, num_heads: int) -> tuple:
    """``folded_pool_ext`` at fp32 -> (h0, qft, M, L): y = x se + be, then
    the pool; qf^T and the softmax's statistics for the backward."""
    y = affine(x, xs=se, bs=be)
    qft = _fold_qft(ind2, kvw, num_heads)
    h0, mm, ll, _ = _pool_from_y(y, qft, kvw, wo, num_heads)
    return h0, qft, mm, ll


def pool_ext_bwd(x, se, be, qft, kvw, wo, macc, sacc, g_h0, num_heads: int) -> tuple:
    """``folded_pool_ext_bwd`` at fp32 -> (dx, dse, dbe, dqf, dwv, dwo):
    dx = dy se, dse = sum_n dy x, dbe = sum_n dy."""
    y = affine(x, xs=se, bs=be)
    dy, dqf, dwv, dwo = _pool_bwd_from_y(y, qft, kvw, wo, macc, sacc, g_h0, num_heads)
    return affine(dy, xs=se), reduce(dy, 1, x), reduce(dy, 1), dqf, dwv, dwo


def pool_layer_fwd(x, scale, bias, ind2, kvw, wo, num_groups: int, num_heads: int,
                   prenorm: bool) -> tuple:
    """``folded_pool_layer`` at fp32 -> (h0, mean_c, inv_c, (M, L, pooled,
    y)): with ``prenorm`` the set-level GroupNorm statistics of x from its
    channel sums and y = (x - mean) (inv scale) + bias, else y = x."""
    b, n, c = x.shape
    if prenorm:
        mean_c, inv_c = stats_from_sums(reduce(x, 1), reduce(x, 1, square=True), n, num_groups)
        y = affine(x, mu=mean_c, xs=inv_c * scale, bs=bias)
    else:
        mean_c = torch.zeros((b, c), dtype=_F32, device=x.device)
        inv_c = torch.ones_like(mean_c)
        y = x
    qft = _fold_qft(ind2, kvw, num_heads)
    h0, mm, ll, pooled = _pool_from_y(y, qft, kvw, wo, num_heads)
    return h0, mean_c, inv_c, (mm, ll, pooled, y)


def pool_layer_bwd(x, scale, ind2, kvw, wo, num_groups: int, mean_c, inv_c, m, l, pooled, y,
                   g_h0, g_mean, g_inv, num_heads: int, prenorm: bool) -> tuple:
    """``folded_pool_layer_bwd`` at fp32 -> (dx, dscale, dbias, dqf, dwv,
    dwo): the pool's backward to dy, then the GroupNorm's from sum_n dy (x
    - mean) and sum_n dy (``_pool_layer_bwd_dx_ref``'s algebra)."""
    b, n, c = x.shape
    qft = _fold_qft(ind2, kvw, num_heads)
    dy, dqf, dwv, dwo = _pool_bwd_from_y(y, qft, kvw, wo, m, l, g_h0, num_heads, pooled)
    if not prenorm:
        zero = torch.zeros((b, c), dtype=_F32, device=x.device)
        return dy, zero, zero.clone(), dqf, dwv, dwo
    pg = c // num_groups
    count = n * pg
    sxc = reduce(dy, 1, x, mu=mean_c)
    s1 = reduce(dy, 1)
    group = lambda t: t.reshape(b, num_groups, pg).sum(-1).repeat_interleave(pg, dim=1)
    dvar = -0.5 * inv_c**3 * group(sxc * scale + g_inv.float())
    dmean = group(-s1 * (inv_c * scale) + g_mean.float()) - 2.0 * mean_c * dvar
    dx = affine(dy, xs=inv_c * scale, y=x, ys=2.0 * (dvar / count), bs=dmean / count)
    return dx, sxc * inv_c, s1, dqf, dwv, dwo


# ----------------------------------------------------------------- h-side --


def _group_affine(z, scale, bias, num_groups: int):
    """(z - mean) (inv scale) + bias, the set-level group statistics of z
    [B, I, C] from its channel sums."""
    mean, inv = stats_from_sums(reduce(z, 1), reduce(z, 1, square=True), z.shape[1], num_groups)
    return affine(z, mu=mean, xs=inv * scale, bs=bias)


def hside_fwd(h0, s1, b1n, s2, b2n, num_groups: int, w1t, b1, w2t, b2, wk, wv) -> tuple:
    """``fused_h_side`` at fp32 -> (h, k, v): norm_1, the Gaussian MLP,
    norm_2, then k = h Wk^T and v = h Wv^T."""
    y1 = _group_affine(h0, s1, b1n, num_groups)
    g = gemm(y1, w1t, bias=b1, act=1)
    hh = gemm(g, w2t, bias=b2)
    y2 = _group_affine(hh, s2, b2n, num_groups)
    return y2, gemm(y2, wk.t()), gemm(y2, wv.t())


# ----------------------------------------------------------------- unpool --


def _unpool_fold(k, v, wq, wo, num_heads: int) -> tuple:
    """kft [B, J, C] = k_h wq_h / sqrt(D) and vf [B, J, C] = v_h wo_h^T,
    per (batch element, head)."""
    b, i, c = k.shape
    d = c // num_heads
    j = num_heads * i
    kft = gemm(_heads(k, num_heads), wq.reshape(num_heads, d, c), alpha=1.0 / math.sqrt(d))
    vf = gemm(_heads(v, num_heads), wo.reshape(c, num_heads, d).permute(1, 2, 0))
    return kft.reshape(b, j, c), vf.reshape(b, j, c)


def _unpool_p(y, kft, num_heads: int):
    """p [B, N, J]: the logits y kft^T, a softmax over each head's
    inducers."""
    b, n, _ = y.shape
    j = kft.shape[1]
    s = gemm(y, kft.transpose(1, 2))
    return softmax(s.reshape(b, n, num_heads, j // num_heads), -1)[0].reshape(b, n, j)


def unpool_fwd(x, se, be, k, v, wq, wo, num_heads: int, residual: bool, prenorm: bool) -> tuple:
    """``folded_unpool`` at fp32 -> (out, sums): y (x se + be, or x), p per
    head, attn = p vf (+ x), its channel sums."""
    y = affine(x, xs=se, bs=be) if prenorm else x
    kft, vf = _unpool_fold(k, v, wq, wo, num_heads)
    attn = gemm(_unpool_p(y, kft, num_heads), vf, res=x if residual else None)
    return attn, _sums(attn)


def unpool_bwd(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int, residual: bool,
               prenorm: bool) -> tuple:
    """``folded_unpool_bwd`` at fp32 -> (dx, dse, dbe, dkf [B, C, J], dvf
    [B, J, C]): attn recomputed, d_attn = g + gs1 + 2 attn gs2, dvf = p^T
    d_attn, dp = d_attn vf^T, ds per head, dkf = (ds^T y)^T, dy = ds kft,
    dx = dy se (+ d_attn), dse = sum_n dy x, dbe = sum_n dy."""
    b, n, c = x.shape
    y = affine(x, xs=se, bs=be) if prenorm else x
    kft, vf = _unpool_fold(k, v, wq, wo, num_heads)
    p = _unpool_p(y, kft, num_heads)
    attn = gemm(p, vf, res=x if residual else None)
    d_attn = _sums_cotangent(attn, g.float(), g_sums.float())
    dvf = gemm(p.transpose(1, 2), d_attn)
    j = kft.shape[1]
    dp = gemm(d_attn, vf.transpose(1, 2))
    ds = softmax_bwd(p.reshape(b, n, num_heads, j // num_heads),
                     dp.reshape(b, n, num_heads, j // num_heads), -1).reshape(b, n, j)
    dkf = gemm(y.transpose(1, 2), ds)
    dy = gemm(ds, kft)
    if prenorm:
        dx = affine(dy, xs=se, y=d_attn if residual else None)
        dse, dbe = reduce(dy, 1, x), reduce(dy, 1)
    else:
        dx = affine(dy, y=d_attn) if residual else dy
        dse = torch.zeros((b, c), dtype=_F32, device=x.device)
        dbe = torch.zeros_like(dse)
    return dx, dse, dbe, dkf, dvf


# -------------------------------------------------------------------- mlp --


def mlp_fwd(x, se, be, w1t, b1, w2t, b2) -> tuple:
    """``fused_mlp_residual`` at fp32 -> (out, sums): y = x se + be, g =
    exp(-h^2 / 2) of h = y w1t + b1, out = x + (g w2t + b2), its channel
    sums."""
    y = affine(x, xs=se, bs=be)
    o = gemm(gemm(y, w1t, bias=b1, act=1), w2t, bias=b2, res=x)
    return o, _sums(o)


def mlp_bwd(x, se, be, w1t, b1, w2t, b2, g, g_sums) -> tuple:
    """``fused_mlp_residual_bwd`` at fp32 -> (dx, dse, dbe, dw1t, db1,
    dw2t, db2): g' = g + gs1 + 2 o gs2, dh = (g' w2t^T) exp(-h^2 / 2) (-h),
    dy = dh w1t^T, dx = g' + dy se, the weight and bias gradients over
    every row."""
    b, n, c = x.shape
    w = w1t.shape[1]
    y = affine(x, xs=se, bs=be)
    a = gemm(y, w1t, bias=b1, act=1)
    o = gemm(a, w2t, bias=b2, res=x)
    gp = _sums_cotangent(o, g.float(), g_sums.float())
    dh = gemm(y, w1t, bias=b1, act=2, res=gemm(gp, w2t.t()))
    dy = gemm(dh, w1t.t())
    rows = lambda t: t.reshape(b * n, t.shape[-1])
    return (affine(dy, xs=se, y=gp), reduce(dy, 1, x), reduce(dy, 1),
            gemm(rows(y).t(), rows(dh)), reduce(rows(dh), 0)[None],
            gemm(rows(a).t(), rows(gp)), reduce(rows(gp), 0)[None])
