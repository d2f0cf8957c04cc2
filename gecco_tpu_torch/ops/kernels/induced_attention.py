"""Per-head rectangular attention: Hopper kernels and their plain PyTorch
versions, forward and backward.

Counterpart of ``gecco_tpu/ops/pallas/induced_attention.py``
(``rect_attention_pallas``). The set transformer's per-head path
(``attn_impl="pallas"``) runs its two thin attention shapes through it: the
pool (I inducer queries against the N points) and the unpool (the N points
against the I inducer tokens).

- ``rect_attention_fwd``: ``(o, lse)`` of unmasked softmax attention per
  (batch, head), with the algebra of the TPU kernel: fp32 logits times
  1/sqrt(D), each row's max and sum, ``p = exp(s - m) / l`` rounded to v's
  dtype before ``p @ v``, and ``lse = m + log l`` in fp32 (no exp clamp:
  this kernel never had one).
- ``rect_attention_bwd``: ``(dq, dk, dv)`` from ``(q, k, v, o, lse, g)``:
  ``p = exp(s - lse)``, ``ds = p (dp - delta)`` with ``delta = sum_d g o``
  in fp32, ``ds`` and ``p`` rounded to bf16 before the three products, dq
  and dk scaled by 1/sqrt(D), the cotangent rounded to bf16.
- ``rect_attention_pallas``: the differentiable function over the two.

Each has two bodies on the card, chosen by shape and layout
(``_rect_fwd_body``, ``_rect_bwd_body``; a CUDA tensor never takes a plain
version, and a body that fails raises):

- the Hopper bodies (``csrc/induced_attention.cu``,
  ``csrc/induced_attention_bwd.cu``; entry points
  ``_rect_attention_fwd_hopper`` and ``_rect_attention_bwd_hopper``,
  counted in ``.launches``): head widths 32, 48, 64 and 128, one side of at
  most 64 rows (the inducers), the long side's operands with adjacent heads
  (the [B, H, N, D] views of [B, N, C] projections). The short side stays
  in shared memory, the long side's tiles come through a TMA ring, the
  logits and softmax stay in registers; the pool forward takes two passes
  over its key tiles with the rows' (max, sum) merged across a cluster of
  blocks, and every cross-block sum runs in rank order, so the outputs are
  the same bits from call to call. The backward forms delta in the kernel
  from the bf16 g and o (where g comes in another dtype, the wrapper forms
  it from that g, as the JAX package does, and passes it in).
- the WMMA bodies (``csrc/induced_attention_wmma.cu``,
  ``csrc/induced_attention_bwd_wmma.cu``; ``_rect_attention_fwd_wmma``,
  ``_rect_attention_bwd_wmma``, counted in ``.launches_wmma``): every other
  head width up to 256 (one instance per width 16 to 128 in steps of 16,
  192 and 256, the backward's at 256 in two 128-column slices; a head
  width between is zero-padded to the next, its zero columns adding
  nothing to q k^T and giving zero output columns, and the softmax scale
  is 1/sqrt of the real width, passed in) and any layout; the backward's
  dq parts meet through fp32 atomics where there is more than one key tile.

CPU tensors run the plain versions (the backward is autograd through the
plain forward, as the twins' ``jax.vjp``); beside them, the Hopper bodies'
algebra in plain pieces (``_rect_fwd_pieces``, ``_rect_bwd_pieces``) and the
TPU kernel's own backward algebra (``_rect_bwd_tpu_algebra``). The kernels
read q, k and v through their strides: the [B, H, N, D] views that the set
transformer's ``_split_heads`` makes of its [B, N, C] projections (and the
stride-0 batch of the pool's broadcast inducers) are read in place, with no
copy. The outputs are written in the merged-heads layout [B, N, H, D] and
returned as [B, H, N, D] views, so that merging the heads costs no copy.
"""

from __future__ import annotations

import math

import torch

from gecco_tpu_torch.ops.kernels import f32
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


def _rect_attention_bwd_ref(q, k, v, g) -> tuple:
    """Plain version of the backward: autograd through the plain forward's
    o -> (dq, dk, dv)."""
    return vjp(lambda *a: _rect_attention_ref(*a)[0], (q, k, v), (g,))


def _rect_bwd_tpu_algebra(q, k, v, o, lse, g) -> tuple:
    """dq, dk, dv by the TPU kernel's own algebra (``_bwd_kernel``) in plain
    PyTorch: delta from the bf16 o, p from lse, ds and p rounded to bf16
    before the products. The witness of the per-head path's unpool q/k
    gradients."""
    bf = torch.bfloat16
    scale = 1.0 / q.shape[-1] ** 0.5
    delta = (g.float() * o.float()).sum(-1, keepdim=True)
    g16 = g.to(bf).float()
    s = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    ds = (p * (torch.einsum("bhmd,bhnd->bhmn", g16, v.float()) - delta)).to(bf).float()
    dq = torch.einsum("bhmn,bhnd->bhmd", ds, k.float()) * scale
    dk = torch.einsum("bhmn,bhmd->bhnd", ds, q.float()) * scale
    dv = torch.einsum("bhmn,bhmd->bhnd", p.to(bf).float(), g16)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------- the Hopper bodies' plain pieces --

# the Hopper bodies' plan (csrc/rect_hopper.cuh: kRangeTiles, kMaxCluster):
# a block aims at 16 tiles of the long side; the blocks of one (b, h) whose
# parts are summed form a cluster of at most 8
_RANGE_TILES = 16
_MAX_CLUSTER = 8


def _rect_plan(nt: int, cluster: bool) -> tuple:
    """(ranges, tiles a range) of one (b, h) over ``nt`` tiles of the long
    side (csrc/rect_hopper.cuh ``Plan``): ranges of _RANGE_TILES tiles, at
    most _MAX_CLUSTER of them where a cluster sums their parts."""
    r = max(1, -(-nt // _RANGE_TILES))
    if cluster:
        r = min(r, _MAX_CLUSTER)
    return r, -(-nt // r)


def _rect_logits(q, k):
    """fp32 logits times 1/sqrt(D): [B, H, M, N]."""
    return torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))


def _rect_range_stats_ref(s, ranges: int, tpb: int) -> tuple:
    """The pool forward's pass A: per range of ``tpb`` 64-key tiles, each
    row's running max over the range's tiles and its sum of exp(s - max),
    rescaled as the max moves, tile by tile -> (m, l) [B, H, ranges, M]
    (-inf and 0 for a range without tiles)."""
    n = s.shape[-1]
    ms, ls = [], []
    for j in range(ranges):
        m = s.new_full(s.shape[:-1], -math.inf)
        l = s.new_zeros(s.shape[:-1])
        for lo in range(j * tpb * _TILE, min(n, (j + 1) * tpb * _TILE), _TILE):
            tile = s[..., lo:lo + _TILE]
            new = torch.maximum(m, tile.amax(-1))
            l = l * torch.exp(m - new) + torch.exp(tile - new[..., None]).sum(-1)
            m = new
        ms.append(m)
        ls.append(l)
    return torch.stack(ms, 2), torch.stack(ls, 2)


def _rect_merge_ref(m, l) -> tuple:
    """The ranges' (m, l) [B, H, R, M] merged in rank order -> (max, sum)
    [B, H, M]: the max over the ranges, and each range's sum rescaled to it,
    added in rank order."""
    mm = m.amax(2)
    total = torch.zeros_like(mm)
    for j in range(m.shape[2]):
        total = total + l[:, :, j] * torch.exp(m[:, :, j] - mm)
    return mm, total


def _rect_pool_parts_ref(s, v, mm, total, ranges: int, tpb: int):
    """The pool forward's pass B: p = exp(s - max) / sum rounded to v's
    dtype, and per range the fp32 part of p @ v over its keys -> [B, H,
    ranges, M, D]."""
    p = (torch.exp(s - mm[..., None]) / total[..., None]).to(v.dtype).float()
    parts = []
    for j in range(ranges):
        lo, hi = j * tpb * _TILE, (j + 1) * tpb * _TILE
        parts.append(torch.einsum("bhmn,bhnd->bhmd", p[..., lo:hi], v[:, :, lo:hi].float()))
    return torch.stack(parts, 2)


def _rect_rank_sum_ref(parts):
    """Parts [B, H, R, rows, D] summed in rank order (the cluster sum)."""
    out = parts[:, :, 0]
    for j in range(1, parts.shape[2]):
        out = out + parts[:, :, j]
    return out


def _rect_fwd_pieces(q, k, v) -> tuple:
    """The Hopper forward's algebra in plain pieces -> (o, lse). The unpool
    direction (N <= 64 keys): each query tile's softmax is the whole row's,
    one pass; the pool direction: the ranges' (max, sum), their merge, the
    normalised p's parts and their sum in rank order."""
    s = _rect_logits(q, k)
    n = s.shape[-1]
    if n <= _TILE:
        mm = s.amax(-1)
        e = torch.exp(s - mm[..., None])
        total = e.sum(-1)
        p = (e / total[..., None]).to(v.dtype).float()
        o = torch.einsum("bhmn,bhnd->bhmd", p, v.float())
    else:
        ranges, tpb = _rect_plan(-(-n // _TILE), True)
        mm, total = _rect_merge_ref(*_rect_range_stats_ref(s, ranges, tpb))
        o = _rect_rank_sum_ref(_rect_pool_parts_ref(s, v, mm, total, ranges, tpb))
    return o.to(v.dtype), mm + torch.log(total)


def _rect_delta_ref(g, o):
    """The backward's in-kernel delta: sum_d f32(g) f32(o) per query row,
    from the bf16 tiles -> [B, H, M] fp32."""
    return (g.float() * o.float()).sum(-1)


def _rect_bwd_pieces(q, k, v, o, lse, g, delta=None) -> tuple:
    """The Hopper backward's algebra in plain pieces -> (dq, dk, dv), dq
    per batch element. delta: the wrapper's, else formed from g in q's
    dtype and o; p = exp(s - lse), ds = p (dp - delta), both rounded to q's
    dtype before the three products. The gradient a block accumulates over
    its range of the long side (the unpool: dk and dv over query tiles; the
    pool: dq over key tiles) is summed over the ranges in rank order; dq and
    dk are scaled by 1/sqrt(D) after their sums."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    g16 = g.to(dt).float()
    if delta is None:
        delta = _rect_delta_ref(g.to(dt), o)
    s = _rect_logits(q, k)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.einsum("bhmd,bhnd->bhmn", g16, v.float()) - delta[..., None])
    pb, dsb = p.to(dt).float(), ds.to(dt).float()
    qf, kf = q.float(), k.float()
    m, n = s.shape[-2:]
    if n <= _TILE:
        ranges, tpb = _rect_plan(-(-m // _TILE), True)
        dq = torch.einsum("bhmn,bhnd->bhmd", dsb, kf) * scale
        spans = [slice(j * tpb * _TILE, (j + 1) * tpb * _TILE) for j in range(ranges)]
        dk = _rect_rank_sum_ref(torch.stack(
            [torch.einsum("bhmn,bhmd->bhnd", dsb[:, :, sl], qf.expand(*dsb.shape[:2], m, -1)[:, :, sl])
             for sl in spans], 2)) * scale
        dv = _rect_rank_sum_ref(torch.stack(
            [torch.einsum("bhmn,bhmd->bhnd", pb[:, :, sl], g16[:, :, sl]) for sl in spans], 2))
    else:
        ranges, tpb = _rect_plan(-(-n // _TILE), True)
        dk = torch.einsum("bhmn,bhmd->bhnd", dsb, qf) * scale
        dv = torch.einsum("bhmn,bhmd->bhnd", pb, g16)
        spans = [slice(j * tpb * _TILE, (j + 1) * tpb * _TILE) for j in range(ranges)]
        dq = _rect_rank_sum_ref(torch.stack(
            [torch.einsum("bhmn,bhnd->bhmd", dsb[..., sl], kf[:, :, sl]) for sl in spans], 2)) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ the switch --

# the Hopper bodies' head widths (csrc/induced_attention.cu and
# induced_attention_bwd.cu: change both together)
_HOPPER_WIDTHS = (32, 48, 64, 128)
# a block's shared-memory limit on sm_90 (227 KB)
_MAX_SMEM = 232448
# the forward's ring depths (csrc/induced_attention.cu kUnpoolStages,
# kPoolStages)
_FWD_STAGES = {False: 4, True: 2}


def _panels(d: int) -> int:
    return -(-d // 64)


def _rect_fwd_smem(d: int, pool: bool) -> int:
    """Bytes of a Hopper forward block (csrc/induced_attention.cu
    ``FwdSmem``: change both together)."""
    tb = _panels(d) * _TILE * 128
    stage = (2 if pool else 1) * tb
    return (1 if pool else 2) * tb + _FWD_STAGES[pool] * (stage + 8) + 2 * _TILE * 4 + 1024


def _rect_bwd_smem(d: int, pool: bool) -> int:
    """Bytes of a Hopper backward block (csrc/induced_attention_bwd.cu
    ``BwdSmem``: change both together)."""
    tb = _panels(d) * _TILE * 128
    stages = 3 if _panels(d) == 1 else 2
    stage = (2 if pool else 3) * tb
    return (3 if pool else 2) * tb + _TILE * 128 + stages * (stage + 8) + 2 * _TILE * 4 + 1024


def _staged_ok(t) -> bool:
    """Whether the Hopper bodies' threads can stage ``t`` [B, H, rows, D]
    (csrc/rect_hopper.cuh ``staged_ok``): bf16, the last stride 1, the
    others multiples of 8 elements (a zero batch stride is fine), the base
    16-byte aligned."""
    sb, sh, sr, sd = t.stride()
    return (t.dtype == _BF16 and sd == 1 and sb % 8 == 0 and sh % 8 == 0 and sr % 8 == 0
            and sb >= 0 and sh >= 0 and sr > 0 and t.data_ptr() % 16 == 0)


def _tma_ok(t) -> bool:
    """Whether the Hopper bodies' TMA can stream ``t`` (``tma_ok``): as
    staged, with the heads adjacent (the head stride D) and a positive
    batch stride."""
    return _staged_ok(t) and t.stride(1) == t.shape[-1] and t.stride(0) > 0


def _hopper_takes(short: tuple, long: tuple, m: int, n: int, d: int) -> bool:
    """The Hopper bodies' shapes and layouts: D one of _HOPPER_WIDTHS, one
    side (``short``'s operands) of at most 64 rows, staged by threads; the
    other side's (``long``) streamed by TMA."""
    return (d in _HOPPER_WIDTHS and min(m, n) <= _TILE and all(map(_staged_ok, short))
            and all(map(_tma_ok, long)))


def _rect_fwd_body(q, k, v) -> str:
    """The forward's body: "f32" (``f32.rect_fwd``, any shape and layout)
    for fp32 operands; for bf16 ones "hopper" where the Hopper body takes
    the shapes and layouts (the unpool direction, N <= 64, streams q; the
    pool direction, M <= 64 < N, streams k and v), else "wmma". Raises for
    operands of mixed dtypes."""
    if f32.route("rect_attention_fwd", dict(q=q, k=k, v=v)) == _F32:
        return "f32"
    m, n, d = q.shape[2], k.shape[2], q.shape[-1]
    short, long = ((k, v), (q,)) if n <= _TILE else ((q,), (k, v))
    return "hopper" if _hopper_takes(short, long, m, n, d) else "wmma"


def _rect_bwd_body(q, k, v, o, g) -> str:
    """The backward's body, as ``_rect_fwd_body`` ("f32" for fp32 q, k, v
    and o, whatever g's dtype) with g and o (bf16) on the query side:
    streamed with q in the unpool direction, staged with it in the pool
    direction."""
    if f32.route("rect_attention_bwd", dict(q=q, k=k, v=v, o=o)) == _F32:
        return "f32"
    m, n, d = q.shape[2], k.shape[2], q.shape[-1]
    short, long = ((k, v), (q, g, o)) if n <= _TILE else ((q, g, o), (k, v))
    return "hopper" if _hopper_takes(short, long, m, n, d) else "wmma"


# --------------------------------------------------------------- wrappers --


def _strided(name: str, tensors: dict, device) -> dict:
    """The operands as the WMMA bodies read them: bf16 on ``device``, the
    last stride 1, the other strides and the base 16-byte aligned. An
    operand in another layout is copied to a contiguous one first."""
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


# the head widths of the WMMA bodies' instances
# (csrc/induced_attention_wmma.cu and induced_attention_bwd_wmma.cu: change
# both together)
_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128, 192, 256)


def _d_pad(d: int) -> int:
    """The WMMA instance that takes head width D: the narrowest of
    ``_WIDTHS`` at least D wide."""
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


def _check_cuda(name: str, q, tensors: dict) -> None:
    """Raise unless q is a CUDA tensor and every tensor is on its device."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: q must be a CUDA tensor, got {q.device}")
    for key, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {q.device}")


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
    lse [B, H, M] fp32). CPU tensors take the plain version; CUDA tensors
    the body ``_rect_fwd_body`` picks."""
    if q.device.type == "cpu":
        return _rect_attention_ref(q, k, v)
    body = _rect_fwd_body(q, k, v)
    if body == "f32":
        return _rect_attention_fwd_f32(q, k, v)
    if body == "hopper":
        return _rect_attention_fwd_hopper(q, k, v)
    return _rect_attention_fwd_wmma(q, k, v)


def _rect_attention_fwd_f32(q, k, v) -> tuple:
    """The fp32 route (``f32.rect_fwd``: csrc/f32_simt.cu), counted in
    ``rect_attention_fwd.launches_f32``: any head width and layout."""
    name = "rect_attention_fwd"
    _check_cuda(name, q, dict(k=k, v=v))
    _check_shapes(name, q, k, v)
    rect_attention_fwd.launches_f32 += 1
    return f32.rect_fwd(q, k, v)


def _rect_attention_fwd_hopper(q, k, v) -> tuple:
    """The Hopper body (csrc/induced_attention.cu), counted in
    ``rect_attention_fwd.launches``; raises where it does not take the
    shapes or layouts (``_rect_fwd_body``)."""
    name = "rect_attention_fwd"
    _check_cuda(name, q, dict(k=k, v=v))
    _check_shapes(name, q, k, v)
    if _rect_fwd_body(q, k, v) != "hopper":
        raise ValueError(f"{name}: the Hopper body does not take q {tuple(q.shape)} "
                         f"{q.stride()}, k {tuple(k.shape)} {k.stride()}, v {v.stride()}")
    b, h, m, d = q.shape
    n = k.shape[2]
    o = torch.empty((b, m, h, d), dtype=_BF16, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, m), dtype=_F32, device=q.device)
    launch("induced_attention", "rect_attention_fwd_hopper_launch", q, k, v, o, lse,
           *_strides(q), *_strides(k), *_strides(v), *_strides(o), b, h, m, n, d)
    rect_attention_fwd.launches += 1
    return o, lse


def _rect_attention_fwd_wmma(q, k, v) -> tuple:
    """The WMMA body (csrc/induced_attention_wmma.cu), counted in
    ``rect_attention_fwd.launches_wmma``: any head width up to 256, any
    layout (copied where its strides are not multiples of 8)."""
    name = "rect_attention_fwd"
    _check_cuda(name, q, dict(k=k, v=v))
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
    launch("induced_attention_wmma", "rect_attention_fwd_launch", q, k, v, o, lse,
           *_strides(q), *_strides(k), *_strides(v), *_strides(o), b, h, m, n, dp, d)
    rect_attention_fwd.launches_wmma += 1
    return (o if dp == d else o[..., :d]), lse


rect_attention_fwd.launches = 0
rect_attention_fwd.launches_wmma = 0
rect_attention_fwd.launches_f32 = 0


def rect_attention_bwd(q, k, v, o, lse, g) -> tuple:
    """Gradients of ``rect_attention_fwd``'s o against ``g`` [B, H, M, D],
    from the forward's inputs, o and lse -> (dq, dk, dv), each of its
    input's shape (dq [B, H, M, D] also where q broadcasts over the batch,
    for autograd to sum). CPU tensors take the plain version; CUDA tensors
    the body ``_rect_bwd_body`` picks."""
    if q.device.type == "cpu":
        return _rect_attention_bwd_ref(q, k, v, g)
    body = _rect_bwd_body(q, k, v, o, g if g.dtype == _F32 and o.dtype == _F32 else g.to(_BF16))
    if body == "f32":
        return _rect_attention_bwd_f32(q, k, v, o, lse, g)
    if body == "hopper":
        return _rect_attention_bwd_hopper(q, k, v, o, lse, g)
    return _rect_attention_bwd_wmma(q, k, v, o, lse, g)


def _rect_attention_bwd_f32(q, k, v, o, lse, g) -> tuple:
    """The fp32 route (``f32.rect_bwd``: csrc/f32_simt.cu), counted in
    ``rect_attention_bwd.launches_f32``: delta from the fp32 o and g in
    fp32."""
    name = "rect_attention_bwd"
    _check_cuda(name, q, dict(k=k, v=v, o=o, lse=lse, g=g))
    _check_shapes(name, q, k, v)
    if o.shape != q.shape or g.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"{name}: o {tuple(o.shape)}, g {tuple(g.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if lse.dtype != _F32:
        raise ValueError(f"{name}: lse must be {_F32}, got {lse.dtype}")
    rect_attention_bwd.launches_f32 += 1
    return f32.rect_bwd(q, k, v, o, lse, g)


def _rect_attention_bwd_hopper(q, k, v, o, lse, g) -> tuple:
    """The Hopper body (csrc/induced_attention_bwd.cu), counted in
    ``rect_attention_bwd.launches``: delta formed in the kernel from the
    bf16 g and o, or, where g comes in another dtype, here from that g;
    raises where it does not take the shapes or layouts
    (``_rect_bwd_body``)."""
    name = "rect_attention_bwd"
    _check_cuda(name, q, dict(k=k, v=v, o=o, lse=lse, g=g))
    _check_shapes(name, q, k, v)
    if o.shape != q.shape or g.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"{name}: o {tuple(o.shape)}, g {tuple(g.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    delta = None if g.dtype == _BF16 else (g.float() * o.float()).sum(-1).contiguous()
    g16 = g.to(_BF16)
    if _rect_bwd_body(q, k, v, o, g16) != "hopper" or lse.dtype != _F32 \
            or not lse.is_contiguous():
        raise ValueError(f"{name}: the Hopper body does not take q {tuple(q.shape)} "
                         f"{q.stride()}, k {tuple(k.shape)} {k.stride()}, o {o.stride()}, "
                         f"g {g16.stride()}")
    b, h, m, d = q.shape
    n = k.shape[2]
    dev = q.device
    dq = torch.empty((b, m, h, d), dtype=_BF16, device=dev).transpose(1, 2)
    dk = torch.empty((b, n, h, d), dtype=_BF16, device=dev).transpose(1, 2)
    dv = torch.empty_like(dk)
    launch("induced_attention_bwd", "rect_attention_bwd_hopper_launch", q, k, v, g16, o, lse,
           delta, dq, dk, dv, *_strides(q), *_strides(k), *_strides(v), *_strides(g16),
           *_strides(o), *_strides(dq), *_strides(dk), b, h, m, n, d)
    rect_attention_bwd.launches += 1
    return dq, dk, dv


def _rect_attention_bwd_wmma(q, k, v, o, lse, g) -> tuple:
    """The WMMA body (csrc/induced_attention_bwd_wmma.cu), counted in
    ``rect_attention_bwd.launches_wmma``: delta formed here in plain
    PyTorch; where there is more than one key tile, dq's parts meet in an
    fp32 buffer through atomics."""
    name = "rect_attention_bwd"
    _check_cuda(name, q, dict(k=k, v=v, o=o, lse=lse, g=g))
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
    launch("induced_attention_bwd_wmma", "rect_attention_bwd_launch", q, k, v, g16, lse, delta,
           dq32 if dq32 is not None else dq, dk, dv,
           *_strides(q), *_strides(k), *_strides(v), *_strides(g16), *_strides(dq), *_strides(dk),
           b, h, m, n, dp, d, int(dq32 is not None))
    rect_attention_bwd.launches_wmma += 1
    if dq32 is not None:
        dq = dq32.to(_BF16)
    if dp != d:
        dq, dk, dv = (t[..., :d] for t in (dq, dk, dv))
    return dq, dk, dv


rect_attention_bwd.launches = 0
rect_attention_bwd.launches_wmma = 0
rect_attention_bwd.launches_f32 = 0


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
