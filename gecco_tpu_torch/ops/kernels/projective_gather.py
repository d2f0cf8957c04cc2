"""Projective gather: Hopper kernels (forward and backward) and their plain
PyTorch version.

Counterpart of ``gecco_tpu/ops/pallas/projective_gather.py``.
``projective_gather(features, hw01)`` looks every point up in every level of
a channels-last feature pyramid and returns the concatenated ``[B, N, sum
C]`` features. It is a ``torch.autograd.Function``: for CUDA tensors the
forward launches one of two bodies, chosen by shape (``_gather_body``), and
the backward likewise; for CPU tensors both run the plain version,
``lookup_pyramid(..., impl="xla")`` of ``gecco_tpu_torch.ops.projective``,
and autograd through it. A CUDA tensor never falls back to the plain
version.

- The Hopper bodies (``csrc/projective_gather.cu``), where the levels are
  bf16, 1 to 4 of them, every level's C a multiple of 8 (up to 2048) and
  16-byte aligned, and, for the backward, N <= 4096: the forward ``gather_fwd_kernel`` (16-byte accesses,
  the block's output rows written contiguously; counted in
  ``projective_gather.launches``); the backward a stable bin of the points
  by floor cell, then one pass per output pixel that sums its neighbouring
  cells' points in a fixed order and writes each level's bf16 gradient
  once, and the coordinate gradient per point when asked for (one call,
  however many launches, counted in ``projective_gather_bwd.launches``).
  No atomics: the gradient is the same bits on every call.
- The SIMT bodies (``csrc/projective_gather_simt.cu``, one warp per point,
  bf16 or fp32, on channel pairs where a level's are aligned and on single
  channels elsewhere; the backward adding into a zeroed fp32 buffer with
  atomics and cast after) for everything else: fp32 levels, any C, any
  alignment, any N, and any number of levels, launched in groups of
  ``_MAX_LEVELS`` (each forward launch writes its levels' columns of the
  one output; each backward launch its levels' gradients, the coordinate
  gradient continued from the launch before, so the levels are summed in
  order). Counted in ``.launches_simt`` of each wrapper, once a launch.
  The switch raises only where there is no level or the levels' dtypes
  differ; a dtype other than bf16 and fp32 raises in the operands' check.

``_gather_hopper``, ``_gather_simt``, ``_gather_bwd_hopper`` and
``_gather_bwd_simt`` run one body whatever the switch says.

The kernels weigh the corners in fp32 and round once, at the output (the
TPU kernel rounded its one-hot weights to bf16 before its product, the
plain version rounds every corner's product): the three differ by a few
bf16 steps of the output. The two forwards give the same bits. The
backward takes the cotangent in the levels' dtype, as the TPU kernel does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from gecco_tpu_torch.ops.kernels._build import check_cuda, launch, library
from gecco_tpu_torch.ops.kernels._grad import vjp
from gecco_tpu_torch.ops.projective import lookup_pyramid

__all__ = ["projective_gather", "projective_gather_bwd"]

_BF16, _F32 = torch.bfloat16, torch.float32
# the element types the SIMT bodies take, by their code in its C interface
_DTYPES = {_BF16: 0, _F32: 1}
# levels a launch takes (csrc/projective_gather.cu and
# csrc/projective_gather_simt.cu kMaxLevels)
_MAX_LEVELS = 4
# the Hopper bodies' limits (csrc/projective_gather.cu: kChunk, kPixThreads,
# kMaxPoints; change both together)
_CHUNK, _MAX_C, _MAX_POINTS = 8, 2048, 4096


def _gather_ref(hw01, *levels) -> torch.Tensor:
    """Plain version: the four-corner gather of every level, concatenated."""
    return lookup_pyramid(levels, hw01, impl="xla")


def _check(name, hw01, levels, g=None):
    """Raise unless the operands are contiguous CUDA tensors on one device
    (hw01 fp32; the levels, and g, all bf16 or all fp32) and hw01 is [B, N,
    2] with at least one level [B, H, W, C]. The common case is one pass
    over the tensors; ``check_cuda`` names the operand at fault."""
    rest = (*levels, g) if g is not None else levels
    dev = hw01.device
    dt = levels[0].dtype if levels else None
    if not (dev.type == "cuda" and hw01.dtype == _F32 and hw01.is_contiguous()
            and dt in _DTYPES
            and all(t.device == dev and t.dtype == dt and t.is_contiguous() for t in rest)):
        if dt not in _DTYPES:
            raise ValueError(f"{name}: the levels must be bf16 or fp32, got {dt}")
        tensors = {"hw01": hw01, **{f"level{q}": lv for q, lv in enumerate(levels)}}
        dtypes = {"hw01": _F32, **{f"level{q}": dt for q in range(len(levels))}}
        if g is not None:
            tensors["g"], dtypes["g"] = g, dt
        check_cuda(name, tensors, dtypes)
    b, n = hw01.shape[:2]
    if hw01.shape != (b, n, 2):
        raise ValueError(f"{name}: hw01 must be [B, N, 2], got {tuple(hw01.shape)}")
    for lv in levels:
        if lv.ndim != 4 or lv.shape[0] != b:
            raise ValueError(f"{name}: each level must be [B, H, W, C], got {tuple(lv.shape)}")


def _gather_body(levels, hw01, g=None) -> str:
    """Which body takes these operands on the card (the backward's where
    ``g`` is given): "hopper" where the levels are bf16, 1 to 4 of them,
    every level's C a multiple of 8 up to 2048 and its data 16-byte aligned
    (the backward: also N <= 4096, g 16-byte and hw01 8-byte aligned), else
    "simt". Raises ValueError where there is no level or the levels'
    dtypes differ."""
    if not levels:
        raise ValueError("projective_gather: no level to look up")
    dtypes = {lv.dtype for lv in levels}
    if len(dtypes) > 1:
        raise ValueError(f"projective_gather: the levels' dtypes differ: "
                         f"{[lv.dtype for lv in levels]}")
    hopper = (levels[0].dtype == _BF16 and len(levels) <= _MAX_LEVELS
              and all(lv.shape[-1] % _CHUNK == 0 and lv.shape[-1] <= _MAX_C
                      and lv.data_ptr() % 16 == 0 for lv in levels))
    if g is not None:
        hopper = (hopper and hw01.shape[1] <= _MAX_POINTS and g.data_ptr() % 16 == 0
                  and hw01.data_ptr() % 8 == 0)
    return "hopper" if hopper else "simt"


# the Hopper bodies' C interface (csrc/projective_gather.cu), its ctypes
# prototypes set once: pointers, then ints, then the stream
_PROTOTYPES = {
    "gather_launch": (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 15 + (ctypes.c_void_p,),
    "gather_bwd_launch": (ctypes.c_void_p,) * 16 + (ctypes.c_int,) * 15 + (ctypes.c_void_p,),
}


@functools.lru_cache(maxsize=None)
def _entry(fn: str):
    f = getattr(library("projective_gather"), fn)
    f.restype = ctypes.c_int
    f.argtypes = _PROTOTYPES[fn]
    return f


@functools.lru_cache(maxsize=64)
def _dims(b: int, n: int, shapes: tuple) -> tuple:
    """The C interface's ints for a call: B, N, L and (H, W, C) per level
    (zeros past the last)."""
    hwc = [d for s in shapes for d in s] + [0] * 3 * (_MAX_LEVELS - len(shapes))
    return (b, n, len(shapes), *hwc)


def _call(fn: str, *args) -> None:
    err = _entry(fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"projective_gather.{fn}: CUDA error {err} at launch")


def _ptrs(tensors) -> list:
    return [t.data_ptr() for t in tensors] + [None] * (_MAX_LEVELS - len(tensors))


def _gather_hopper(hw01, levels) -> torch.Tensor:
    """The Hopper forward (csrc/projective_gather.cu gather_fwd_kernel)."""
    b, n = hw01.shape[:2]
    shapes = tuple(tuple(lv.shape[1:]) for lv in levels)
    out = torch.empty((b, n, sum(s[2] for s in shapes)), dtype=_BF16, device=hw01.device)
    _call("gather_launch", hw01.data_ptr(), *_ptrs(levels), out.data_ptr(),
          *_dims(b, n, shapes))
    projective_gather.launches += 1
    return out


def _groups(levels) -> list:
    """The levels in launches of at most ``_MAX_LEVELS``: per launch its
    levels, their pointers (None past the last), [L, the first level's
    column in the concatenated row] and (H, W, C) per level (zeros past
    the last)."""
    out, col = [], 0
    for q in range(0, len(levels), _MAX_LEVELS):
        grp = list(levels[q:q + _MAX_LEVELS])
        pad = _MAX_LEVELS - len(grp)
        hwc = [d for lv in grp for d in lv.shape[1:]] + [0] * 3 * pad
        out.append((grp, [*grp, *[None] * pad], [len(grp), col], hwc))
        col += sum(lv.shape[3] for lv in grp)
    return out


def _gather_simt(hw01, levels) -> torch.Tensor:
    """The SIMT forward (csrc/projective_gather_simt.cu gather_kernel), one
    launch per group of ``_MAX_LEVELS`` levels."""
    b, n = hw01.shape[:2]
    ctot = sum(lv.shape[3] for lv in levels)
    dt = levels[0].dtype
    out = torch.empty((b, n, ctot), dtype=dt, device=hw01.device)
    for _, ptrs, lc, hwc in _groups(levels):
        launch("projective_gather_simt", "gather_launch", hw01, *ptrs, out, _DTYPES[dt], b, n,
               *lc, ctot, *hwc)
        projective_gather.launches_simt += 1
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hw01, *levels):
        if hw01.device.type == "cpu":
            out = _gather_ref(hw01, *levels)
        else:
            _check("projective_gather", hw01, levels)
            run = _gather_hopper if _gather_body(levels, hw01) == "hopper" else _gather_simt
            out = run(hw01, levels)
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
projective_gather.launches_simt = 0


def _gather_bwd_ref(levels, hw01, g) -> tuple:
    """Plain version of the backward: autograd through ``_gather_ref`` ->
    (dhw01, [dlevel per level])."""
    d = vjp(_gather_ref, (hw01, *levels), (g,))
    return d[0], list(d[1:])


def _floor_cell(c: torch.Tensor, size: int) -> torch.Tensor:
    """floor(c) clamped into [-2, size + 1] as the kernels clamp it (NaN to
    -2, as fmaxf takes the number), as int64."""
    f = torch.floor(c)
    return torch.where(torch.isnan(f), -2.0, f).clamp(-2, size + 1).long()


def _gather_bwd_binned_ref(levels, hw01, g) -> tuple:
    """Plain version of the Hopper backward's algebra, in fp32 (nothing on
    the card's path calls it): per level and batch element a stable bin of
    the points by floor cell (h0, w0) in [-1, H-1] x [-1, W-1] (a point
    outside has no corner in the image and is dropped); per cell and corner
    q the sum of w_q g over its points by point index; each pixel (h, w)
    the sum of its four neighbouring cells' in the order (h-1, w-1),
    (h-1, w), (h, w-1), (h, w); and per point the coordinate gradient from
    g . F at its in-image corners. -> (dhw01 [B, N, 2], [dF per level
    [B, H, W, C]])."""
    hw01, g = hw01.float(), g.float()
    b = hw01.shape[0]
    dev = hw01.device
    dh = torch.zeros(hw01.shape[:2], device=dev)
    dw = torch.zeros(hw01.shape[:2], device=dev)
    dlevels, off = [], 0
    for lv in levels:
        lv = lv.float()
        _, hh, ww, c = lv.shape
        ch, cw = hw01[..., 0] * hh, hw01[..., 1] * ww
        fh, fw = ch - torch.floor(ch), cw - torch.floor(cw)
        h0, w0 = _floor_cell(ch, hh), _floor_cell(cw, ww)
        inside = (h0 >= -1) & (h0 < hh) & (w0 >= -1) & (w0 < ww)
        ncell = (hh + 1) * (ww + 1)
        key = torch.where(inside, (h0 + 1) * (ww + 1) + w0 + 1, ncell)
        gl = g[..., off:off + c]
        wh = [1 - fh, fh]
        wv = [1 - fw, fw]
        df = torch.empty(b, hh, ww, c, device=dev)
        for bi in range(b):
            order = torch.argsort(key[bi], stable=True)
            keep = order[key[bi, order] < ncell]
            cells = key[bi, keep]
            # per cell and corner q = 2 dh + dw: the sum over its points
            part = []
            for q in range(4):
                wq = (wh[q >> 1][bi, keep] * wv[q & 1][bi, keep])[:, None]
                s = torch.zeros(ncell, c, device=dev).index_add_(0, cells, wq * gl[bi, keep])
                part.append(s.view(hh + 1, ww + 1, c))
            df[bi] = part[3][:hh, :ww] + part[2][:hh, 1:] + part[1][1:, :ww] + part[0][1:, 1:]
        dlevels.append(df)
        # the coordinate gradient: g . F at each in-image corner
        flat = lv.reshape(b, hh * ww, c)
        dch = torch.zeros_like(ch)
        dcw = torch.zeros_like(cw)
        for q in range(4):
            hi, wi = h0 + (q >> 1), w0 + (q & 1)
            valid = (hi >= 0) & (hi < hh) & (wi >= 0) & (wi < ww)
            idx = torch.where(valid, hi * ww + wi, 0)
            corner = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
            dot = torch.where(valid, (gl * corner).sum(-1), 0.0)
            dch = dch + torch.where(valid, (1 if q >> 1 else -1) * wv[q & 1] * dot, 0.0)
            dcw = dcw + torch.where(valid, (1 if q & 1 else -1) * wh[q >> 1] * dot, 0.0)
        dh = dh + hh * dch
        dw = dw + ww * dcw
        off += c
    return torch.stack([dh, dw], dim=-1), dlevels


def _gather_bwd_hopper(levels, hw01, g, coords_grad: bool = True) -> tuple:
    """The Hopper backward (csrc/projective_gather.cu: gather_bin_kernel,
    gather_pixel_kernel, and gather_coord_kernel where ``coords_grad``) ->
    (dhw01 or None, [dF per level, bf16])."""
    b, n = hw01.shape[:2]
    shapes = tuple(tuple(lv.shape[1:]) for lv in levels)
    dev = hw01.device
    lists = b * len(levels) * n
    # one int32 scratch: the sorted coordinates [B L N, 2] fp32 first (8-byte
    # aligned), the sorted point indices [B L N], the cells' first
    # positions, the crowded pixels' lists and their lengths [B, L]
    cells = sum(b * ((h + 1) * (w + 1) + 1) for h, w, _ in shapes)
    pixels = sum(b * h * w for h, w, _ in shapes)
    scratch = torch.empty(3 * lists + cells + pixels + b * len(levels), dtype=torch.int32,
                          device=dev)
    at = scratch.data_ptr()
    dlevels = [torch.empty_like(lv) for lv in levels]
    dhw01 = torch.empty((b, n, 2), dtype=_F32, device=dev) if coords_grad else None
    _call("gather_bwd_launch", hw01.data_ptr(), *_ptrs(levels), g.data_ptr(), at + 8 * lists,
          at, at + 12 * lists, at + 4 * (3 * lists + cells),
          at + 4 * (3 * lists + cells + pixels), *_ptrs(dlevels),
          None if dhw01 is None else dhw01.data_ptr(), *_dims(b, n, shapes))
    projective_gather_bwd.launches += 1
    return dhw01, dlevels


def _gather_bwd_simt(levels, hw01, g, coords_grad: bool = True) -> tuple:
    """The SIMT backward (csrc/projective_gather_simt.cu gather_bwd_kernel:
    fp32 atomics into a zeroed buffer, cast to the levels' dtype after),
    one launch per group of ``_MAX_LEVELS`` levels in order, each after the
    first continuing the coordinate gradient of those before it."""
    b, n = hw01.shape[:2]
    ctot = sum(lv.shape[3] for lv in levels)
    sizes = [lv.numel() for lv in levels]
    df = torch.zeros(sum(sizes), dtype=_F32, device=hw01.device)
    dhw01 = torch.empty((b, n, 2), dtype=_F32, device=hw01.device) if coords_grad else None
    at = 0
    for q, (grp, ptrs, lc, hwc) in enumerate(_groups(levels)):
        launch("projective_gather_simt", "gather_bwd_launch", hw01, *ptrs, g, df[at:], dhw01,
               _DTYPES[levels[0].dtype], int(q > 0), b, n, *lc, ctot, *hwc)
        projective_gather_bwd.launches_simt += 1
        at += sum(lv.numel() for lv in grp)
    return dhw01, [part.view(lv.shape).to(lv.dtype) for part, lv in zip(df.split(sizes), levels)]


def projective_gather_bwd(levels, hw01, g, coords_grad: bool = True) -> tuple:
    """Gradients of ``projective_gather`` against ``g [B, N, sum C]`` ->
    (dhw01 [B, N, 2] fp32, or None unless ``coords_grad``; the levels'
    gradients, each in its level's dtype)."""
    if hw01.device.type == "cpu":
        dhw01, dlevels = _gather_bwd_ref(levels, hw01, g)
        return (dhw01 if coords_grad else None), dlevels
    g = g.to(levels[0].dtype).contiguous()
    _check("projective_gather_bwd", hw01, levels, g)
    run = _gather_bwd_hopper if _gather_body(levels, hw01, g) == "hopper" else _gather_bwd_simt
    return run(levels, hw01, g, coords_grad)


projective_gather_bwd.launches = 0
projective_gather_bwd.launches_simt = 0
