"""Folded induced-set attention and the fused MLP: Hopper kernels and their
plain PyTorch versions, forward and backward.

Counterpart of ``gecco_tpu/ops/pallas/folded_attention.py``. Four
differentiable functions carry a broadcasting layer's per-point work; each
is a ``torch.autograd.Function`` whose forward and backward launch CUDA
kernels (``gecco_tpu_torch/csrc``) for CUDA tensors and run their plain
versions (the JAX package's XLA twins, ported; the backward is autograd
through the plain forward, as the twins' ``jax.vjp``) for CPU tensors:

- ``folded_pool_ext`` (``csrc/pool_ext.cu``; backward ``csrc/pool_ext_bwd.cu``,
  WMMA body ``csrc/pool_ext_bwd_wmma.cu``):
  the pre-normed stream pooled onto the inducers by a softmax over the point
  axis, taken per chunk of points and merged across chunks (four launches:
  the query fold, the chunks, the merge, the output projection, each with
  its plain version beside it). When a gradient is needed the forward also
  returns the softmax statistics (column max and sum) the backward reads.
  The backward runs the v3 algebra in five passes, each with its plain
  piece beside it (``_pool_bwd_*_ref``).
- ``folded_pool_layer`` (``csrc/pool.cu``, WMMA body ``csrc/pool_wmma.cu``;
  backward ``csrc/pool_bwd.cu``, WMMA body ``csrc/pool_bwd_wmma.cu``): the
  resident pool, the same pooling with
  the set-level GroupNorm statistics of the stream computed on the card
  (``prenorm``, returned beside h0) or no pre-norm at all: the layer's
  sums-less route and the module-level pool. The Hopper body runs two
  passes over point chunks (the softmax's column max and sum, then p
  normalised by them against the values), each with its plain piece
  beside it (``_pool_layer_*_ref``); so do the backward's
  (``_pool_layer_bwd_*_ref``).
- ``folded_unpool`` (``csrc/unpool.cu``; backward ``csrc/unpool_bwd.cu``,
  WMMA body ``csrc/unpool_bwd_wmma.cu``):
  the points attend to the inducer tokens (per-head softmax, each head block
  with its own max), plus the residual and the output's channel sums; the
  ``residual`` and ``prenorm`` flags turn the x term and the pre-norm off
  (the module-level unpool).
- ``fused_mlp_residual`` (``csrc/mlp.cu``, WMMA body ``csrc/mlp_wmma.cu``;
  backward ``csrc/mlp_bwd.cu``, WMMA body ``csrc/mlp_bwd_wmma.cu``):
  pre-norm + Gaussian MLP + residual, plus the output's channel sums. The
  Hopper bodies run each product as one pass over the rows with the
  algebra in its epilogue (``csrc/mlp_hopper.cuh``), each with its plain
  piece beside it (``_mlp_act_ref``, ``_mlp_out_ref``, ``_mlp_bwd_*_ref``).

and a fourth runs the second and third as one launch:

- ``fused_unpool_mlp`` (``csrc/unpool_mlp.cu``, WMMA body
  ``csrc/unpool_mlp_wmma.cu``): unpool + residual, the mlp_norm statistics
  of the result from its channel sums, then the MLP + residual and the
  output's channel sums (the sampler's opt-in megakernel). The Hopper body
  runs one cluster of blocks per batch element, each block holding its
  points' x' in shared memory between the two halves; the cluster's sums
  meet in rank order. Its plain pieces (``_unpool_mlp_block_sums_ref``,
  ``_unpool_mlp_merge_ref``) compose with the unpool's and the MLP's to
  the plain version (``_unpool_mlp_pieces``). Its backward recomputes
  through ``folded_unpool`` and ``fused_mlp_residual``
  (``_unpool_mlp_composed``), whose backwards are the kernels above, as
  the JAX package's custom_vjp does.

The pool, unpool and MLP forwards and backwards and the resident pool each
keep a second, WMMA body (``csrc/*_wmma.cu``) for the shapes their Hopper
design does not take; ``_pool_ext_body``, ``_unpool_body``, ``_mlp_body``,
``_pool_layer_body`` and the backwards' ``*_bwd_body`` choose by shape,
and a shape that neither body takes raises. The pool and unpool forwards'
Hopper bodies take 64 inducers a head of D 16 to 64 channels (the pool D
in 16, 32, 48, 64 and H % 4 == 0, the unpool D % 16 and H even, C % 64
up to 384 or C % 192 above): the flagship, the 8k width and the upsample
demo's C 128 with four heads of 32; three heads (D 128) or another
inducer count take their WMMA bodies. The pool and unpool backwards'
Hopper bodies take 64 inducers a head at any D % 16 (the pool's at C 128,
384 or 768, the unpool's at C % 128 up to 384 or C % 384 above): the
flagship, the 8k width, the demo's width and three heads. A CUDA tensor
never falls back to a plain version. Any point count N >= 1 is taken: on
the card each function zero-pads the point axis of its operands to the
next multiple of 128 (``_pad_points``; no copy where N is one already),
passes the bodies ``n_valid = N``, which mask the
padding out of every reduction over points, and slices the outputs back to
N. The plain versions and pieces take ``n_valid`` too (``_valid_rows``),
so that a piece fed the padded operands composes to the plain version at
N. The pool
backward has three more bodies, the JAX package's opt-in v1, v2 and v2j
(``csrc/pool_ext_bwd_v1.cu``, ``csrc/pool_ext_bwd_v2.cu``), forced by
``GECCO_POOL_BWD`` as in the JAX package (read once at import into
``_POOL_BWD_ENV``) and counted in ``.launches_v1``, ``.launches_v2`` and
``.launches_v2j``. Each forward wrapper counts its kernel
launches in ``.launches`` (the WMMA body's in ``.launches_wmma``); each
backward has its own wrapper (``*_bwd``) and counters. As in the JAX
package, the backward kernels take the incoming cotangent rounded to the
activation dtype, and the small chains from the folded operands'
gradients to the weights' (``dqf`` to ``dind2``/``dWk``; ``dkf``/``dvf``
to ``dk``/``dv``/``dWq``/``dWo``) are plain PyTorch outside the kernels.
"""

from __future__ import annotations

import os
import sys

import torch

from gecco_tpu_torch.ops.kernels import f32
from gecco_tpu_torch.ops.kernels._build import check_cuda, launch
from gecco_tpu_torch.ops.norms import stats_from_sums
from gecco_tpu_torch.ops.kernels._grad import needs_grad, vjp

__all__ = [
    "folded_pool_ext",
    "folded_pool_ext_bwd",
    "folded_pool_layer",
    "folded_pool_layer_bwd",
    "folded_unpool",
    "folded_unpool_bwd",
    "fused_mlp_residual",
    "fused_mlp_residual_bwd",
    "fused_unpool_mlp",
    "unpool_mlp_fits_sm",
    "group_indicator",
    "fold_qf",
]

_BF16, _F32 = torch.bfloat16, torch.float32

# GECCO_POOL_BWD forces the pool backward's body, with the JAX package's
# values and meaning (gecco_tpu/ops/pallas/folded_attention.py
# _parse_pool_bwd_env): "v1" the two-pass body with per-head [J, D]
# accumulators and dp in both passes, "v2" the two-pass body with the
# e^T v product in pass 0 and 1/sacc folded into the placement matrix,
# "v2j" v2 taking 1/sacc as an operand, "v3" the fold-everything body.
# Unset is v3. A forced body that does not take the shape raises on the
# card. Read once at import, as the JAX package reads it; tests set the
# module global.
_POOL_BWD_MODES = (None, "v1", "v2", "v2j", "v3")
TWOPASS_BODIES = ("v1", "v2", "v2j")


def _parse_pool_bwd_env(value):
    value = value or None
    if value not in _POOL_BWD_MODES:
        print(
            f"[gecco_tpu_torch] ignoring invalid GECCO_POOL_BWD={value!r} "
            f"(expected {'|'.join(m for m in _POOL_BWD_MODES if m)}); "
            "using the shape-gated default",
            file=sys.stderr,
        )
        return None
    return value


_POOL_BWD_ENV = _parse_pool_bwd_env(os.environ.get("GECCO_POOL_BWD"))


def group_indicator(c: int, num_groups: int, device=None) -> torch.Tensor:
    """[C, G] 0/1 fp32 matrix mapping each channel to its group."""
    ch = torch.arange(c, device=device) // (c // num_groups)
    return (ch[:, None] == torch.arange(num_groups, device=device)[None, :]).float()


def fold_qf(ind2: torch.Tensor, kvw: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[C, J] folded pool query operand, ``qf[c, hI+i] = s * sum_d
    Wk[hD+d, c] ind2[hI+i, d]`` (fp32 fold, cast to kvw's dtype)."""
    j, d = ind2.shape
    c = kvw.shape[1]
    i = j // num_heads
    qf = torch.einsum(
        "hdc,hid->chi",
        kvw[:c].float().reshape(num_heads, d, c),
        ind2.float().reshape(num_heads, i, d),
    )
    return ((1.0 / d**0.5) * qf).reshape(c, j).to(kvw.dtype)


def _row_tile(n: int, c: int) -> int:
    """Point tile of the MLP kernels and the megakernel: 64 rows where the
    [TN, C] fp32 output fits the register tiles (8 warps, each TN/16 rows
    x ceil(C/128) columns of 16 x 16 tiles, at most 12), else 32."""
    for tn in (64, 32):
        if -(-c // 128) * (tn // 16) <= 12 and n % tn == 0:
            return tn
    raise ValueError(f"no point tile divides N={n} at C={c}")


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: the CUDA kernel needs {what}")


def _check(name: str, tensors: dict, dtypes: dict, dt) -> None:
    """``check_cuda`` against the bf16 bodies' ``dtypes``, or, where the
    operands' route dtype ``dt`` is fp32, against fp32 for every one."""
    check_cuda(name, tensors, {k: _F32 for k in tensors} if dt == _F32 else dtypes)


# the point axis of the bodies' operands is a multiple of this (the Hopper
# MLP's 128-row block; every other body's tile divides it)
_N_ALIGN = 128


def _n_pad(n: int) -> int:
    """The padded point count of N points: the next multiple of 128."""
    return -(-n // _N_ALIGN) * _N_ALIGN


def _pad_points(t: torch.Tensor, n_pad: int) -> torch.Tensor:
    """t [B, N, K] zero-padded on its point (or inducer) axis to n_pad rows;
    t itself where N is n_pad already."""
    n = t.shape[1]
    return t if n == n_pad else torch.nn.functional.pad(t, (0, 0, 0, n_pad - n))


def _unpad(t: torch.Tensor, n: int) -> torch.Tensor:
    """The first n points of t [B, N_pad, K], contiguous (t itself where
    N_pad is n)."""
    return t if t.shape[1] == n else t[:, :n].contiguous()


# the inducer count of the bodies' operands is a multiple of this (the
# tensor-core tile); a ragged I is zero-padded to it per head
_I_ALIGN = 16


def _i_pad(i: int) -> int:
    """The padded inducer count of I inducers: the next multiple of 16."""
    return -(-i // _I_ALIGN) * _I_ALIGN


def _pad_heads(t: torch.Tensor, num_heads: int, i_pad: int) -> torch.Tensor:
    """t [H I, K] (rows (h, i)) zero-padded per head to [H i_pad, K]; t
    itself where I is i_pad already."""
    j, k = t.shape
    i = j // num_heads
    if i == i_pad:
        return t
    out = t.new_zeros((num_heads, i_pad, k))
    out[:, :i] = t.reshape(num_heads, i, k)
    return out.reshape(num_heads * i_pad, k)


def _unpad_heads(t: torch.Tensor, num_heads: int, i: int) -> torch.Tensor:
    """The first i rows of each head of t [H i_pad, K] -> [H i, K]."""
    j, k = t.shape
    if j == num_heads * i:
        return t
    return t.reshape(num_heads, j // num_heads, k)[:, :i].reshape(num_heads * i, k)


def _valid_rows(n: int, n_valid, device) -> torch.Tensor | None:
    """[N, 1] bool mask of the first ``n_valid`` points, or None where all
    N are points (``n_valid`` None or N): the plain pieces' form of the
    bodies' padding masks."""
    if n_valid is None or n_valid == n:
        return None
    return (torch.arange(n, device=device) < n_valid)[:, None]


# ------------------------------------------------------------------ pool --


def _pool_ref_from_y(y, ind2, kvw, wo, num_heads: int, n_valid=None) -> torch.Tensor:
    """The pool of the pre-normed stream y [B, N, C] onto the inducers, as
    both plain versions compute it from y on: h0 [B, I, C] in y's dtype;
    the points from ``n_valid`` on (a ragged tail's padding) take no part
    in the softmax."""
    dt = y.dtype
    b, n, c = y.shape
    j, d = ind2.shape
    i = j // num_heads
    qf = fold_qf(ind2.to(dt), kvw.to(dt), num_heads)
    logits = torch.einsum("bnc,cj->bnj", y.float(), qf.float())
    ok = _valid_rows(n, n_valid, y.device)
    if ok is not None:
        logits = logits.masked_fill(~ok, -torch.inf)
    lg = logits.reshape(b, n, num_heads, i)
    p = torch.exp(lg - lg.amax(1, keepdim=True).detach())
    p = (p / p.sum(1, keepdim=True)).to(dt)
    v = torch.einsum("bnc,dc->bnd", y.float(), kvw[c:].to(dt).float()).to(dt)
    pooled = torch.einsum(
        "bnhi,bnhd->bihd", p.float(), v.reshape(b, n, num_heads, d).float()
    ).to(dt)
    return torch.einsum(
        "bic,oc->bio", pooled.reshape(b, i, c).float(), wo.to(dt).float()
    ).to(dt)


def _pool_ext_ref(x, se, be, ind2, kvw, wo, num_heads: int) -> torch.Tensor:
    """Plain version (the JAX package's ``_pool_ext_ref``): h0 [B, I, C]."""
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(x.dtype)
    return _pool_ref_from_y(y, ind2, kvw, wo, num_heads)


# points per chunk of the pool's chunk kernel (csrc/pool_ext.cu kTM): the
# partials are sized by it
_POOL_CHUNK = 64
# the head widths of the chunk kernel's instances (csrc/pool_ext.cu
# chunk_smem's cases)
_POOL_HOPPER_WIDTHS = (16, 32, 48, 64)


def _pool_ext_group(num_heads: int) -> int:
    """Heads per block of the chunk kernel (csrc/pool_ext.cu's G): 8 where H
    % 8 == 0, else 4 (two heads per consumer warpgroup)."""
    return 8 if num_heads % 8 == 0 else 4


def _pool_ext_smem(c: int, d: int, g: int) -> int:
    """Bytes of one block of the Hopper pool's chunk kernel: csrc/pool_ext.cu
    ``ChunkSmem<HD, G>`` (change both together): the y tile, each
    warpgroup's weight ring (three stages at G 8, two at G 4) of a qf^T and
    a Wv_h panel, e^T and v^T, the reductions, the barriers and the
    alignment slack."""
    ring = 3 if g == 8 else 2
    return ((c // 64) * _POOL_CHUNK * 128 + 2 * ring * (64 * 128 + d * 128) + 2 * 64 * 128
            + 2 * d * 128 + 2 * 2 * 4 * 64 * 4 + (1 + 4 * ring) * 8 + 1024)


def _pool_ext_hopper_takes(c: int, num_heads: int, i: int) -> bool:
    """The shapes of the Hopper pool's chunk kernel (csrc/pool_ext.cu
    ``chunk_smem``: change both together): I == 64, C % 64 == 0 up to 768,
    H % 4 == 0, D = C / H in ``_POOL_HOPPER_WIDTHS``, the block's shared
    memory within the SM's."""
    if i != 64 or num_heads < 1 or c % num_heads or c % 64 or c > 768 or num_heads % 4:
        return False
    d = c // num_heads
    return (d in _POOL_HOPPER_WIDTHS
            and _pool_ext_smem(c, d, _pool_ext_group(num_heads)) <= _MAX_SMEM)


def _fold_qft_ref(ind2, kvw, num_heads: int) -> torch.Tensor:
    """Plain version of ``pool_fold_kernel``: the folded query transposed,
    qf^T [J, C] in kvw's dtype."""
    return fold_qf(ind2, kvw, num_heads).t()


def _pool_partials_ref(x, se, be, qft, kvw, num_heads: int, n_valid=None) -> tuple:
    """Plain version of ``pool_chunk_kernel``: per chunk of ``_POOL_CHUNK`` points
    of y = x*se+be, each column's max m and sum l of e = exp(max(s - m,
    -80)) [B, N/rows, J] and P = e^T @ v [B, N/rows, J, D], fp32 (e and v
    rounded to x's dtype before the product). Points from ``n_valid`` on
    (a ragged tail's padding) take no part: a chunk of padding alone gives
    m = -inf, l = 0 and P = 0."""
    dt = x.dtype
    b, n, c = x.shape
    j = qft.shape[0]
    i, d = j // num_heads, c // num_heads
    rows = _POOL_CHUNK
    k = n // rows
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt)
    s = torch.einsum("bnc,jc->bnj", y.float(), qft.float())
    v = torch.einsum("bnc,dc->bnd", y.float(), kvw[c:].float()).to(dt)
    ok = _valid_rows(n, n_valid, x.device)
    if ok is not None:
        s = s.masked_fill(~ok, -torch.inf)
    s = s.reshape(b, k, rows, j)
    m = s.amax(2)
    e = torch.exp(torch.clamp(s - m[:, :, None], min=-80.0))
    if ok is not None:
        e = e.masked_fill(~ok.reshape(1, k, rows, 1), 0.0)
    p = torch.einsum(
        "bkrhi,bkrhd->bkhid", e.to(dt).float().reshape(b, k, rows, num_heads, i),
        v.float().reshape(b, k, rows, num_heads, d),
    )
    return m, e.sum(2), p.reshape(b, k, j, d)


def _pool_merge_ref(m, l, p, wo, num_heads: int) -> tuple:
    """Plain version of ``pool_merge_kernel`` and the output projection: the
    chunks' partials rescaled by exp(max(m_c - M, -80)) and summed ->
    (h0 [B, I, C] in wo's dtype, M, L [B, J] fp32)."""
    mm = m.amax(1)
    corr = torch.exp(torch.clamp(m - mm[:, None], min=-80.0))
    ll = (corr * l).sum(1)
    pp = (corr[..., None] * p).sum(1)
    b, j, d = pp.shape
    i = j // num_heads
    pooled = (pp * (1.0 / ll)[..., None]).to(wo.dtype)
    pooled = pooled.reshape(b, num_heads, i, d).permute(0, 2, 1, 3).reshape(b, i, num_heads * d)
    h0 = torch.einsum("bic,oc->bio", pooled.float(), wo.float()).to(wo.dtype)
    return h0, mm, ll


# csrc/common.cuh's kMaxSmem (a block's shared memory on sm_90), kPad and
# kPadF (the bf16 and fp32 row padding) and csrc/pool.cuh's kPoolTile, which
# the mirrors below of the WMMA bodies' shared-memory plans read
# (test_torch_kernels.py holds them to the headers' values)
_MAX_SMEM, _PAD, _PADF, _POOL_TILE = 232448, 8, 4, 64


def _pool_wmma_smem(c: int, i: int, d: int) -> int:
    """Bytes of one block of the WMMA pool body: csrc/pool.cuh PoolSmem's
    ``total_unstaged`` (change both together): the stream tile, logits,
    values, the tile's e^T v, the accumulator, the statistics and the bf16
    e and v."""
    t = _POOL_TILE
    return (t * (c + _PAD) * 2 + t * (i + _PADF) * 4 + t * (d + _PADF) * 4
            + i * (d + _PADF) * 4 + i * d * 4 + 3 * i * 4 + t * (i + _PAD) * 2
            + t * (d + _PAD) * 2)


def _pool_wmma_block(c: int, i: int, d: int) -> int:
    """The column block of a WMMA pool block (both pool forwards' WMMA
    bodies): I itself, else the largest multiple of 16 dividing I, whose
    layout (``_pool_wmma_smem``) fits the SM's shared memory; 0 where not
    even 16 columns fit. csrc/pool.cuh ``pool_wmma_block`` (change both
    together)."""
    for ib in range(i, 15, -16):
        if i % ib == 0 and _pool_wmma_smem(c, ib, d) <= _MAX_SMEM:
            return ib
    return 0


def _pool_ext_body(b: int, n: int, c: int, num_heads: int, i: int, dtype=_BF16) -> str:
    """Which forward body of ``folded_pool_ext`` takes these shapes on the
    card: "f32" (``f32.pool_ext_fwd``, any shape) for fp32 operands; for
    bf16 ones "hopper" (csrc/pool_ext.cu, TMA and wgmma: I == 64, D in (16, 32,
    48, 64), H % 4 == 0, C % 64 == 0, C <= 768: ``_pool_ext_hopper_takes``;
    the flagship, the 8k width and the upsample demo's C 128) where it can,
    else "wmma"
    (csrc/pool_ext_wmma.cu: C % 64, D % 16 and I % 16 == 0, a block of 16
    of a head's columns within the SM's shared memory: ``_pool_wmma_block``,
    any I at C <= 768); both need B*I % 64 == 0 and take any N (padded)
    and any I (a ragged I zero-padded to 16s: its padding inducers' columns
    are pooled and sliced off, the I of these conditions the padded one).
    Raises ValueError with both bodies' conditions otherwise."""
    if dtype == _F32:
        return "f32"
    d = c // num_heads
    i = _i_pad(i)
    common = c % num_heads == 0 and n >= 1 and (b * i) % 64 == 0
    if common and _pool_ext_hopper_takes(c, num_heads, i):
        return "hopper"
    if common and c % 64 == 0 and d % 16 == 0 and _pool_wmma_block(c, i, d):
        return "wmma"
    raise ValueError(
        f"folded_pool_ext: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs I == 64, D in {_POOL_HOPPER_WIDTHS}, H % 4 == 0, "
        f"C % 64 == 0 and C <= 768; the WMMA body C % 64, D % 16, I % 16 == 0 and a block "
        f"of 16 columns within {_MAX_SMEM} bytes of shared memory; both B*I % 64 == 0")


def _pool_ext_launch(x, se, be, ind2, kvw, wo, num_heads: int, stats: bool,
                     body: str | None = None):
    """The forward kernels of the body ``_pool_ext_body`` picks -> (h0,
    qft, macc, sacc): the folded query qf^T [J, C] the logits were formed
    with, and the softmax's column max and sum [B, J] fp32, when ``stats``
    (else Nones). The Hopper body runs four launches (fold, chunks, merge,
    output projection), the WMMA body two (per-head pool, output
    projection) on a fold in PyTorch. ``body`` ("hopper" or "wmma") forces
    one where both take the shapes, for timing the two in turns; a forced
    body that does not take them fails its launch."""
    name = "folded_pool_ext"
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    dt = f32.route(name, dict(x=x, ind2=ind2, kvw=kvw, wo=wo))
    _check(name, dict(x=x, se=se, be=be, ind2=ind2, kvw=kvw, wo=wo),
           dict(x=_BF16, se=_F32, be=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16), dt)
    body = body or _pool_ext_body(b, n, c, num_heads, i, dt)
    if body == "f32":
        h0, qft, macc, sacc = f32.pool_ext_fwd(x, se, be, ind2, kvw, wo, num_heads)
        folded_pool_ext.launches_f32 += 1
        return (h0, qft, macc, sacc) if stats else (h0, None, None, None)
    dev = x.device
    n_pad = _n_pad(n)
    x = _pad_points(x, n_pad)
    i_valid, i = i, _i_pad(i)
    ind2 = _pad_heads(ind2, num_heads, i)
    j = num_heads * i
    pooled = torch.empty((b, i, c), dtype=_BF16, device=dev)
    h0 = torch.empty_like(pooled)
    macc = torch.empty((b, j), dtype=_F32, device=dev) if stats else None
    sacc = torch.empty_like(macc) if stats else None
    if body == "hopper":
        rows = _POOL_CHUNK
        qft = torch.empty((j, c), dtype=_BF16, device=dev)
        part_m = torch.empty((b, n_pad // rows, j), dtype=_F32, device=dev)
        part_l = torch.empty_like(part_m)
        part_p = torch.empty((b, n_pad // rows, j, d), dtype=_F32, device=dev)
        launch("pool_ext", "pool_ext_launch", x, se, be, ind2, kvw, wo, qft, part_m, part_l,
               part_p, pooled, h0, macc, sacc, b, n_pad, c, num_heads, i, n)
        folded_pool_ext.launches += 1
    else:
        qf = fold_qf(ind2, kvw, num_heads).contiguous()
        launch("pool_ext_wmma", "pool_ext_wmma_launch", x, se, be, qf, kvw, wo, pooled, h0,
               macc, sacc, b, n_pad, c, num_heads, i, n)
        folded_pool_ext.launches_wmma += 1
        qft = qf.t().contiguous() if stats else None
    if i != i_valid:  # the statistics stay padded: the backward takes them so
        h0 = h0[:, :i_valid].contiguous()
    return (h0, qft, macc, sacc) if stats else (h0, None, None, None)


class _PoolExt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, se, be, ind2, kvw, wo, num_heads, need_grad):
        qft = macc = sacc = None
        if x.device.type == "cpu":
            h0 = _pool_ext_ref(x, se, be, ind2, kvw, wo, num_heads)
        else:
            h0, qft, macc, sacc = _pool_ext_launch(x, se, be, ind2, kvw, wo, num_heads,
                                                   need_grad)
        if need_grad:
            ctx.save_for_backward(x, se, be, ind2, kvw, wo, qft, macc, sacc)
        ctx.num_heads = num_heads
        return h0

    @staticmethod
    def backward(ctx, g_h0):
        x, se, be, ind2, kvw, wo, qft, macc, sacc = ctx.saved_tensors
        grads = folded_pool_ext_bwd(x, se, be, ind2, kvw, wo, qft, macc, sacc, g_h0,
                                    ctx.num_heads)
        return (*grads, None, None)


def folded_pool_ext(x, se, be, ind2, kvw, wo, num_heads: int) -> torch.Tensor:
    """x [B, N, C]; se/be [B, C] fp32 (the collapsed pre-norm ``x*se+be``,
    applied inline); ind2 [J, D] inducers; kvw [2C, C]; wo [C, C]
    -> h0 [B, I, C]. Differentiable in every tensor argument."""
    need = needs_grad(x, se, be, ind2, kvw, wo)
    return _PoolExt.apply(x, se, be, ind2, kvw, wo, num_heads, need)


folded_pool_ext.launches = 0
folded_pool_ext.launches_wmma = 0
folded_pool_ext.launches_f32 = 0


def _chain_dqf(dqf, dwv, ind2, kvw, num_heads: int) -> tuple:
    """The folded query's gradient dqf [C, J] fp32 through the fold
    jacobian to the inducers and Wk, beside the value weight's dwv [C, C]
    -> (dind2, dkvw) (plain PyTorch, as the JAX package leaves it to XLA)."""
    c, j = dqf.shape
    d = ind2.shape[1]
    i = j // num_heads
    scale = 1.0 / d**0.5
    dqf_r = dqf.reshape(c, num_heads, i)
    dwk = scale * torch.einsum(
        "chi,hid->hdc", dqf_r, ind2.float().reshape(num_heads, i, d)).reshape(c, c)
    dind2 = scale * torch.einsum(
        "chi,hdc->hid", dqf_r, kvw[:c].float().reshape(num_heads, d, c)).reshape(j, d)
    return dind2.to(ind2.dtype), torch.cat([dwk, dwv], dim=0).to(kvw.dtype)


def _pool_ext_bwd_ref(x, se, be, ind2, kvw, wo, g_h0, num_heads: int) -> tuple:
    """Plain version of the pool backward: autograd through
    ``_pool_ext_ref`` -> (dx, dse, dbe, dind2, dkvw, dwo)."""
    return vjp(lambda *a: _pool_ext_ref(*a, num_heads), (x, se, be, ind2, kvw, wo), (g_h0,))


def _prenormed(x, se, be) -> torch.Tensor:
    """y = x * se + be rounded to x's dtype, as fp32."""
    return (x.float() * se[:, None, :] + be[:, None, :]).to(x.dtype).float()


def _pool_bwd_ety_ref(x, se, be, qft, macc, n_valid=None) -> torch.Tensor:
    """Plain version of ``pool_bwd_ety_kernel``: eTy = bf16(e)^T y [B, J, C]
    in x's dtype, e = exp(max(y qf - macc, -80)), zero on the points from
    ``n_valid`` on (a ragged tail's padding)."""
    dt = x.dtype
    y = _prenormed(x, se, be)
    s = torch.einsum("bnc,jc->bnj", y, qft.float())
    e = torch.exp(torch.clamp(s - macc[:, None], min=-80.0))
    ok = _valid_rows(x.shape[1], n_valid, x.device)
    e = (e if ok is None else e.masked_fill(~ok, 0.0)).to(dt)
    return torch.einsum("bnj,bnc->bjc", e.float(), y).to(dt)


def _pool_bwd_fold_ref(ety, g_h0, kvw, wo, sacc, num_heads: int) -> tuple:
    """Plain version of ``pool_bwd_fold_kernel`` (without W2) -> (tacc
    [B, J] fp32, W3 [B, J, C] in ety's dtype, dWv and dWo [C, C] fp32):
    DMs = (g_h0 @ Wo_h) / sacc and pacc / sacc rounded to ety's dtype."""
    dt = ety.dtype
    b, j, c = ety.shape
    i, d = j // num_heads, c // num_heads
    wv = kvw[c:].float().reshape(num_heads, d, c)
    inv = (1.0 / sacc).reshape(b, num_heads, i, 1)
    g = g_h0.float()
    dms = torch.einsum("bio,ohd->bhid", g, wo.float().reshape(c, num_heads, d))
    dms = (dms * inv).to(dt).float()
    ety_h = ety.float().reshape(b, num_heads, i, c)
    pacc = torch.einsum("bhic,hdc->bhid", ety_h, wv)
    tacc = ((dms * pacc).sum(-1) * inv[..., 0]).reshape(b, j)
    merged = (pacc * inv).to(dt).float()
    dwo = torch.einsum("bio,bhid->ohd", g, merged).reshape(c, c)
    dwv = torch.einsum("bhid,bhic->hdc", dms, ety_h).reshape(c, c)
    w3 = torch.einsum("bhid,hdc->bhic", dms, wv).to(dt).reshape(b, j, c)
    return tacc, w3, dwv, dwo


def _pool_bwd_dy_ref(x, se, be, qft, w3, macc, tacc, n_valid=None) -> tuple:
    """Plain version of ``pool_bwd_dy_kernel`` -> (dx in x's dtype, dse,
    dbe [B, C] fp32, ds [B, N, J] in x's dtype): ds = e (y W3^T - tacc)
    where s - macc > -80, dy = ds qf^T + e W3 (e and ds rounded first); e
    and ds zero on the points from ``n_valid`` on."""
    dt = x.dtype
    y = _prenormed(x, se, be)
    z = torch.einsum("bnc,jc->bnj", y, qft.float()) - macc[:, None]
    e = torch.exp(torch.clamp(z, min=-80.0))
    ok = _valid_rows(x.shape[1], n_valid, x.device)
    if ok is not None:
        e = e.masked_fill(~ok, 0.0)
    dp = torch.einsum("bnc,bjc->bnj", y, w3.float())
    ds = torch.where(z > -80.0, e * (dp - tacc[:, None]), 0.0).to(dt)
    dy = (torch.einsum("bnj,jc->bnc", ds.float(), qft.float())
          + torch.einsum("bnj,bjc->bnc", e.to(dt).float(), w3.float()))
    return (dy * se[:, None]).to(dt), (dy * x.float()).sum(1), dy.sum(1), ds


def _pool_bwd_dqf_ref(x, se, be, ds) -> torch.Tensor:
    """Plain version of the dqf product (``wgrad_kernel``) and its sum: dqf = the sum
    over the batch of y^T ds [C, J] fp32."""
    return torch.einsum("bnc,bnj->cj", _prenormed(x, se, be), ds.float())


# inducer rows of a head per block of the pool backward's fold
# (csrc/backward.cuh kFoldRows)
_FOLD_ROWS = 64


def _pool_bwd_fold_smem(c: int, i: int, d: int) -> int:
    """Bytes of one block of the pool backward's fold (both bodies):
    csrc/backward.cuh ``pool_bwd_fold_smem`` (change both together): the
    product buffer, DMs_h and merged_h of the block's rows [min(I, 64), D]
    bf16, their pacc_h [min(I, 64), D] fp32. A block takes up to 64 of a
    head's inducer rows, so the bytes stop growing with I there."""
    rows = min(i, _FOLD_ROWS)
    return 64 * (64 + _PADF) * 4 + 2 * rows * (d + _PAD) * 2 + rows * (d + _PADF) * 4


def _pool_ext_bwd_smem(c: int) -> tuple:
    """Bytes of the Hopper pool backward's pass-0 and pass-1 blocks at C
    128, 384 or 768: csrc/pool_ext_bwd.cu ``EtySmem`` at the launcher's ring
    depth (as many 64-point stages as fit, up to three) and ``DySmem`` at
    its chunk (64 rows of J, 32 at C 768); change them together. At C 128
    two blocks of each pass share a SM."""
    panel, kp = 64 * 128, c // 64
    stages = min(3, (_MAX_SMEM - (kp + 1) * panel - 8 - 1024) // (kp * panel))
    jc = 32 if c == 768 else 64
    return ((1 + stages) * kp * panel + panel + (1 + stages) * 8 + 1024,
            kp * panel + 2 * kp * jc * 128 + 2 * panel + 2 * 8 + 1024)


def _twopass_smem(c: int, i: int, d: int) -> int:
    """Bytes of the larger block of the v1, v2 and v2j bodies' two passes:
    csrc/pool_bwd_twopass.cuh ``Pass0Smem`` and ``Pass1Smem`` (change them
    together), each region rounded up to 128 bytes."""
    r = lambda n: -(-n // 128) * 128
    t = 32  # the passes' point tile, kTN
    pass0 = (r(t * (c + _PAD) * 2) + r(t * (i + _PADF) * 4) + r(t * (d + _PADF) * 4)
             + r(t * (d + _PAD) * 2) + r(t * (i + _PAD) * 2) + r(i * (d + _PADF) * 4)
             + r(i * (d + _PAD) * 2) + r(t * (i + _PADF) * 4) + r(i * 4))
    pass1 = (r(max(t * (c + _PAD) * 2, t * (c + _PADF) * 4)) + 2 * r(t * (i + _PADF) * 4)
             + r(t * (d + _PADF) * 4) + r(t * (d + _PAD) * 2) + r(i * (d + _PAD) * 2)
             + 2 * r(t * (i + _PAD) * 2) + r(t * (d + _PAD) * 2))
    return max(pass0, pass1)


def _pool_twopass_takes(b: int, n: int, c: int, num_heads: int, i: int) -> bool:
    """The shapes of the v1, v2 and v2j bodies (csrc/pool_bwd_twopass.cuh
    ``twopass::takes``: change both together): C % 128 == 0 up to 768, D %
    16 == 0, I % 16 == 0 with J % 64 == 0 (the weight gradients' 64-column
    tail) and B*I % 64 == 0, both passes' blocks within the SM's shared
    memory (``_twopass_smem``), and any N (a ragged N zero-padded to 128s
    and masked)."""
    d = c // num_heads
    return (c % 128 == 0 and c <= 768 and c % num_heads == 0 and d % 16 == 0 and i % 16 == 0
            and (num_heads * i) % 64 == 0 and (b * i) % 64 == 0 and n >= 1
            and _twopass_smem(c, i, d) <= _MAX_SMEM)


def _pool_ext_bwd_body(b: int, n: int, c: int, num_heads: int, i: int, dtype=_BF16) -> str:
    """Which body of ``folded_pool_ext_bwd`` takes these shapes on the card.
    For fp32 operands "f32" (``f32.pool_ext_bwd``, any shape; v3 and the
    forced v1, v2 and v2j compute the same function, so one fp32 route
    serves them all). For bf16 ones: unset or "v3", ``GECCO_POOL_BWD`` gives the v3 algebra's: "hopper"
    (csrc/pool_ext_bwd.cu, TMA and wgmma: C in (128, 384, 768), I == 64:
    the flagship, the 8k width, the upsample demo's C 128 and three heads'
    D 128) where it can, else "wmma" (csrc/pool_ext_bwd_wmma.cu: C % 128
    == 0, C <= 768, I % 16 and J % 64 == 0: another I, C 256, 512 or 640);
    both need D % 16 == 0 and the fold's block within the SM's shared
    memory (``_pool_bwd_fold_smem``), and take any N (padded). Forced to
    "v1", "v2" or "v2j", that algebra (the JAX package's opt-in bodies,
    ``_pool_twopass_takes``): its Hopper body ("v1", "v2", "v2j";
    csrc/pool_ext_bwd_twopass.cu, ``_pool_twopass_hopper_takes``: the
    flagship's and the 8k width's training shapes, three heads' D 128)
    where it can, else its WMMA body ("v1_wmma" ...: the demo's C 128).
    The chosen name is the counter's, ``folded_pool_ext_bwd_<name>``.
    Raises ValueError with the chosen bodies' conditions otherwise. A
    ragged I takes the bodies of its count padded to 16s."""
    if dtype == _F32:
        return "f32"
    d = c // num_heads
    i = _i_pad(i)
    j = num_heads * i
    mode = _POOL_BWD_ENV
    if mode in TWOPASS_BODIES:
        if _pool_twopass_hopper_takes(b, n, c, num_heads, i):
            return mode
        if _pool_twopass_takes(b, n, c, num_heads, i):
            return f"{mode}_wmma"
        raise ValueError(
            f"folded_pool_ext_bwd: GECCO_POOL_BWD={mode} forces a body that does not take "
            f"B={b}, N={n}, C={c}, H={num_heads}, I={i} (D={d}): the v1, v2 and v2j bodies "
            f"need C % 128 == 0, C <= 768, D % 16 == 0, J % 64 == 0, B*I % 64 == 0 and both "
            f"passes' blocks within {_MAX_SMEM} bytes of shared memory")
    common = (c % num_heads == 0 and d % 16 == 0 and n >= 1
              and _pool_bwd_fold_smem(c, i, d) <= _MAX_SMEM)
    if (common and c in (128, 384, 768) and i == 64
            and max(_pool_ext_bwd_smem(c)) <= _MAX_SMEM):
        return "hopper"
    if common and c % 128 == 0 and c <= 768 and i % 16 == 0 and j % 64 == 0:
        return "wmma"
    raise ValueError(
        f"folded_pool_ext_bwd: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs C in (128, 384, 768) and I == 64; the WMMA body "
        f"C % 128 == 0, C <= 768, I % 16 == 0 and J % 64 == 0; both D % 16 == 0 and the "
        f"fold's block within {_MAX_SMEM} bytes of shared memory")


def folded_pool_ext_bwd(x, se, be, ind2, kvw, wo, qft, macc, sacc, g_h0,
                        num_heads: int) -> tuple:
    """Gradients of ``folded_pool_ext`` against ``g_h0`` [B, I, C], from
    the forward's inputs, the folded query ``qft`` [J, C] its logits were
    formed with (so that the backward's logits are the forward's, as the
    statistics assume) and its softmax statistics ``macc``/``sacc`` [B, J]
    -> (dx, dse, dbe, dind2, dkvw, dwo), through the body that
    ``_pool_ext_bwd_body`` picks. CPU tensors take the plain version
    (which needs none of the forward's results). A ragged I goes
    zero-padded to 16s as in the forward, whose qft and statistics are
    padded already; the padding inducers take a zero cotangent."""
    if x.device.type == "cpu":
        return _pool_ext_bwd_ref(x, se, be, ind2, kvw, wo, g_h0, num_heads)
    name = "folded_pool_ext_bwd"
    b, n, c = x.shape
    i = ind2.shape[0] // num_heads
    dt = f32.route(name, dict(x=x, ind2=ind2, kvw=kvw, wo=wo, qft=qft))
    if _pool_ext_bwd_body(b, n, c, num_heads, i, dt) == "f32":
        g = g_h0.to(_F32).contiguous()
        _check(name, dict(x=x, se=se, be=be, ind2=ind2, kvw=kvw, wo=wo, qft=qft, g=g,
                          macc=macc, sacc=sacc), {}, _F32)
        dx, dse, dbe, dqf, dwv, dwo = f32.pool_ext_bwd(x, se, be, qft, kvw, wo, macc, sacc, g,
                                                       num_heads)
        folded_pool_ext_bwd.launches_f32 += 1
        return (dx, dse, dbe, *_chain_dqf(dqf, dwv, ind2, kvw, num_heads), dwo)
    ip = _i_pad(i)
    ind2_in, ind2 = ind2, _pad_heads(ind2, num_heads, ip)
    g = _pad_points(g_h0.to(x.dtype), ip).contiguous()
    check_cuda(
        name, dict(x=x, se=se, be=be, ind2=ind2, kvw=kvw, wo=wo, qft=qft, g=g, macc=macc,
                   sacc=sacc),
        dict(x=_BF16, se=_F32, be=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16, qft=_BF16, g=_BF16,
             macc=_F32, sacc=_F32),
    )
    body = _pool_ext_bwd_body(b, n, c, num_heads, i)
    if body == "hopper":
        dx, dse, dbe, dqf, dwv, dwo, _ = _pool_ext_bwd_hopper(x, se, be, qft, kvw, wo, g, macc,
                                                              sacc, num_heads)
    elif body == "wmma":
        dx, dse, dbe, dqf, dwv, dwo = _pool_ext_bwd_wmma(x, se, be, qft, kvw, wo, g, macc, sacc,
                                                         num_heads)
    else:
        algebra, _, impl = body.partition("_")
        dx, dse, dbe, dqf, dwv, dwo = _pool_ext_bwd_twopass(x, se, be, qft, kvw, wo, g, macc,
                                                            sacc, num_heads, algebra,
                                                            impl or "hopper")
    dind2, dkvw = _chain_dqf(dqf, dwv, ind2, kvw, num_heads)
    return (dx, dse, dbe, _unpad_heads(dind2, num_heads, i).to(ind2_in.dtype), dkvw,
            dwo.to(wo.dtype))


def _pool_ext_bwd_hopper(x, se, be, qft, kvw, wo, g, macc, sacc, num_heads: int) -> tuple:
    """The kernel (csrc/pool_ext_bwd.cu) -> (dx, dse, dbe, dqf, dwv, dwo,
    intermediates): the last a dict of the passes' eTy, W3, tacc and ds
    (ds at the padded point count), which ``probes.pool_bwd`` holds against
    their plain pieces."""
    b, n_valid, c = x.shape
    n = _n_pad(n_valid)
    x = _pad_points(x, n)
    j = qft.shape[0]
    i = j // num_heads
    dev = x.device
    buf = dict(
        ety=torch.empty((b, j, c), dtype=_BF16, device=dev),
        w3=torch.empty((b, j, c), dtype=_BF16, device=dev),
        tacc=torch.empty((b, j), dtype=_F32, device=dev),
        ds=torch.empty((b, n, j), dtype=_BF16, device=dev),
        dx=torch.empty_like(x),
        dse=torch.zeros((b, c), dtype=_F32, device=dev),
        dbe=torch.zeros((b, c), dtype=_F32, device=dev),
        dwv=torch.zeros((c, c), dtype=_F32, device=dev),
        dwo=torch.zeros((c, c), dtype=_F32, device=dev),
    )
    dqf = torch.empty((c, j), dtype=_F32, device=dev)
    splits = _wgrad_splits(1, b * n // 64, c, j, x.device)
    part = torch.empty((splits, c, j), dtype=_F32, device=x.device) if splits > 1 else None
    launch("pool_ext_bwd", "pool_ext_bwd_launch", x, se, be, qft, kvw, wo, g, macc, sacc,
           torch.empty_like(x), buf["ety"], buf["w3"], buf["tacc"], buf["ds"], buf["dx"],
           buf["dse"], buf["dbe"], part, dqf, buf["dwv"], buf["dwo"], b, n, c, num_heads, i,
           splits, n_valid)
    folded_pool_ext_bwd.launches += 1
    return (_unpad(buf["dx"], n_valid), buf["dse"], buf["dbe"], dqf, buf["dwv"], buf["dwo"],
            {k: buf[k] for k in ("ety", "w3", "tacc", "ds")})


def _pool_ext_bwd_wmma(x, se, be, qft, kvw, wo, g, macc, sacc, num_heads: int) -> tuple:
    """The WMMA body (csrc/pool_ext_bwd_wmma.cu), the same algebra as the
    Hopper body's -> (dx, dse, dbe, dqf, dwv, dwo)."""
    b, n_valid, c = x.shape
    n = _n_pad(n_valid)
    x = _pad_points(x, n)
    j = qft.shape[0]
    i = j // num_heads
    dev = x.device
    dx = torch.empty_like(x)
    dse = torch.zeros((b, c), dtype=_F32, device=dev)
    dbe = torch.zeros_like(dse)
    dqf = torch.zeros((c, j), dtype=_F32, device=dev)
    dwv = torch.zeros((c, c), dtype=_F32, device=dev)
    dwo = torch.zeros_like(dwv)
    launch("pool_ext_bwd_wmma", "pool_ext_bwd_wmma_launch", x, se, be, qft, kvw, wo, g, macc,
           sacc, torch.empty((b, n, j), dtype=_BF16, device=dev),
           torch.zeros((b, c, j), dtype=_F32, device=dev),
           torch.empty((b, j, c), dtype=_BF16, device=dev),
           torch.empty((b, j, c), dtype=_BF16, device=dev),
           torch.empty((b, j), dtype=_F32, device=dev),
           torch.empty((b, n, j), dtype=_BF16, device=dev), dx, dse, dbe, dqf, dwv, dwo,
           b, n, c, num_heads, i, n_valid)
    folded_pool_ext_bwd.launches_wmma += 1
    return _unpad(dx, n_valid), dse, dbe, dqf, dwv, dwo


def _wgrad_splits(batch: int, tiles: int, m: int, p: int, device) -> int:
    """Splits of each batch element's 64-row tiles in the Hopper backwards'
    weight-gradient product (csrc/wgrad.cuh): enough blocks of (128 x 128
    output tile, a 64-column tail's included, batch element, split) to give
    every SM one, at most one split per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, -(-sms // (batch * (m // 128) * -(-p // 128)))))


# ------------------------------------------- pool backward: v1, v2, v2j --


def _twopass_sv_ref(x, se, be, qft, kvw) -> tuple:
    """The logits and values of the v1, v2 and v2j bodies (the Hopper
    body's two products over C) -> (S = y qf [B, N, J] fp32, V = bf16(y
    Wv^T) [B, N, C] in x's dtype), y = bf16(x se + be)."""
    c = x.shape[2]
    y = _prenormed(x, se, be)
    return (torch.einsum("bnc,jc->bnj", y, qft.float()),
            torch.einsum("bnc,dc->bnd", y, kvw[c:].float()).to(x.dtype))


def _twopass_e(s, macc, n_valid=None) -> tuple:
    """(z = s - macc, e = exp(max(z, -80))), e 0 on the points from
    ``n_valid`` on (a ragged tail's padding)."""
    z = s - macc[:, None]
    e = torch.exp(torch.clamp(z, min=-80.0))
    ok = _valid_rows(s.shape[1], n_valid, s.device)
    return z, (e if ok is None else e.masked_fill(~ok, 0.0))


def _twopass_recompute(x, se, be, qft, kvw, macc, num_heads: int, n_valid=None) -> tuple:
    """The tile recompute of the v1, v2 and v2j bodies, fp32 values of
    their roundings -> (y [B, N, C], z = s - macc and e = exp(max(z, -80))
    [B, N, J], v [B, N, H, D])."""
    b, n, _ = x.shape
    s, v = _twopass_sv_ref(x, se, be, qft, kvw)
    z, e = _twopass_e(s, macc, n_valid)
    return _prenormed(x, se, be), z, e, v.float().reshape(b, n, num_heads, -1)


def _twopass_dmerged(g_h0, wo, num_heads: int) -> torch.Tensor:
    """g_h0 @ Wo per head, fp32 [B, H, I, D]: the per-head blocks of the
    TPU bodies' [J, C] placement matrix (zero off its head's columns)."""
    b, i, c = g_h0.shape
    dm = torch.einsum("bio,oc->bic", g_h0.to(wo.dtype).float(), wo.float())
    return dm.reshape(b, i, num_heads, c // num_heads).permute(0, 2, 1, 3)


def _twopass_outputs(x, se, y, ds, dv, qft, kvw, g_h0, merged) -> tuple:
    """The part that v1, v2 and v2j share: dy = bf16(ds) qf^T + bf16(dv)
    Wv -> (dx in x's dtype, dse, dbe [B, C], dqf [C, J], dwv, dwo [C, C]
    fp32); dwo = g_h0^T bf16(merged), merged [B, H, I, D]."""
    b, n, c = x.shape
    wv = kvw[c:].float()
    dy = torch.einsum("bnj,jc->bnc", ds, qft.float()) + torch.einsum("bnd,dc->bnc", dv, wv)
    dwo = torch.einsum("bio,bhid->ohd", g_h0.to(x.dtype).float(), merged).reshape(c, c)
    return ((dy * se[:, None]).to(x.dtype), (dy * x.float()).sum(1), dy.sum(1),
            torch.einsum("bnc,bnj->cj", y, ds), torch.einsum("bnd,bnc->dc", dv, y), dwo)


def _pool_bwd_v1_ref(x, se, be, qft, kvw, wo, g_h0, macc, sacc, num_heads: int,
                     n_valid=None) -> tuple:
    """Plain version of the v1 body (csrc/pool_ext_bwd_v1.cu; the JAX
    package's ``_pool_ext_bwd_kernel_v1``) at its roundings -> (dx, dse,
    dbe, dqf, dwv, dwo). Pass 0: DM = bf16(g_h0 Wo) per head, dp = v DM^T,
    t = sum_n e dp, pacc = bf16(e)^T v; then t / sacc and merged =
    bf16(pacc / sacc). Pass 1: p = e / sacc, ds = bf16(p (dp - t)) where
    s - macc > -80, dv = bf16(bf16(p) DM). The points from ``n_valid`` on
    (a ragged tail's padding) take no part."""
    dt = x.dtype
    b, n, c = x.shape
    j = qft.shape[0]
    h = num_heads
    y, z, e, v = _twopass_recompute(x, se, be, qft, kvw, macc, h, n_valid)
    dm = _twopass_dmerged(g_h0, wo, h).to(dt).float()
    inv = 1.0 / sacc
    dp = torch.einsum("bnhd,bhid->bnhi", v, dm).reshape(b, n, j)
    t = (e * dp).sum(1) * inv
    eh = e.to(dt).float().reshape(b, n, h, -1)
    pacc = torch.einsum("bnhi,bnhd->bhid", eh, v)
    merged = (pacc * inv.reshape(b, h, -1, 1)).to(dt).float()
    p = e * inv[:, None]
    ds = torch.where(z > -80.0, p * (dp - t[:, None]), 0.0).to(dt).float()
    dv = torch.einsum("bnhi,bhid->bnhd", p.to(dt).float().reshape(b, n, h, -1), dm)
    dv = dv.to(dt).float().reshape(b, n, c)
    return _twopass_outputs(x, se, y, ds, dv, qft, kvw, g_h0, merged)


def _pool_bwd_v2_ref(x, se, be, qft, kvw, wo, g_h0, macc, sacc, num_heads: int,
                     n_valid=None) -> tuple:
    """Plain version of the v2 and v2j bodies (csrc/pool_ext_bwd_v2.cu; the
    JAX package's ``_pool_ext_bwd_kernel`` and ``_pool_ext_bwd_kernel_v2j``,
    one algebra) at their roundings -> (dx, dse, dbe, dqf, dwv, dwo). DMs =
    bf16(g_h0 Wo / sacc) per head; pass 0: pacc = bf16(e)^T v, then T =
    rowsum(DMs pacc) / sacc and merged = bf16(pacc / sacc); pass 1: ds =
    bf16(e (v DMs^T - T)) where s - macc > -80, dv = bf16(bf16(e) DMs).
    The points from ``n_valid`` on (a ragged tail's padding) take no
    part."""
    dt = x.dtype
    b, n, c = x.shape
    j = qft.shape[0]
    h = num_heads
    y, z, e, v = _twopass_recompute(x, se, be, qft, kvw, macc, h, n_valid)
    inv = (1.0 / sacc).reshape(b, h, -1, 1)
    dms = (_twopass_dmerged(g_h0, wo, h) * inv).to(dt).float()
    eh = e.to(dt).float().reshape(b, n, h, -1)
    pacc = torch.einsum("bnhi,bnhd->bhid", eh, v)
    tt = ((dms * pacc).sum(-1, keepdim=True) * inv).reshape(b, j)
    merged = (pacc * inv).to(dt).float()
    dp = torch.einsum("bnhd,bhid->bnhi", v, dms).reshape(b, n, j)
    ds = torch.where(z > -80.0, e * (dp - tt[:, None]), 0.0).to(dt).float()
    dv = torch.einsum("bnhi,bhid->bnhd", eh, dms).to(dt).float().reshape(b, n, c)
    return _twopass_outputs(x, se, y, ds, dv, qft, kvw, g_h0, merged)


# the plain version of each two-pass body (v2 and v2j are one algebra)
_TWOPASS_REFS = {"v1": _pool_bwd_v1_ref, "v2": _pool_bwd_v2_ref, "v2j": _pool_bwd_v2_ref}

# points per range of the Hopper two-pass body's pass-0 partials
# (csrc/pool_ext_bwd_twopass.cu kRangeTiles x kTile)
_TWOPASS_RANGE = 512


def _twopass_fold_ref(g_h0, wo, sacc, num_heads: int, v1: bool) -> torch.Tensor:
    """Plain version of ``twopass_fold_kernel``: DM_h = bf16(g_h0 Wo_h)
    (v1) or DMs_h = bf16(g_h0 Wo_h / sacc) (v2, v2j) -> [B, J, D] in
    g_h0's dtype."""
    b, i, c = g_h0.shape
    dm = _twopass_dmerged(g_h0, wo, num_heads)
    if not v1:
        dm = dm * (1.0 / sacc).reshape(b, num_heads, i, 1)
    return dm.to(g_h0.dtype).reshape(b, num_heads * i, c // num_heads)


def _twopass_ranges_ref(s, v, dm, macc, num_heads: int, v1: bool, n_valid=None) -> tuple:
    """Plain version of ``twopass_range_kernel`` -> (the ranges' partials
    pacc [R, B, J, D] fp32, and for v1 t [R, B, J], else None): per range
    of 512 points pacc_h = bf16(e_h)^T v_h, t = sum e dp with dp = v_h
    DM_h^T (fp32 e)."""
    b, n, j = s.shape
    h = num_heads
    i, d = j // h, dm.shape[2]
    _, e = _twopass_e(s, macc, n_valid)
    eb = e.to(v.dtype).float().reshape(b, n, h, i)
    vh = v.float().reshape(b, n, h, d)
    dp = (torch.einsum("bnhd,bhid->bnhi", vh, dm.float().reshape(b, h, i, d)).reshape(b, n, j)
          if v1 else None)
    pp, tp = [], []
    for r0 in range(0, n, _TWOPASS_RANGE):
        rows = slice(r0, r0 + _TWOPASS_RANGE)
        pp.append(torch.einsum("bnhi,bnhd->bhid", eb[:, rows], vh[:, rows]).reshape(b, j, d))
        if v1:
            tp.append((e[:, rows] * dp[:, rows]).sum(1))
    return torch.stack(pp), (torch.stack(tp) if v1 else None)


def _twopass_merge_ref(ppart, tpart, dm, sacc, dtype) -> tuple:
    """Plain version of ``twopass_merge_kernel`` -> (tacc [B, J] fp32,
    merged [B, J, D] in ``dtype``): pacc = the ranges' partials summed in
    range order, merged = bf16(pacc / sacc), tacc = (v1, ``tpart`` given:
    the ranges' t summed; v2: rowsum(DMs pacc)) / sacc."""
    pacc, inv = ppart[0], 1.0 / sacc
    for part in ppart[1:]:
        pacc = pacc + part
    if tpart is not None:
        t = tpart[0]
        for part in tpart[1:]:
            t = t + part
    else:
        t = (dm.float() * pacc).sum(-1)
    return t * inv, (pacc * inv[..., None]).to(dtype)


def _twopass_tiles_ref(s, v, dm, macc, sacc, tacc, num_heads: int, v1: bool,
                       n_valid=None) -> tuple:
    """Plain version of ``twopass_tile_kernel`` -> (ds [B, N, J], dv
    [B, N, C] in v's dtype): dp = v_h DM_h^T, w = p = e / sacc (v1) or e
    (v2), ds = bf16(w (dp - tacc)) where s - macc > -80, dv = bf16(bf16(w)
    DM_h)."""
    dt = v.dtype
    b, n, j = s.shape
    h = num_heads
    i, d = j // h, dm.shape[2]
    z, e = _twopass_e(s, macc, n_valid)
    dmh = dm.float().reshape(b, h, i, d)
    dp = torch.einsum("bnhd,bhid->bnhi", v.float().reshape(b, n, h, d), dmh).reshape(b, n, j)
    w = e * (1.0 / sacc)[:, None] if v1 else e
    ds = torch.where(z > -80.0, w * (dp - tacc[:, None]), 0.0).to(dt)
    dv = torch.einsum("bnhi,bhid->bnhd", w.to(dt).float().reshape(b, n, h, i), dmh)
    return ds, dv.to(dt).reshape(b, n, h * d)


def _twopass_pieces(x, se, be, qft, kvw, wo, g_h0, macc, sacc, num_heads: int, v1: bool,
                    n_valid=None) -> tuple:
    """The Hopper two-pass body's plain pieces composed -> (dx, dse, dbe,
    dqf, dwv, dwo), ``_pool_bwd_v1_ref`` (``v1``) or ``_pool_bwd_v2_ref``."""
    dt = x.dtype
    b, i, c = g_h0.shape
    dm = _twopass_fold_ref(g_h0, wo, sacc, num_heads, v1)
    s, v = _twopass_sv_ref(x, se, be, qft, kvw)
    tacc, merged = _twopass_merge_ref(
        *_twopass_ranges_ref(s, v, dm, macc, num_heads, v1, n_valid), dm, sacc, dt)
    ds, dv = _twopass_tiles_ref(s, v, dm, macc, sacc, tacc, num_heads, v1, n_valid)
    merged = merged.float().reshape(b, num_heads, i, c // num_heads)
    return _twopass_outputs(x, se, _prenormed(x, se, be), ds.float(), dv.float(), qft, kvw, g_h0,
                            merged)


def _pool_twopass_hopper_takes(b: int, n: int, c: int, num_heads: int, i: int) -> bool:
    """The shapes of the Hopper two-pass body (csrc/pool_ext_bwd_twopass.cu
    ``body_takes``: change both together): 64 inducers a head of D 48 or
    128, C a multiple of 384 up to 768 (the flagship's C 384 with 8 heads,
    the 8k width's C 768 with 16; three heads at C 384, J 192), any N (a
    ragged N zero-padded to 128s). The demo's C 128 (D 32) takes the WMMA
    body."""
    return (i == 64 and num_heads > 0 and c % num_heads == 0 and c // num_heads in (48, 128)
            and c % 384 == 0 and c <= 768 and n >= 1)


def _pool_ext_bwd_twopass(x, se, be, qft, kvw, wo, g, macc, sacc, num_heads: int,
                          body: str, impl: str | None = None) -> tuple:
    """The v1 body or the v2 or v2j body -> (dx, dse, dbe, dqf, dwv, dwo):
    the Hopper body (csrc/pool_ext_bwd_twopass.cu) where
    ``_pool_twopass_hopper_takes``, else the WMMA body
    (csrc/pool_ext_bwd_v1.cu, csrc/pool_ext_bwd_v2.cu); ``impl`` ("hopper"
    or "wmma") forces one, for timing the two in turns. v2j takes 1/sacc
    [B, J], formed here, where v1 and v2 take sacc and invert it in the
    kernel. The weight gradients come from csrc/wgrad.cuh (fixed-order
    split-K), dse and dbe from fixed-order partials: every output is the
    same bits from call to call. A ragged N goes zero-padded to 128s, its
    padding masked in both passes."""
    b, n, c = x.shape
    i = qft.shape[0] // num_heads
    if impl is None:
        impl = "hopper" if _pool_twopass_hopper_takes(b, n, c, num_heads, i) else "wmma"
    if impl == "hopper":
        return _twopass_hopper(x, se, be, qft, kvw, wo, g, macc, sacc, num_heads, body)[0]
    x, n_valid, out, wargs = _twopass_setup(x, qft, num_heads)
    b, n, c = x.shape
    j, d = qft.shape[0], c // num_heads
    dev = x.device
    lib = "pool_ext_bwd_v1" if body == "v1" else "pool_ext_bwd_v2"
    launch(lib, f"pool_ext_bwd_{body}_launch", x, se, be, qft, kvw, wo, g, macc,
           torch.reciprocal(sacc) if body == "v2j" else sacc,
           torch.empty_like(x), torch.empty((b, j, d), dtype=_BF16, device=dev),
           torch.empty((b, j), dtype=_F32, device=dev),
           torch.empty((b, i, c), dtype=_BF16, device=dev),
           torch.empty((b, n, j), dtype=_BF16, device=dev), torch.empty_like(x),
           torch.empty((b, n // 32, 2, c), dtype=_F32, device=dev), *wargs, n_valid)
    counter = f"launches_{body}_wmma"
    setattr(folded_pool_ext_bwd, counter, getattr(folded_pool_ext_bwd, counter) + 1)
    return _twopass_outputs_of(out, n_valid)


def _twopass_setup(x, qft, num_heads: int) -> tuple:
    """What both two-pass bodies share -> (x zero-padded to 128 points,
    n_valid, the outputs' buffers, the launch's trailing arguments: the
    weight-gradient partials, the outputs, the shape and the splits of the
    three weight-gradient products)."""
    b, n_valid, c = x.shape
    n = _n_pad(n_valid)
    x = _pad_points(x, n)
    j = qft.shape[0]
    dev = x.device
    # the three weight gradients' products: dqf = y^T ds over the B N rows,
    # dWv = dv^T y over them, dWo = g^T merged over the B I rows
    products = ((b * n, j), (b * n, c), (b * (j // num_heads), c))
    splits = [_wgrad_splits(1, rows // 64, c, p, dev) for rows, p in products]
    part = max([s * c * p for s, (_, p) in zip(splits, products) if s > 1], default=0)
    out = dict(dx=torch.empty_like(x), dsum=torch.empty((b, 2, c), dtype=_F32, device=dev),
               dqf=torch.empty((c, j), dtype=_F32, device=dev),
               dwv=torch.empty((c, c), dtype=_F32, device=dev),
               dwo=torch.empty((c, c), dtype=_F32, device=dev))
    wpart = torch.empty(part, dtype=_F32, device=dev) if part else None
    wargs = (wpart, out["dx"], out["dsum"], out["dqf"], out["dwv"], out["dwo"], b, n, c,
             num_heads, j // num_heads, *splits)
    return x, n_valid, out, wargs


def _twopass_outputs_of(out: dict, n_valid: int) -> tuple:
    return (_unpad(out["dx"], n_valid), out["dsum"][:, 0], out["dsum"][:, 1], out["dqf"],
            out["dwv"], out["dwo"])


def _twopass_hopper(x, se, be, qft, kvw, wo, g, macc, sacc, num_heads: int,
                    body: str) -> tuple:
    """The Hopper two-pass body -> (the six outputs, its intermediates: y,
    dm, s, v, ppart, tpart, tacc, merged, ds, dv, which
    ``probes.pool_bwd_twopass`` holds against the plain pieces)."""
    x, n_valid, out, wargs = _twopass_setup(x, qft, num_heads)
    b, n, c = x.shape
    j = qft.shape[0]
    i, d = j // num_heads, c // num_heads
    dev = x.device
    ranges = -(-n // _TWOPASS_RANGE)
    buf = dict(y=torch.empty_like(x), dm=torch.empty((b, j, d), dtype=_BF16, device=dev),
               s=torch.empty((b, n, j), dtype=_F32, device=dev), v=torch.empty_like(x),
               ppart=torch.empty((ranges, b, j, d), dtype=_F32, device=dev),
               tpart=torch.empty((ranges, b, j), dtype=_F32, device=dev),
               tacc=torch.empty((b, j), dtype=_F32, device=dev),
               merged=torch.empty((b, i, c), dtype=_BF16, device=dev),
               ds=torch.empty((b, n, j), dtype=_BF16, device=dev), dv=torch.empty_like(x))
    launch("pool_ext_bwd_twopass", f"pool_ext_bwd_{body}_hopper_launch", x, se, be, qft, kvw,
           wo, g, macc, torch.reciprocal(sacc) if body == "v2j" else sacc, *buf.values(),
           torch.empty((b * n // 128, 2, c), dtype=_F32, device=dev), *wargs, n_valid)
    counter = f"launches_{body}"
    setattr(folded_pool_ext_bwd, counter, getattr(folded_pool_ext_bwd, counter) + 1)
    return _twopass_outputs_of(out, n_valid), buf


folded_pool_ext_bwd.launches = 0
folded_pool_ext_bwd.launches_wmma = 0
folded_pool_ext_bwd.launches_f32 = 0
for _body in TWOPASS_BODIES:
    setattr(folded_pool_ext_bwd, f"launches_{_body}", 0)
    setattr(folded_pool_ext_bwd, f"launches_{_body}_wmma", 0)


# --------------------------------------------------------- resident pool --


def _pool_ref(x, scale, bias, ind2, kvw, wo, num_groups: int, num_heads: int,
              prenorm: bool = True, n_valid=None) -> tuple:
    """Plain version (the JAX package's ``_pool_ref``) -> (h0 [B, I, C],
    mean_c, inv_c [B, C] fp32): with ``prenorm`` the set-level GroupNorm
    statistics of x and y = (x - mean_c) * (inv_c * scale) + bias; without,
    y = x, mean 0 and inv 1. With ``n_valid``, the points from it on are a
    ragged tail's zero padding, as the kernels see it: the statistics
    count ``n_valid`` points and the softmax masks the rest."""
    b, n, c = x.shape
    if prenorm:
        xf = x.float()
        mean_c, inv_c = stats_from_sums(xf.sum(1), (xf * xf).sum(1),
                                        n if n_valid is None else n_valid, num_groups)
        y = ((x.float() - mean_c[:, None]) * (inv_c * scale)[:, None] + bias[:, None]).to(x.dtype)
    else:
        mean_c = torch.zeros((b, c), dtype=_F32, device=x.device)
        inv_c = torch.ones_like(mean_c)
        y = x
    return _pool_ref_from_y(y, ind2, kvw, wo, num_heads, n_valid), mean_c, inv_c


def _pool_layer_chunks_ref(y, qft, n_valid=None) -> tuple:
    """Plain version of the Hopper body's pass A: per chunk of
    ``_POOL_CHUNK`` points of y [B, N, C] each column's max m_c of the
    logits s = y qf and sum l_c of exp(max(s - m_c, -80)) [B, N/64, J]
    fp32. Points from ``n_valid`` on take no part: a chunk of padding alone
    gives m_c = -inf and l_c = 0."""
    b, n, _ = y.shape
    k = n // _POOL_CHUNK
    s = torch.einsum("bnc,jc->bnj", y.float(), qft.float())
    ok = _valid_rows(n, n_valid, y.device)
    if ok is not None:
        s = s.masked_fill(~ok, -torch.inf)
    s = s.reshape(b, k, _POOL_CHUNK, -1)
    m = s.amax(2)
    e = torch.exp(torch.clamp(s - m[:, :, None], min=-80.0))
    if ok is not None:
        e = e.masked_fill(~ok.reshape(1, k, _POOL_CHUNK, 1), 0.0)
    return m, e.sum(2)


def _pool_layer_merge_ref(m, l) -> tuple:
    """Plain version of ``pool_layer_merge_kernel``: the softmax's column
    max M = max m_c and sum L = sum exp(max(m_c - M, -80)) l_c [B, J]."""
    mm = m.amax(1)
    return mm, (torch.exp(torch.clamp(m - mm[:, None], min=-80.0)) * l).sum(1)


def _pool_layer_partials_ref(y, qft, kvw, macc, sacc, num_heads: int, n_valid=None):
    """Plain version of the Hopper body's pass B: per chunk of
    ``_POOL_CHUNK`` points, P_c = p^T v [B, N/64, J, D] fp32 with p =
    bf16(exp(max(s - M, -80)) / L) (the TPU kernel's rounding point; 0 on
    the points from ``n_valid`` on) and v = bf16(y Wv_h^T)."""
    dt = y.dtype
    b, n, c = y.shape
    j = qft.shape[0]
    i, d, k = j // num_heads, c // num_heads, n // _POOL_CHUNK
    s = torch.einsum("bnc,jc->bnj", y.float(), qft.float())
    p = torch.exp(torch.clamp(s - macc[:, None], min=-80.0)) / sacc[:, None]
    ok = _valid_rows(n, n_valid, y.device)
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    v = torch.einsum("bnc,dc->bnd", y.float(), kvw[c:].float()).to(dt)
    pp = torch.einsum(
        "bkrhi,bkrhd->bkhid", p.to(dt).float().reshape(b, k, _POOL_CHUNK, num_heads, i),
        v.float().reshape(b, k, _POOL_CHUNK, num_heads, d))
    return pp.reshape(b, k, j, d)


def _pool_layer_sum_ref(part_p, num_heads: int) -> torch.Tensor:
    """Plain version of ``pool_layer_sum_kernel``: the chunks' P_c summed,
    pacc [B, I, C] fp32 (head h's values in columns hD..(h+1)D)."""
    pp = part_p.sum(1)
    b, j, d = pp.shape
    i = j // num_heads
    return pp.reshape(b, num_heads, i, d).permute(0, 2, 1, 3).reshape(b, i, num_heads * d)


def _pool_layer_body(b: int, n: int, c: int, num_heads: int, i: int, dtype=_BF16) -> str:
    """Which body of ``folded_pool_layer`` takes these shapes on the card:
    "f32" (``f32.pool_layer_fwd``, any shape) for fp32 operands; for bf16
    ones "hopper" (csrc/pool.cu, TMA and wgmma: D == 48, H % 8 == 0, C <= 768;
    the flagship's and the 8k width) where it can, else "wmma"
    (csrc/pool_wmma.cu: D % 16 == 0, C <= 2048 and a block of 16 of a head's
    columns within the SM's shared memory: ``_pool_wmma_block``, any I at C
    <= 768); both need C % 64 == 0 and B*I % 64 == 0 and take any N
    (padded) and any I (a ragged I zero-padded to 16s, the I of these
    conditions the padded one, as in ``_pool_ext_body``). Raises ValueError
    with both bodies' conditions otherwise."""
    if dtype == _F32:
        return "f32"
    d = c // num_heads
    i = _i_pad(i)
    common = c % num_heads == 0 and c % 64 == 0 and (b * i) % 64 == 0 and n >= 1
    if common and d == 48 and num_heads % 8 == 0 and c <= 768:
        return "hopper"
    if common and d % 16 == 0 and c <= 2048 and _pool_wmma_block(c, i, d):
        return "wmma"
    raise ValueError(
        f"folded_pool_layer: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs D == 48, H % 8 == 0 and C <= 768; the WMMA body "
        f"D % 16 == 0, C <= 2048 and a block of 16 columns within {_MAX_SMEM} bytes of "
        f"shared memory; both C % 64 == 0 and B*I % 64 == 0 (I padded to 16s)")


def _pool_layer_launch(x, scale, bias, ind2, kvw, wo, gind, num_heads: int, prenorm: bool,
                       stats: bool, mid: dict | None = None, body: str | None = None) -> tuple:
    """The forward kernels of ``body`` ("hopper" or "wmma"; where None, the
    one ``_pool_layer_body`` picks, which must take the shapes) -> (h0,
    mean_c, inv_c, (m, l, P, y)): the softmax's column max and sum [B, J],
    the fp32 pooled values [B, I, C] and the pre-normed stream y (x itself
    without the pre-norm; at the padded point count) for the backward where
    ``stats``, else Nones. ``mid``, where given, receives the Hopper body's
    intermediates (qft, the passes' partials, pooled), which
    ``probes.pool_layer`` holds against their plain pieces."""
    name = "folded_pool_layer"
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    groups = gind.shape[1]
    dt = f32.route(name, dict(x=x, ind2=ind2, kvw=kvw, wo=wo))
    _check(name, dict(x=x, scale=scale, bias=bias, ind2=ind2, kvw=kvw, wo=wo),
           dict(x=_BF16, scale=_F32, bias=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16), dt)
    _require(tuple(gind.shape) == (c, groups) and c % groups == 0, name,
             f"gind of shape (C, G) with G dividing C = {c}, got {tuple(gind.shape)}")
    picked = _pool_layer_body(b, n, c, num_heads, i, dt)
    body = body or picked
    if body == "f32":
        h0, mean_c, inv_c, saved = f32.pool_layer_fwd(x, scale, bias, ind2, kvw, wo, groups,
                                                      num_heads, prenorm)
        folded_pool_layer.launches_f32 += 1
        return h0, mean_c, inv_c, saved if stats else (None, None, None, None)
    dev = x.device
    n_valid, n = n, _n_pad(n)
    x = _pad_points(x, n)
    i_valid, i = i, _i_pad(i)
    ind2 = _pad_heads(ind2, num_heads, i)
    j = num_heads * i
    if prenorm:
        part = torch.empty((b, n // 64, 2, c), dtype=_F32, device=dev)
        mean_c = torch.empty((b, c), dtype=_F32, device=dev)
        inv_c = torch.empty_like(mean_c)
        y = torch.empty_like(x)
    else:
        part = y = None
        mean_c = torch.zeros((b, c), dtype=_F32, device=dev)
        inv_c = torch.ones_like(mean_c)
    pooled = torch.empty((b, i, c), dtype=_BF16, device=dev)
    h0 = torch.empty_like(pooled)
    pacc = torch.empty((b, i, c), dtype=_F32, device=dev) if stats else None
    if body == "hopper":
        qft = fold_qf(ind2, kvw, num_heads).t().contiguous()
        k = n // _POOL_CHUNK
        part_m = torch.empty((b, k, j), dtype=_F32, device=dev)
        part_l = torch.empty_like(part_m)
        part_p = torch.empty((b, k, j, d), dtype=_F32, device=dev)
        m = torch.empty((b, j), dtype=_F32, device=dev)
        l = torch.empty_like(m)
        launch("pool", "pool_layer_launch", x, scale, bias, qft, kvw, wo, part,
               mean_c if prenorm else None, inv_c, y, part_m, part_l, part_p, m, l, pooled, h0,
               pacc, b, n, c, num_heads, i, groups, n_valid)
        folded_pool_layer.launches += 1
        if mid is not None:
            mid.update(qft=qft, part_m=part_m, part_l=part_l, part_p=part_p, m=m, l=l,
                       pooled=pooled, y=x if y is None else y)
    else:
        qf = fold_qf(ind2, kvw, num_heads).contiguous()
        m = torch.empty((b, j), dtype=_F32, device=dev) if stats else None
        l = torch.empty_like(m) if stats else None
        launch("pool_wmma", "pool_layer_wmma_launch", x, scale, bias, qf, kvw, wo, part,
               mean_c if prenorm else None, inv_c, y, pooled, h0, m, l, pacc, b, n, c,
               num_heads, i, groups, n_valid)
        folded_pool_layer.launches_wmma += 1
    if i != i_valid:  # the backward's m, l and pacc stay padded
        h0 = h0[:, :i_valid].contiguous()
    if not stats:
        return h0, mean_c, inv_c, (None, None, None, None)
    return h0, mean_c, inv_c, (m, l, pacc, x if y is None else y)


class _PoolLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, ind2, kvw, wo, gind, num_heads, prenorm, need_grad):
        stats = (None, None, None, None)
        if x.device.type == "cpu":
            h0, mean_c, inv_c = _pool_ref(x, scale, bias, ind2, kvw, wo, gind.shape[1],
                                          num_heads, prenorm)
        else:
            h0, mean_c, inv_c, stats = _pool_layer_launch(x, scale, bias, ind2, kvw, wo, gind,
                                                          num_heads, prenorm, need_grad)
        if need_grad:
            ctx.save_for_backward(x, scale, bias, ind2, kvw, wo, gind, mean_c, inv_c, *stats)
        ctx.cfg = (num_heads, prenorm)
        return h0, mean_c, inv_c

    @staticmethod
    def backward(ctx, g_h0, g_mean, g_inv):
        grads = folded_pool_layer_bwd(*ctx.saved_tensors, g_h0, g_mean, g_inv, *ctx.cfg)
        # gind, the constant group indicator, takes no gradient
        return (*grads, None, None, None, None)


def folded_pool_layer(x, scale, bias, ind2, kvw, wo, gind, num_heads: int,
                      prenorm: bool = True) -> tuple:
    """x [B, N, C]; scale/bias [B, C] fp32 (the AdaGN affine); ind2 [J, D]
    inducers; kvw [2C, C]; wo [C, C]; gind [C, G] (the group indicator of
    the pre-norm's G groups, as the JAX signature; the kernels take a
    group as a run of C/G channels) -> (h0 [B, I, C], mean_c, inv_c [B, C]
    fp32): the resident pool, the GroupNorm statistics of x computed on the
    way when ``prenorm`` (else y = x, mean 0, inv 1). Differentiable in
    every tensor argument but gind, through all three outputs."""
    need = needs_grad(x, scale, bias, ind2, kvw, wo)
    return _PoolLayer.apply(x, scale, bias, ind2, kvw, wo, gind, num_heads, prenorm, need)


folded_pool_layer.launches = 0
folded_pool_layer.launches_wmma = 0
folded_pool_layer.launches_f32 = 0


def _pool_layer_bwd_ref(x, scale, bias, ind2, kvw, wo, gind, g_h0, g_mean, g_inv,
                        num_heads: int, prenorm: bool = True) -> tuple:
    """Plain version of the resident pool's backward: autograd through
    ``_pool_ref`` -> (dx, dscale, dbias, dind2, dkvw, dwo)."""
    groups = gind.shape[1]
    args = (x, scale, bias, ind2, kvw, wo)
    if prenorm:
        return vjp(lambda *a: _pool_ref(*a, groups, num_heads), args, (g_h0, g_mean, g_inv))
    # without the pre-norm mean and inv are constants
    return vjp(lambda *a: _pool_ref(*a, groups, num_heads, False)[0], args, (g_h0,))


def _pool_layer_bwd_main_smem(tn: int, c: int, i: int, d: int) -> int:
    """Bytes of the WMMA body's main block at a ``tn``-point tile:
    csrc/pool_bwd_wmma.cu ``main_smem`` (change both together)."""
    region0 = -(-max(tn * (c + _PAD) * 2, tn * (c + _PADF) * 4) // 128) * 128
    return (region0 + 2 * tn * (i + _PADF) * 4 + tn * (d + _PADF) * 4 + 2 * tn * (i + _PAD) * 2
            + 2 * tn * (d + _PAD) * 2)


def _pool_layer_bwd_tile(c: int, i: int, d: int) -> int:
    """The WMMA body's point tile (csrc/pool_bwd_wmma.cu ``main_tile``): 64
    up to C 384, else 32, halved down to 16 while the block does not fit;
    0 where none does."""
    tn = 64 if c <= 384 else 32
    while tn >= 16 and _pool_layer_bwd_main_smem(tn, c, i, d) > _MAX_SMEM:
        tn //= 2
    return tn if tn >= 16 else 0


def _pool_layer_bwd_smem(c: int, i: int, d: int) -> int:
    """Bytes of the larger block of the WMMA body's fold and main kernel
    at the main kernel's tile (``_pool_layer_bwd_tile``; its 16-point block
    where none fits): csrc/pool_bwd_wmma.cu ``pool_layer_bwd_wmma_launch``
    (change both together)."""
    fold = 64 * (64 + _PADF) * 4 + 2 * i * (d + _PAD) * 2
    tn = _pool_layer_bwd_tile(c, i, d) or 16
    return max(fold, _pool_layer_bwd_main_smem(tn, c, i, d))


def _pool_layer_bwd_pass_smem(c: int) -> int:
    """Bytes of the Hopper body's pass block (csrc/pool_bwd.cu ``PassSmem``:
    change both together): up to C 384 the y tile of 128 points and one
    ring of qf^T and Wv_h panels (three stages) that both warpgroups read,
    at C 768 the y tile of 64 points and a ring of two stages for each
    warpgroup; then each warpgroup's dpool_h block and its transpose and
    its block's column statistics [3, 64] fp32, the barriers and 1024
    bytes of alignment slack."""
    pair = c <= 384
    rows, rings, ring = (128, 1, 3) if pair else (64, 2, 2)
    op, stage, dpt, stat = 64 * 128, 64 * 128 + 48 * 128, 48 * 128, 3 * 64 * 4
    return ((c // 64) * rows * 128 + rings * ring * stage + 2 * (op + dpt + stat)
            + (1 + 2 * 2 * 3) * 8 + 1024)


def _pool_layer_bwd_body(b: int, n: int, c: int, num_heads: int, i: int,
                         dtype=_BF16) -> str:
    """Which body of ``folded_pool_layer_bwd`` takes these shapes on the
    card: "f32" (``f32.pool_layer_bwd``, any shape) for fp32 operands; for
    bf16 ones "hopper" (csrc/pool_bwd.cu, TMA, wgmma and Hopper GEMMs: D == 48,
    H % 8 == 0, C in (384, 768) and B*I % 64 == 0, any I in blocks of 64
    columns; the shapes of the resident pool's Hopper forward) where it can,
    else "wmma" (csrc/pool_bwd_wmma.cu: C % 64 == 0, C <= 768, D % 16 == 0,
    J % 64 == 0 and its blocks within the SM's shared memory,
    ``_pool_layer_bwd_smem``: three heads' D 128). Both take any N (padded)
    and any I (a ragged I zero-padded to 16s, the I of these conditions
    the padded one). The chosen name is the counter's suffix
    (``folded_pool_layer_bwd``, ``folded_pool_layer_bwd_wmma``). Raises
    ValueError with both bodies' conditions otherwise."""
    if dtype == _F32:
        return "f32"
    d = c // num_heads if num_heads else 0
    i = _i_pad(i)
    j = num_heads * i
    common = num_heads > 0 and c % num_heads == 0 and n >= 1 and b >= 1
    if common and d == 48 and num_heads % 8 == 0 and c in (384, 768) and (b * i) % 64 == 0:
        return "hopper"
    if (common and c % 64 == 0 and c <= 768 and d % 16 == 0 and j % 64 == 0
            and _pool_layer_bwd_smem(c, i, d) <= _MAX_SMEM):
        return "wmma"
    raise ValueError(
        f"folded_pool_layer_bwd: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs D == 48, H % 8 == 0, C in (384, 768) and B*I % 64 == "
        f"0; the WMMA body C % 64 == 0, C <= 768, D % 16 == 0, J % 64 == 0 and its blocks "
        f"within {_MAX_SMEM} bytes of shared memory (at D 48 up to 960 inducers at C 384, 912 "
        f"at C 768)")


def _pool_layer_bwd_fold_ref(g, wo, pacc, num_heads: int) -> tuple:
    """Plain version of the Hopper body's first two launches -> (dpool =
    bf16(g Wo) [B, I, C] (the dpool GEMM), tacc [B, J] fp32 and merged =
    bf16(P) [B, I, C] (``layer_bwd_t_kernel``)), g the cotangent of h0 in
    the stream's dtype, pacc the forward's fp32 P [B, I, C]: t[h I + i] =
    sum_d dpool[i, h D + d] P[i, h D + d], which is sum_n dp p."""
    dpool = torch.einsum("bio,oc->bic", g.float(), wo.float()).to(g.dtype)
    return dpool, _pool_layer_bwd_t_ref(dpool, pacc, num_heads), pacc.to(g.dtype)


def _pool_layer_bwd_t_ref(dpool, pacc, num_heads: int) -> torch.Tensor:
    """Plain version of ``layer_bwd_t_kernel``'s t [B, J] fp32: t[h I + i]
    = sum_d dpool[i, h D + d] P[i, h D + d], dpool [B, I, C] bf16."""
    b, i, c = dpool.shape
    t = (dpool.float() * pacc).reshape(b, i, num_heads, c // num_heads).sum(-1)
    return t.transpose(1, 2).reshape(b, num_heads * i)


def _pool_layer_bwd_tiles_ref(y, qft, kvw, macc, sacc, dpool, tacc, num_heads: int,
                              n_valid=None) -> tuple:
    """Plain version of ``layer_bwd_pass_kernel`` -> (ds [B, N, J], dv
    [B, N, C] in y's dtype): z = y qf - M, p = bf16(exp(max(z, -80)) / L)
    (0 on the points from ``n_valid`` on), v = bf16(y Wv^T), dp = v_h
    dpool_h^T, ds = bf16(p (dp - t)) where z > -80, dv = bf16(p dpool_h)."""
    dt = y.dtype
    b, n, c = y.shape
    j = qft.shape[0]
    h = num_heads
    i, d = j // h, c // h
    z = torch.einsum("bnc,jc->bnj", y.float(), qft.float()) - macc[:, None]
    p = torch.exp(torch.clamp(z, min=-80.0)) / sacc[:, None]
    ok = _valid_rows(n, n_valid, y.device)
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    p = p.to(dt).float()
    v = torch.einsum("bnc,dc->bnd", y.float(), kvw[c:].float()).to(dt).float()
    dph = dpool.float().reshape(b, i, h, d)
    dp = torch.einsum("bnhd,bihd->bnhi", v.reshape(b, n, h, d), dph).reshape(b, n, j)
    ds = torch.where(z > -80.0, p * (dp - tacc[:, None]), 0.0).to(dt)
    dv = torch.einsum("bnhi,bihd->bnhd", p.reshape(b, n, h, i), dph).reshape(b, n, c)
    return ds, dv.to(dt)


def _pool_layer_bwd_dy_ref(ds, dv, qft, kvw) -> torch.Tensor:
    """Plain version of the dy product: dy = ds qf^T + dv Wv [B, N, C]
    fp32."""
    c = dv.shape[2]
    return (torch.einsum("bnj,jc->bnc", ds.float(), qft.float())
            + torch.einsum("bnd,dc->bnc", dv.float(), kvw[c:].float()))


def _pool_layer_bwd_dx_ref(x, dy, mean_c, inv_c, scale, g_mean, g_inv, num_groups: int,
                           prenorm: bool = True, n_valid=None) -> tuple:
    """Plain version of the dy product's epilogue, its column sums and
    ``layer_bwd_dx_kernel`` -> (dx in x's dtype, dscale, dbias [B, C]
    fp32): without the pre-norm dx = bf16(dy) and no gradient of scale and
    bias; with it the GroupNorm's backward from sum_n dy (x - mean_c) and
    sum_n dy (the header of csrc/pool_bwd.cu), a group counting ``n_valid``
    points (the padding's dy is 0)."""
    b, n, c = x.shape
    if not prenorm:
        zero = torch.zeros((b, c), dtype=_F32, device=x.device)
        return dy.to(x.dtype), zero, zero.clone()
    pg = c // num_groups
    count = (n if n_valid is None else n_valid) * pg
    sxc = (dy * (x.float() - mean_c[:, None])).sum(1)
    s1 = dy.sum(1)
    group = lambda t: t.reshape(b, num_groups, pg).sum(-1).repeat_interleave(pg, dim=1)
    dvar = -0.5 * inv_c**3 * group(sxc * scale + g_inv)
    dmean = group(-s1 * (inv_c * scale) + g_mean) - 2.0 * mean_c * dvar
    dx = (dy * (inv_c * scale)[:, None] + x.float() * (2.0 * (dvar / count))[:, None]
          + (dmean / count)[:, None])
    return dx.to(x.dtype), sxc * inv_c, s1


def _pool_layer_bwd_wgrad_ref(y, ds, dv, g, merged) -> tuple:
    """Plain version of the three ``wgrad_kernel`` products -> (dqf = the
    batch's y^T ds [C, J], dwv = dv^T y [C, C] in Wv's layout, dwo = g^T
    merged [C, C]), fp32."""
    return (torch.einsum("bnc,bnj->cj", y.float(), ds.float()),
            torch.einsum("bnd,bnc->dc", dv.float(), y.float()),
            torch.einsum("bio,bic->oc", g.float(), merged.float()))


def _pool_layer_bwd_pieces(x, scale, bias, ind2, kvw, wo, gind, mean_c, inv_c, m, l, pacc, y,
                           g_h0, g_mean, g_inv, num_heads: int, prenorm: bool = True,
                           n_valid=None) -> tuple:
    """The Hopper body's plain pieces composed on the forward's saved
    tensors (``folded_pool_layer_bwd``'s arguments) -> (dx, dscale, dbias,
    dind2, dkvw, dwo): the TPU kernel's algebra, which departs from
    ``_pool_layer_bwd_ref`` (autograd of the plain version) only by its
    bf16 roundings."""
    g = g_h0.to(x.dtype)
    qft = fold_qf(ind2, kvw, num_heads).t()
    dpool, tacc, merged = _pool_layer_bwd_fold_ref(g, wo, pacc, num_heads)
    ds, dv = _pool_layer_bwd_tiles_ref(y, qft, kvw, m, l, dpool, tacc, num_heads, n_valid)
    dx, dscale, dbias = _pool_layer_bwd_dx_ref(x, _pool_layer_bwd_dy_ref(ds, dv, qft, kvw),
                                               mean_c, inv_c, scale, g_mean, g_inv,
                                               gind.shape[1], prenorm, n_valid)
    dqf, dwv, dwo = _pool_layer_bwd_wgrad_ref(y, ds, dv, g, merged)
    dind2, dkvw = _chain_dqf(dqf, dwv, ind2, kvw, num_heads)
    return dx, dscale, dbias, dind2, dkvw, dwo.to(wo.dtype)


def folded_pool_layer_bwd(x, scale, bias, ind2, kvw, wo, gind, mean_c, inv_c, m, l, pacc, y,
                          g_h0, g_mean, g_inv, num_heads: int, prenorm: bool = True) -> tuple:
    """Gradients of ``folded_pool_layer`` against the cotangents of its
    three outputs (``g_h0`` [B, I, C], ``g_mean``/``g_inv`` [B, C]), from
    the forward's inputs, its statistics ``mean_c``/``inv_c``, its
    softmax's ``m``/``l`` [B, J], its fp32 pooled values ``pacc``
    [B, I, C] and its pre-normed stream ``y`` [B, N, C] -> (dx, dscale,
    dbias, dind2, dkvw, dwo), through the body that ``_pool_layer_bwd_body``
    picks. CPU tensors take the plain version (which needs none of the
    forward's results). A ragged I goes zero-padded to 16s as in the
    forward, whose m, l and pacc are padded already."""
    if x.device.type == "cpu":
        return _pool_layer_bwd_ref(x, scale, bias, ind2, kvw, wo, gind, g_h0, g_mean, g_inv,
                                   num_heads, prenorm)
    return _pool_layer_bwd_launch(x, scale, bias, ind2, kvw, wo, gind, mean_c, inv_c, m, l, pacc,
                                  y, g_h0, g_mean, g_inv, num_heads, prenorm)


def _pool_layer_bwd_launch(x, scale, bias, ind2, kvw, wo, gind, mean_c, inv_c, m, l, pacc, y,
                           g_h0, g_mean, g_inv, num_heads: int, prenorm: bool = True,
                           body: str | None = None, mid: dict | None = None) -> tuple:
    """The kernels of ``body`` ("hopper" or "wmma"; where None, the one
    ``_pool_layer_bwd_body`` picks, which must take the shapes) -> the
    gradients as ``folded_pool_layer_bwd`` returns them. ``mid``, where
    given, receives the Hopper body's intermediates (qft, dpool, tacc,
    merged, ds, dv, and with the pre-norm dy and dsum, all at the padded
    point count), which ``probes.pool_layer_bwd`` holds against the plain
    pieces."""
    name = "folded_pool_layer_bwd"
    b, n, c = x.shape
    i_valid = ind2.shape[0] // num_heads
    dt = f32.route(name, dict(x=x, ind2=ind2, kvw=kvw, wo=wo, y=y))
    if (body or _pool_layer_bwd_body(b, n, c, num_heads, i_valid, dt)) == "f32":
        g = g_h0.to(_F32).contiguous()
        g_mean, g_inv = g_mean.float().contiguous(), g_inv.float().contiguous()
        _check(name, dict(x=x, scale=scale, bias=bias, ind2=ind2, kvw=kvw, wo=wo, g=g,
                          g_mean=g_mean, g_inv=g_inv, mean_c=mean_c, inv_c=inv_c, m=m, l=l,
                          pacc=pacc, y=y), {}, _F32)
        dx, dscale, dbias, dqf, dwv, dwo = f32.pool_layer_bwd(
            x, scale, ind2, kvw, wo, gind.shape[1], mean_c, inv_c, m, l, pacc, y, g, g_mean,
            g_inv, num_heads, prenorm)
        folded_pool_layer_bwd.launches_f32 += 1
        return (dx, dscale, dbias, *_chain_dqf(dqf, dwv, ind2, kvw, num_heads), dwo)
    i = _i_pad(i_valid)
    ind2_in, ind2 = ind2, _pad_heads(ind2, num_heads, i)
    j, d = ind2.shape
    groups = gind.shape[1]
    g = _pad_points(g_h0.to(x.dtype), i).contiguous()
    g_mean, g_inv = g_mean.float().contiguous(), g_inv.float().contiguous()
    check_cuda(
        name, dict(x=x, scale=scale, bias=bias, ind2=ind2, kvw=kvw, wo=wo, g=g, g_mean=g_mean,
                   g_inv=g_inv, mean_c=mean_c, inv_c=inv_c, m=m, l=l, pacc=pacc, y=y),
        dict(x=_BF16, scale=_F32, bias=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16, g=_BF16,
             g_mean=_F32, g_inv=_F32, mean_c=_F32, inv_c=_F32, m=_F32, l=_F32, pacc=_F32,
             y=_BF16),
    )
    _require(c % groups == 0, name, f"G dividing C (C={c}, G={groups})")
    picked = _pool_layer_bwd_body(b, n, c, num_heads, i_valid)
    body = body or picked
    dev = x.device
    n_valid, n = n, _n_pad(n)
    x, y = _pad_points(x, n), _pad_points(y, n)
    ds = torch.empty((b, n, j), dtype=_BF16, device=dev)
    dv = torch.empty_like(x)
    dx = torch.empty_like(x)
    if body == "hopper":
        qft = fold_qf(ind2, kvw, num_heads).t().contiguous()
        # g's B I rows zero-padded to the GEMMs' 128-row block
        mg = -(-b * i // 128) * 128
        gp = g.reshape(b * i, c)
        if mg != b * i:
            gp = torch.cat([gp, gp.new_zeros((mg - b * i, c))])
        products = ((b * n, j), (b * n, c), (b * i, c))  # dqf, dWv, dWo
        splits = [_wgrad_splits(1, rows // 64, c, p, dev) for rows, p in products]
        part = max([s_ * c * p for s_, (_, p) in zip(splits, products) if s_ > 1], default=0)
        buf = dict(dpool=torch.empty((mg, c), dtype=_BF16, device=dev),
                   tacc=torch.empty((b, j), dtype=_F32, device=dev),
                   merged=torch.empty((b, i, c), dtype=_BF16, device=dev), ds=ds, dv=dv)
        if prenorm:
            buf.update(dy=torch.empty((b, n, c), dtype=_F32, device=dev),
                       part=torch.empty((b * n // 128, 2, c), dtype=_F32, device=dev),
                       dsum=torch.empty((b, 2, c), dtype=_F32, device=dev))
            dscale, dbias = (torch.empty((b, c), dtype=_F32, device=dev) for _ in range(2))
        else:
            dscale, dbias = (torch.zeros((b, c), dtype=_F32, device=dev) for _ in range(2))
        dqf = torch.empty((c, j), dtype=_F32, device=dev)
        dwv = torch.empty((c, c), dtype=_F32, device=dev)
        dwo = torch.empty_like(dwv)
        launch("pool_bwd", "pool_layer_bwd_launch", x, mean_c if prenorm else None, inv_c, scale,
               y, qft, kvw, wo, gp, g_mean, g_inv, m, l, pacc, buf["dpool"], buf["tacc"],
               buf["merged"], ds, dv, buf.get("dy"), buf.get("part"), buf.get("dsum"), dx,
               dscale, dbias, torch.empty(part, dtype=_F32, device=dev) if part else None, dqf,
               dwv, dwo, b, n, c, num_heads, i, groups, mg, *splits, n_valid)
        folded_pool_layer_bwd.launches += 1
        if mid is not None:
            mid.update(qft=qft, **{k: v for k, v in buf.items() if k != "part"})
            mid["dpool"] = buf["dpool"][:b * i].reshape(b, i, c)
    else:
        _require(_pool_layer_bwd_smem(c, i, d) <= _MAX_SMEM, name,
                 f"the WMMA body's blocks within {_MAX_SMEM} bytes of shared memory (C={c}, "
                 f"D={d}, I={i}: {_pool_layer_bwd_smem(c, i, d)})")
        qf = fold_qf(ind2, kvw, num_heads).contiguous()
        dqf = torch.zeros((c, j), dtype=_F32, device=dev)
        dwvt = torch.zeros((c, c), dtype=_F32, device=dev)
        dwo = torch.zeros_like(dwvt)
        if prenorm:
            dy = torch.empty((b, n, c), dtype=_F32, device=dev)
            sdyxc = torch.zeros((b, c), dtype=_F32, device=dev)
            sdy = torch.zeros_like(sdyxc)
            dscale, dbias = torch.empty_like(sdyxc), torch.empty_like(sdyxc)
        else:
            dy = sdyxc = sdy = None
            dscale = torch.zeros((b, c), dtype=_F32, device=dev)
            dbias = torch.zeros_like(dscale)
        launch("pool_bwd_wmma", "pool_layer_bwd_wmma_launch", x, mean_c if prenorm else None,
               inv_c, scale, y, qf, kvw, wo, g, g_mean, g_inv, m, l, pacc,
               torch.empty((b, i, c), dtype=_BF16, device=dev),
               torch.empty((b, j), dtype=_F32, device=dev), ds, dv, dy, sdyxc, sdy, dx, dscale,
               dbias, dqf, dwvt, dwo, b, n, c, num_heads, i, groups, n_valid)
        folded_pool_layer_bwd.launches_wmma += 1
        dwv = dwvt.t()
    dind2, dkvw = _chain_dqf(dqf, dwv, ind2, kvw, num_heads)
    return (_unpad(dx, n_valid), dscale, dbias,
            _unpad_heads(dind2, num_heads, i_valid).to(ind2_in.dtype), dkvw, dwo.to(wo.dtype))


folded_pool_layer_bwd.launches = 0
folded_pool_layer_bwd.launches_wmma = 0
folded_pool_layer_bwd.launches_f32 = 0


# ---------------------------------------------------------------- unpool --


def _unpool_ref(x, se, be, k, v, wq, wo, num_heads: int, residual: bool = True,
                prenorm: bool = True):
    """Plain version (the JAX package's ``_unpool_ref``): normalises x
    (where ``prenorm``, else y = x), then folds the unscaled wq; adds x
    where ``residual``. The forward kernel folds se into wq before rounding
    (as the TPU kernel does), so the two differ at bf16 rounding level by
    design; the backward kernel folds as this version does."""
    dt = x.dtype
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    d = c // num_heads
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt) if prenorm else x
    kf = (1.0 / d**0.5) * torch.einsum(
        "hdc,bihd->bchi",
        wq.to(dt).float().reshape(num_heads, d, c),
        k.float().reshape(b, i, num_heads, d),
    )
    kf = kf.reshape(b, c, j).to(dt)
    vf = torch.einsum(
        "bihd,chd->bhic",
        v.float().reshape(b, i, num_heads, d),
        wo.to(dt).float().reshape(c, num_heads, d),
    ).reshape(b, j, c).to(dt)
    logits = torch.einsum("bnc,bcj->bnj", y.float(), kf.float())
    lg = logits.reshape(b, n, num_heads, i)
    p = torch.exp(lg - lg.amax(-1, keepdim=True).detach())
    p = (p / p.sum(-1, keepdim=True)).reshape(b, n, j)
    attn = torch.einsum("bnj,bjc->bnc", p.to(dt).float(), vf.float())
    if residual:
        attn = x.float() + attn
    return attn.to(dt), torch.stack([attn.sum(1), (attn * attn).sum(1)], dim=1)


def _unpool_fold_ref(se, be, k, v, wq, wo, num_heads: int, prenorm: bool = True) -> tuple:
    """Plain version of ``unpool_bq_kernel``, ``unpool_fold_k_kernel`` and
    ``unpool_fold_v_kernel``: kft [B, J, C] (se folded into wq before its
    rounding, as the TPU kernel does), vf transposed [B, C, J], both in k's
    dtype, and brow [B, J] fp32 (0 without the pre-norm)."""
    dt = k.dtype
    b, i, c = k.shape
    d = c // num_heads
    j = num_heads * i
    scale = 1.0 / d**0.5
    wqs = (wq.float()[None] * se[:, None, :]).to(dt) if prenorm else wq[None].expand(b, c, c)
    k_r = k.float().reshape(b, i, num_heads, d)
    kft = scale * torch.einsum("bihd,bhdc->bhic", k_r, wqs.float().reshape(b, num_heads, d, c))
    vft = torch.einsum("bihd,chd->bchi", v.float().reshape(b, i, num_heads, d),
                       wo.float().reshape(c, num_heads, d))
    if prenorm:
        bq = be.float() @ wq.float().t()
        brow = scale * torch.einsum("bhd,bihd->bhi", bq.reshape(b, num_heads, d), k_r)
    else:
        brow = torch.zeros((b, num_heads, i), dtype=_F32, device=k.device)
    return kft.reshape(b, j, c).to(dt), vft.reshape(b, c, j).to(dt), brow.reshape(b, j)


def _unpool_attn_ref(x, kft, vft, brow, num_heads: int, residual: bool = True):
    """The point tiles' fp32 output before its rounding: logits x @ kft^T +
    brow, a softmax per head block with its own max (exp argument clamped
    at -80), bf16 p @ vf, plus x where ``residual``."""
    b, n, _ = x.shape
    j = kft.shape[1]
    logits = torch.einsum("bnc,bjc->bnj", x.float(), kft.float()) + brow[:, None]
    lg = logits.reshape(b, n, num_heads, j // num_heads)
    e = torch.exp(torch.clamp(lg - lg.amax(-1, keepdim=True), min=-80.0))
    p = (e / e.sum(-1, keepdim=True)).reshape(b, n, j).to(x.dtype)
    attn = torch.einsum("bnj,bcj->bnc", p.float(), vft.float())
    return x.float() + attn if residual else attn


def _unpool_tiles_ref(x, kft, vft, brow, num_heads: int, residual: bool = True,
                      n_valid=None) -> tuple:
    """Plain version of ``unpool_tile_kernel`` (``_unpool_attn_ref``) ->
    (out, sums); the points from ``n_valid`` on (a ragged tail's padding)
    stay out of the sums."""
    attn = _unpool_attn_ref(x, kft, vft, brow, num_heads, residual)
    return attn.to(x.dtype), _row_sums(attn, n_valid)


def _row_sums(o, n_valid=None) -> torch.Tensor:
    """[B, 2, C] fp32 channel sums of o and o^2 over the points before
    ``n_valid`` (all N where None)."""
    ok = _valid_rows(o.shape[1], n_valid, o.device)
    if ok is not None:
        o = o.masked_fill(~ok, 0.0)
    return torch.stack([o.sum(1), (o * o).sum(1)], dim=1)


def _unpool_wmma_smem(tn: int, c: int, i: int) -> int:
    """Bytes of one point tile of the WMMA unpool body, or 0 where no plan
    fits the SM: csrc/unpool.cuh ``unpool_smem_plan`` (change both
    together): the head operands staged in two buffers, in one, or read
    from device memory."""
    for dbl in (1, 0, -1):
        region0 = max((tn + (1 + dbl) * i) * (c + _PAD) * 2, tn * (c + _PADF) * 4)
        region0 = -(-region0 // 128) * 128
        smem = region0 + tn * (i + _PADF) * 4 + tn * (i + _PAD) * 2
        if smem <= _MAX_SMEM:
            return smem
    return 0


# points per block of the Hopper unpool (csrc/unpool.cu kTile)
_UNPOOL_TILE = 64


def _unpool_tile_smem(c: int) -> int:
    """Bytes of one block of the Hopper unpool's tile kernel: csrc/unpool.cu
    ``TileSmem(C, CB)`` (change both together) at its column block CB (C up
    to 384, else 192): the x tile, both consumers' kft rings (four panels
    each), the vf ring (two slabs of CB rows), the two p buffers, the
    barriers and the alignment slack."""
    cb = c if c <= 384 else 192
    panel = _UNPOOL_TILE * 128
    return (c // 64) * panel + 2 * 4 * panel + 2 * cb * 128 + 2 * panel + (1 + 16 + 8) * 8 + 1024


def _unpool_hopper_takes(c: int, num_heads: int, i: int) -> bool:
    """The shapes of the Hopper unpool (csrc/unpool.cu ``unpool_launch``'s
    check: change both together): I == 64, H even, D = C / H a multiple of
    16 up to 64, C % 64 == 0 up to 384 (one column block of C) or C % 192
    == 0 above (blocks of 192), the block's shared memory within the
    SM's."""
    if i != 64 or num_heads < 1 or c % num_heads or num_heads % 2 or c % 64:
        return False
    d = c // num_heads
    return (d % 16 == 0 and d <= 64 and (c <= 384 or c % 192 == 0)
            and _unpool_tile_smem(c) <= _MAX_SMEM)


def _unpool_body(b: int, n: int, c: int, num_heads: int, i: int, dtype=_BF16) -> str:
    """Which forward body of ``folded_unpool`` takes these shapes on the
    card: "f32" (``f32.unpool_fwd``, any shape) for fp32 operands; for bf16
    ones "hopper" (csrc/unpool.cu, TMA and wgmma: I == 64, H even,
    D % 16 == 0, D <= 64, C % 64 == 0 up to 384 or C % 192 == 0 above:
    ``_unpool_hopper_takes``; the flagship, the 8k width and the upsample
    demo's C 128) where it can, else "wmma"
    (csrc/unpool_wmma.cu: C % 16 == 0 and a point tile of 64 or 32 rows
    whose shared memory fits the SM, its head operands staged or, from 192
    inducers at C 384, read from device memory: at C 384 up to 336
    inducers, at C 768 up to 688); both take any N (padded),
    and the WMMA body any I (a ragged I zero-padded to 16s and masked).
    Raises ValueError with both bodies' conditions otherwise."""
    if dtype == _F32:
        return "f32"
    d = c // num_heads
    if n >= 1 and _unpool_hopper_takes(c, num_heads, i):
        return "hopper"
    try:
        tn = _row_tile(_n_pad(n), c)
    except ValueError:
        tn = 0
    if c % num_heads == 0 and c % 16 == 0 and tn and _unpool_wmma_smem(tn, c, _i_pad(i)):
        return "wmma"
    raise ValueError(
        f"folded_unpool: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs I == 64, H even, D % 16 == 0, D <= 64 and "
        f"C % 64 == 0 up to 384 or C % 192 == 0 above; the WMMA body C % 16 == 0 and a point tile "
        f"(64 rows at C <= 384, 32 at C <= 768) whose block fits {_MAX_SMEM} bytes of "
        f"shared memory")


def _unpool_launch(x, se, be, k, v, wq, wo, num_heads: int, residual: bool, prenorm: bool,
                   body: str | None = None):
    """The forward kernels of the body ``_unpool_body`` picks (bq, fold,
    point tiles) -> (out, sums). ``body`` ("hopper" or "wmma") forces one
    where both take the shapes, for timing the two in turns; a forced body
    that does not take them fails its launch."""
    name = "folded_unpool"
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    dt = f32.route(name, dict(x=x, k=k, v=v, wq=wq, wo=wo))
    _check(name, dict(x=x, se=se, be=be, k=k, v=v, wq=wq, wo=wo),
           dict(x=_BF16, se=_F32, be=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16), dt)
    body = body or _unpool_body(b, n, c, num_heads, i, dt)
    if body == "f32":
        folded_unpool.launches_f32 += 1
        return f32.unpool_fwd(x, se, be, k, v, wq, wo, num_heads, residual, prenorm)
    dev = x.device
    n_valid, n = n, _n_pad(n)
    x = _pad_points(x, n)
    i_valid, i = i, _i_pad(i)
    k, v = _pad_points(k, i), _pad_points(v, i)
    j = num_heads * i
    kft = torch.empty((b, j, c), dtype=_BF16, device=dev)
    brow = torch.empty((b, j), dtype=_F32, device=dev)
    bq = torch.empty((b, c), dtype=_F32, device=dev)
    out = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), dtype=_F32, device=dev)
    if body == "hopper":
        vft = torch.empty((b, c, j), dtype=_BF16, device=dev)
        launch("unpool", "unpool_launch", x, se, be, k, v, wq, wo, bq, kft, vft, brow, out,
               sums, b, n, c, num_heads, i, int(residual), int(prenorm), n_valid)
        folded_unpool.launches += 1
    else:
        vf = torch.empty_like(kft)
        launch("unpool_wmma", "unpool_wmma_launch", x, se, be, k, v, wq, wo.t().contiguous(),
               bq, kft, vf, brow, out, sums, b, n, c, num_heads, i, _row_tile(n, c),
               int(residual), int(prenorm), n_valid, i_valid)
        folded_unpool.launches_wmma += 1
    return _unpad(out, n_valid), sums


class _Unpool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, se, be, k, v, wq, wo, num_heads, residual, prenorm, need_grad):
        cfg = (num_heads, residual, prenorm)
        if x.device.type == "cpu":
            out, sums = _unpool_ref(x, se, be, k, v, wq, wo, *cfg)
        else:
            out, sums = _unpool_launch(x, se, be, k, v, wq, wo, *cfg)
        if need_grad:
            ctx.save_for_backward(x, se, be, k, v, wq, wo)
        ctx.cfg = cfg
        return out, sums

    @staticmethod
    def backward(ctx, g_out, g_sums):
        grads = folded_unpool_bwd(*ctx.saved_tensors, g_out, g_sums, *ctx.cfg)
        return (*grads, None, None, None, None)


def folded_unpool(x, se, be, k, v, wq, wo, num_heads: int, residual: bool = True,
                  prenorm: bool = True):
    """x [B, N, C]; se/be [B, C] fp32; k/v [B, I, C] inducer-token
    projections; wq/wo [C, C] -> (x + attn(x*se+be), sums [B, 2, C] fp32),
    without the x term where ``residual`` is off and with y = x (se and be
    not read) where ``prenorm`` is off. Differentiable in every tensor
    argument, through both outputs."""
    need = needs_grad(x, se, be, k, v, wq, wo)
    return _Unpool.apply(x, se, be, k, v, wq, wo, num_heads, residual, prenorm, need)


folded_unpool.launches = 0
folded_unpool.launches_wmma = 0
folded_unpool.launches_f32 = 0


def _unpool_bwd_ref(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int, residual: bool = True,
                    prenorm: bool = True) -> tuple:
    """Plain version of the unpool backward: autograd through
    ``_unpool_ref`` -> (dx, dse, dbe, dk, dv, dwq, dwo)."""
    return vjp(lambda *a: _unpool_ref(*a, num_heads, residual, prenorm),
               (x, se, be, k, v, wq, wo), (g, g_sums))


def _unpool_bwd_fold_ref(k, v, wq, wo, num_heads: int) -> tuple:
    """Plain version of ``unpool_bwd_fold_kernel`` (both bodies): kft =
    s * k_h @ wq_h and vf = v_h @ wo_h^T, [B, J, C] in k's dtype (no se:
    the backward reads y explicitly)."""
    dt = k.dtype
    b, i, c = k.shape
    d = c // num_heads
    kft = (1.0 / d**0.5) * torch.einsum("bihd,hdc->bhic", k.float().reshape(b, i, num_heads, d),
                                         wq.float().reshape(num_heads, d, c))
    vf = torch.einsum("bihd,chd->bhic", v.float().reshape(b, i, num_heads, d),
                      wo.float().reshape(c, num_heads, d))
    return kft.reshape(b, -1, c).to(dt), vf.reshape(b, -1, c).to(dt)


def _unpool_bwd_tiles_ref(x, se, be, kft, vf, g, g_sums, num_heads: int, residual: bool = True,
                          prenorm: bool = True, n_valid=None) -> tuple:
    """Plain version of the Hopper body's point-wise passes (the heads and
    rows kernels, both walks) -> (p, ds, d_attn [B, N, J or C] in x's
    dtype, dx, dse, dbe [B, C] fp32): per head block its own max, e =
    exp(max(. - m, -80)), p = e / sum e; attn = x + bf16(p) vf; d_attn = g +
    gs1 + 2 attn gs2; dp = bf16(d_attn) vf^T; ds = p (dp - blocksum(dp p))
    where the logit sits above the clamp; dy = bf16(ds) kft; dx = dy se +
    d_attn. The sums' cotangent reaches only the points before ``n_valid``
    (the rest are a ragged tail's padding, g zero there)."""
    dt = x.dtype
    b, n, c = x.shape
    j = kft.shape[1]
    y = _prenormed(x, se, be) if prenorm else x.float()
    lg = torch.einsum("bnc,bjc->bnj", y, kft.float()).reshape(b, n, num_heads, j // num_heads)
    z = lg - lg.amax(-1, keepdim=True)
    e = torch.exp(torch.clamp(z, min=-80.0))
    p = e / e.sum(-1, keepdim=True)
    attn = torch.einsum("bnj,bjc->bnc", p.reshape(b, n, j).to(dt).float(), vf.float())
    if residual:
        attn = x.float() + attn
    d_attn = g.float() + _sums_cotangent(attn, g_sums, n_valid)
    dp = torch.einsum("bnc,bjc->bnj", d_attn.to(dt).float(), vf.float()).reshape(p.shape)
    ds = torch.where(z > -80.0, p * (dp - (dp * p).sum(-1, keepdim=True)), 0.0)
    ds = ds.reshape(b, n, j).to(dt)
    dy = torch.einsum("bnj,bjc->bnc", ds.float(), kft.float())
    dx = dy * se[:, None] if prenorm else dy
    if residual:
        dx = dx + d_attn
    zero = torch.zeros((b, c), dtype=_F32, device=x.device)
    dse, dbe = ((dy * x.float()).sum(1), dy.sum(1)) if prenorm else (zero, zero.clone())
    return p.reshape(b, n, j).to(dt), ds, d_attn.to(dt), dx.to(dt), dse, dbe


def _sums_cotangent(o, g_sums, n_valid=None) -> torch.Tensor:
    """The cotangent g_sums [B, 2, C] of ``_row_sums(o)`` on o [B, N, C]:
    gs1 + 2 o gs2 on the points before ``n_valid``, zero after."""
    t = g_sums[:, 0:1].float() + 2.0 * o * g_sums[:, 1:2].float()
    ok = _valid_rows(o.shape[1], n_valid, o.device)
    return t if ok is None else t.masked_fill(~ok, 0.0)


def _unpool_bwd_wgrad_ref(x, se, be, p, ds, d_attn, prenorm: bool = True) -> tuple:
    """Plain version of the weight-gradient products -> (dkf [B, C, J], dvf
    [B, J, C]) fp32: y^T bf16(ds) and bf16(p)^T bf16(d_attn) per batch
    element."""
    y = _prenormed(x, se, be) if prenorm else x.float()
    return (torch.einsum("bnc,bnj->bcj", y, ds.float()),
            torch.einsum("bnj,bnc->bjc", p.float(), d_attn.float()))


def _chain_unpool(dkf, dvf, k, v, wq, wo, num_heads: int) -> tuple:
    """The folded operands' gradients dkf [B, C, J] and dvf [B, J, C] fp32
    through the fold jacobians -> (dk, dv, dwq, dwo) (plain PyTorch, as the
    JAX package leaves them to XLA): one batched product per head for
    each, over dkf as [H, C, B I] and dvf as [H, B I, C], views of the
    Hopper body's per-head layout (copies of the WMMA body's)."""
    b, i, c = k.shape
    h = num_heads
    d = c // h
    scale = 1.0 / d**0.5
    x = dkf.reshape(b, c, h, i).permute(2, 1, 0, 3).reshape(h, c, b * i)
    y = dvf.reshape(b, h, i, c).permute(1, 0, 2, 3).reshape(h, b * i, c)
    per_head = lambda t: t.float().reshape(b, i, h, d).permute(2, 0, 1, 3).reshape(h, b * i, d)
    dk = scale * torch.bmm(wq.float().reshape(h, d, c), x)  # [H, D, B I]
    dwq = scale * torch.bmm(per_head(k).transpose(1, 2), x.transpose(1, 2))  # [H, D, C]
    dv = torch.bmm(y, wo.float().reshape(c, h, d).permute(1, 0, 2))  # [H, B I, D]
    dwo = torch.bmm(y.transpose(1, 2), per_head(v))  # [H, C, D]
    dk = dk.reshape(h, d, b, i).permute(2, 3, 0, 1).reshape(b, i, c)
    dv = dv.reshape(h, b, i, d).permute(1, 2, 0, 3).reshape(b, i, c)
    return (dk.to(k.dtype), dv.to(v.dtype), dwq.reshape(c, c).to(wq.dtype),
            dwo.permute(1, 0, 2).reshape(c, c).to(wo.dtype))


def _unpool_bwd_wmma_tile(c: int, i: int) -> int:
    """The point tile of the WMMA unpool backward's main kernel: 32 rows
    where its shared memory fits, else 16; 0 where neither fits.
    csrc/unpool_bwd_wmma.cu ``bwd_tile`` (change both together)."""
    for tn in (32, 16):
        smem = (2 * tn * (c + _PAD) * 2 + tn * (c + _PADF) * 4 + 2 * tn * (i + _PADF) * 4
                + 2 * tn * (i + _PAD) * 2)
        if smem <= _MAX_SMEM:
            return tn
    return 0


def _unpool_bwd_body(b: int, n: int, c: int, num_heads: int, i: int, dtype=_BF16) -> str:
    """Which body of ``folded_unpool_bwd`` takes these shapes on the card:
    "f32" (``f32.unpool_bwd``, any shape) for fp32 operands; for bf16 ones
    "hopper" (csrc/unpool_bwd.cu, TMA and wgmma: I == 64, C % 128 == 0 and
    C <= 384 or C % 384 == 0, any H: the flagship, the 8k width, the
    upsample demo's C 128 and three heads' D 128) where it can, else
    "wmma" (csrc/unpool_bwd_wmma.cu: C % 128 == 0, C <= 768, J % 64 == 0
    and a point tile of 32 or 16 rows within the SM's shared memory,
    ``_unpool_bwd_wmma_tile``: at C 384 up to 944 inducers, at C 768 up to
    688; another I, C 640); both need D % 16 == 0 and take any N (padded),
    and the WMMA body a ragged I (zero-padded to 16s and masked). Raises
    ValueError with both bodies' conditions otherwise."""
    if dtype == _F32:
        return "f32"
    d = c // num_heads
    ip = _i_pad(i)
    common = c % num_heads == 0 and d % 16 == 0 and n >= 1 and c % 128 == 0
    if common and i == 64 and (c <= 384 or c % 384 == 0):
        return "hopper"
    if (common and c <= 768 and (num_heads * ip) % 64 == 0
            and _unpool_bwd_wmma_tile(c, ip)):
        return "wmma"
    raise ValueError(
        f"folded_unpool_bwd: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs I == 64 and C <= 384 or C % 384 == 0; the "
        f"WMMA body C <= 768, J % 64 == 0 (I padded to 16s) and a point tile of 16 rows "
        f"within {_MAX_SMEM} bytes of shared memory; both C % 128 == 0 and D % 16 == 0")


def folded_unpool_bwd(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int, residual: bool = True,
                      prenorm: bool = True) -> tuple:
    """Gradients of ``folded_unpool`` against ``g`` [B, N, C] and
    ``g_sums`` [B, 2, C] -> (dx, dse, dbe, dk, dv, dwq, dwo), through the
    body that ``_unpool_bwd_body`` picks; dse and dbe are 0 without the
    pre-norm."""
    if x.device.type == "cpu":
        return _unpool_bwd_ref(x, se, be, k, v, wq, wo, g, g_sums, num_heads, residual, prenorm)
    name = "folded_unpool_bwd"
    b, n, c = x.shape
    i = k.shape[1]
    dt = f32.route(name, dict(x=x, k=k, v=v, wq=wq, wo=wo))
    g = g.to(x.dtype).contiguous()
    g_sums = g_sums.float().contiguous()
    _check(name, dict(x=x, se=se, be=be, k=k, v=v, wq=wq, wo=wo, g=g, g_sums=g_sums),
           dict(x=_BF16, se=_F32, be=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16, g=_BF16,
                g_sums=_F32), dt)
    body = _unpool_bwd_body(b, n, c, num_heads, i, dt)
    if body == "f32":
        run = f32.unpool_bwd
        folded_unpool_bwd.launches_f32 += 1
    else:
        run = _unpool_bwd_hopper if body == "hopper" else _unpool_bwd_wmma
    dx, dse, dbe, dkf, dvf = run(x, se, be, k, v, wq, wo, g, g_sums, num_heads, residual,
                                 prenorm)
    return (dx, dse, dbe, *_chain_unpool(dkf, dvf, k, v, wq, wo, num_heads))


def _unpool_bwd_hopper(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int, residual: bool,
                       prenorm: bool, mid: dict | None = None) -> tuple:
    """The Hopper body (csrc/unpool_bwd.cu) -> (dx, dse, dbe, dkf, dvf),
    dkf and dvf as [B, C, H, I] and [B, H, I, C] views of the per-head
    layout the kernel writes; ``mid``, where given, receives the passes'
    kft, vf, p, ds and d_attn, which ``probes.unpool_bwd`` holds against
    their plain pieces (p, ds and d_attn at the padded point count)."""
    b, n_valid, c = x.shape
    n = _n_pad(n_valid)
    x, g = _pad_points(x, n), _pad_points(g, n)
    i = k.shape[1]
    j = num_heads * i
    dev = x.device
    buf = dict(
        kft=torch.empty((b, j, c), dtype=_BF16, device=dev),
        vf=torch.empty((b, j, c), dtype=_BF16, device=dev),
        p=torch.empty((b, n, j), dtype=_BF16, device=dev),
        ds=torch.empty((b, n, j), dtype=_BF16, device=dev),
        d_attn=torch.empty_like(x),
    )
    dx = torch.empty_like(x)
    dse = torch.zeros((b, c), dtype=_F32, device=dev)
    dbe = torch.zeros_like(dse)
    dkf = torch.empty((num_heads, c, b, i), dtype=_F32, device=dev)
    dvf = torch.empty((num_heads, b, i, c), dtype=_F32, device=dev)
    splits = _wgrad_splits(b, n // 64, c, j, dev)
    launch("unpool_bwd", "unpool_bwd_launch", x, se, be, k, v, wq, wo, g, g_sums,
           torch.empty_like(x) if prenorm else None, buf["kft"], buf["vf"], buf["p"], buf["ds"],
           buf["d_attn"], torch.empty((b, n, c), dtype=_F32, device=dev) if residual else None,
           dx, dse, dbe, dkf, dvf,
           torch.empty((b * splits, c, j), dtype=_F32, device=dev) if splits > 1 else None,
           b, n, c, num_heads, i, int(residual), int(prenorm), splits, n_valid)
    folded_unpool_bwd.launches += 1
    if mid is not None:
        mid.update(buf)
    return _unpad(dx, n_valid), dse, dbe, dkf.permute(2, 1, 0, 3), dvf.permute(1, 0, 2, 3)


def _unpool_bwd_wmma(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int, residual: bool,
                     prenorm: bool) -> tuple:
    """The WMMA body (csrc/unpool_bwd_wmma.cu) -> (dx, dse, dbe, dkf, dvf);
    a ragged I goes zero-padded to 16s, its padding masked in the kernel
    and sliced off dkf and dvf."""
    b, n_valid, c = x.shape
    n = _n_pad(n_valid)
    x, g = _pad_points(x, n), _pad_points(g, n)
    i_valid = k.shape[1]
    i = _i_pad(i_valid)
    k, v = _pad_points(k, i), _pad_points(v, i)
    j = num_heads * i
    dev = x.device
    kft = torch.empty((b, j, c), dtype=_BF16, device=dev)
    p = torch.empty((b, n, j), dtype=_BF16, device=dev)
    dx = torch.empty_like(x)
    dse = torch.zeros((b, c), dtype=_F32, device=dev)
    dbe = torch.zeros_like(dse)
    dkf = torch.zeros((b, c, j), dtype=_F32, device=dev)
    dvf = torch.zeros((b, j, c), dtype=_F32, device=dev)
    launch("unpool_bwd_wmma", "unpool_bwd_wmma_launch", x, se, be, k, v, wq, wo, g, g_sums, kft,
           torch.empty_like(kft), p, torch.empty_like(p), torch.empty_like(x), dx, dse, dbe, dkf,
           dvf, b, n, c, num_heads, i, int(residual), int(prenorm), n_valid, i_valid)
    folded_unpool_bwd.launches_wmma += 1
    if i != i_valid:  # the padding inducers' columns and rows
        cols = (torch.arange(j, device=dev) % i) < i_valid
        dkf, dvf = dkf[:, :, cols], dvf[:, cols]
    return _unpad(dx, n_valid), dse, dbe, dkf, dvf


folded_unpool_bwd.launches = 0
folded_unpool_bwd.launches_wmma = 0
folded_unpool_bwd.launches_f32 = 0


# ------------------------------------------------------------- fused mlp --


def _mlp_ref(x, se, be, w1t, b1, w2t, b2):
    """Plain version (the JAX package's ``_mlp_ref``)."""
    dt = x.dtype
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt)
    h = torch.einsum("bnc,cw->bnw", y.float(), w1t.float()) + b1[None]
    g = torch.exp(-0.5 * h * h).to(dt)
    o = x.float() + (torch.einsum("bnw,wc->bnc", g.float(), w2t.float()) + b2[None])
    return o.to(dt), torch.stack([o.sum(1), (o * o).sum(1)], dim=1)


def _mlp_act_ref(y, w1t, b1) -> torch.Tensor:
    """Plain version of the Hopper bodies' first pass (``mlp_act_kernel``,
    ``mlp_bwd_act_kernel``) from the pre-normed y (``prenorm_kernel``;
    ``_prenormed`` in x's dtype): exp(-h^2 / 2) rounded to y's dtype
    [B, N, W], h = y @ w1t + b1."""
    h = torch.einsum("bnc,cw->bnw", y.float(), w1t.float()) + b1[None]
    return torch.exp(-0.5 * h * h).to(y.dtype)


def _mlp_out_ref(x, g, w2t, b2, n_valid=None) -> tuple:
    """Plain version of the Hopper forward's second pass and its sums
    (``mlp_out_kernel``, ``mlp_colsum_kernel``) from the first pass's g ->
    (out in x's dtype, sums [B, 2, C] fp32): o = x + (g @ w2t + b2), the
    sums over the points before ``n_valid`` (the rest are a ragged tail's
    padding)."""
    o = x.float() + (torch.einsum("bnw,wc->bnc", g.float(), w2t.float()) + b2[None])
    return o.to(x.dtype), _row_sums(o, n_valid)


def _mlp_hopper_takes(n: int, c: int, w: int) -> bool:
    """The Hopper MLP bodies' shapes (csrc/mlp_hopper.cuh ``hopper_takes``,
    which sees the padded N): C and W multiples of 384 (the single
    products' 192-column tiles, the weight gradients' 128-wide ones), N of
    the 128-row block once padded."""
    return c % 384 == 0 and w % 384 == 0 and _n_pad(n) % 128 == 0


def _mlp_body(b: int, n: int, c: int, w: int, dtype=_BF16) -> str:
    """Which body of ``fused_mlp_residual`` takes these shapes on the card:
    "f32" (``f32.mlp_fwd``, any shape) for fp32 operands; for bf16 ones
    "hopper" (csrc/mlp.cu, TMA and wgmma: C % 384 == 0, W % 384 == 0;
    the flagship's C 384 and the 8k width's C 768) where it can, else
    "wmma" (csrc/mlp_wmma.cu: C % 16 == 0, W % 64 == 0 and a 64- or
    32-point tile; the upsample demo's C 128); both take any N (padded).
    Raises ValueError with both bodies' conditions otherwise."""
    if dtype == _F32:
        return "f32"
    if _mlp_hopper_takes(n, c, w):
        return "hopper"
    try:
        _row_tile(_n_pad(n), c)
        tile = True
    except ValueError:
        tile = False
    if c % 16 == 0 and w % 64 == 0 and tile:
        return "wmma"
    raise ValueError(
        f"fused_mlp_residual: no CUDA body takes B={b}, N={n}, C={c}, W={w}: the Hopper body "
        f"needs C % 384 == 0 and W % 384 == 0; the WMMA body C % 16 == 0, W % 64 == 0 and C "
        f"<= 768")


def _mlp_launch(x, se, be, w1t, b1, w2t, b2):
    name = "fused_mlp_residual"
    b, n, c = x.shape
    w = w1t.shape[1]
    dt = f32.route(name, dict(x=x, w1t=w1t, w2t=w2t))
    _check(name, dict(x=x, se=se, be=be, w1t=w1t, b1=b1, w2t=w2t, b2=b2),
           dict(x=_BF16, se=_F32, be=_F32, w1t=_BF16, b1=_F32, w2t=_BF16, b2=_F32), dt)
    body = _mlp_body(b, n, c, w, dt)
    if body == "f32":
        fused_mlp_residual.launches_f32 += 1
        return f32.mlp_fwd(x, se, be, w1t, b1, w2t, b2)
    run = _mlp_hopper if body == "hopper" else _mlp_wmma
    out, sums = run(_pad_points(x, _n_pad(n)), se, be, w1t, b1, w2t, b2, n_valid=n)
    return _unpad(out, n), sums


def _mlp_hopper(x, se, be, w1t, b1, w2t, b2, mid: dict | None = None, n_valid=None) -> tuple:
    """The Hopper body (csrc/mlp.cu) on x [B, N, C], N a multiple of 128,
    whose points from ``n_valid`` on are padding (None: none) -> (out,
    sums); ``mid``, where given, receives the pre-normed y and the first
    pass's g, which ``probes.mlp_bwd`` holds against their plain pieces."""
    b, n, c = x.shape
    w = w1t.shape[1]
    dev = x.device
    y, g = torch.empty_like(x), torch.empty((b, n, w), dtype=_BF16, device=dev)
    out = torch.empty_like(x)
    sums = torch.empty((b, 2, c), dtype=_F32, device=dev)
    launch("mlp", "mlp_launch", x, se, be, w1t, b1, w2t, b2, y, g,
           torch.empty((b * n // 128, 2, c), dtype=_F32, device=dev), out, sums, b, n, c, w,
           n if n_valid is None else n_valid)
    fused_mlp_residual.launches += 1
    if mid is not None:
        mid.update(y=y, g=g)
    return out, sums


def _mlp_wmma(x, se, be, w1t, b1, w2t, b2, n_valid=None) -> tuple:
    """The WMMA body (csrc/mlp_wmma.cu) on x [B, N, C], N a multiple of
    128, whose points from ``n_valid`` on are padding -> (out, sums)."""
    b, n, c = x.shape
    w = w1t.shape[1]
    out = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), dtype=_F32, device=x.device)
    launch("mlp_wmma", "mlp_wmma_launch", x, se, be, w1t, b1, w2t, b2, out, sums, b, n, c, w,
           _row_tile(n, c), n if n_valid is None else n_valid)
    fused_mlp_residual.launches_wmma += 1
    return out, sums


class _MLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, se, be, w1t, b1, w2t, b2, need_grad):
        if x.device.type == "cpu":
            out, sums = _mlp_ref(x, se, be, w1t, b1, w2t, b2)
        else:
            out, sums = _mlp_launch(x, se, be, w1t, b1, w2t, b2)
        if need_grad:
            ctx.save_for_backward(x, se, be, w1t, b1, w2t, b2)
        return out, sums

    @staticmethod
    def backward(ctx, g_out, g_sums):
        return (*fused_mlp_residual_bwd(*ctx.saved_tensors, g_out, g_sums), None)


def fused_mlp_residual(x, se, be, w1t, b1, w2t, b2):
    """x [B, N, C]; se/be [B, C] fp32; w1t [C, W], b1 [1, W] fp32 (alpha
    folded); w2t [W, C], b2 [1, C] fp32 -> (x + mlp(x*se+be), output channel
    sums [B, 2, C] fp32), the sums feeding the next layer's pre-norm.
    Differentiable in every tensor argument, through both outputs; on the
    card through the body that ``_mlp_body`` picks."""
    need = needs_grad(x, se, be, w1t, b1, w2t, b2)
    return _MLP.apply(x, se, be, w1t, b1, w2t, b2, need)


fused_mlp_residual.launches = 0
fused_mlp_residual.launches_wmma = 0
fused_mlp_residual.launches_f32 = 0


def _mlp_bwd_ref(x, se, be, w1t, b1, w2t, b2, g, g_sums) -> tuple:
    """Plain version of the MLP backward: autograd through ``_mlp_ref`` ->
    (dx, dse, dbe, dw1t, db1, dw2t, db2)."""
    return vjp(_mlp_ref, (x, se, be, w1t, b1, w2t, b2), (g, g_sums))


def _mlp_bwd_grad_ref(x, a, w2t, b2, g, g_sums, n_valid=None) -> tuple:
    """Plain version of ``mlp_bwd_grad_kernel`` and db2's sum, from the
    first pass's a (``_mlp_act_ref``) -> (g' [B, N, C] fp32, bf16(g') in
    x's dtype, db2 [1, C] fp32): o = a @ w2t + b2 + x, g' = g + gs1 + 2 o
    gs2, without the sums' terms on the points from ``n_valid`` on."""
    o = (torch.einsum("bnw,wc->bnc", a.float(), w2t.float()) + b2[None]) + x.float()
    gp = g.float() + _sums_cotangent(o, g_sums, n_valid)
    return gp, gp.to(x.dtype), gp.sum((0, 1))[None]


def _mlp_bwd_dh_ref(y, w1t, b1, w2t, gb) -> tuple:
    """Plain version of ``mlp_bwd_dh_kernel`` and db1's sum, from the
    pre-normed y and bf16(g') -> (dh in y's dtype [B, N, W], db1 [1, W]
    fp32): h recomputed, a = exp(-h^2 / 2) in fp32, da = bf16(g') @ w2t^T,
    dh = da a (-h)."""
    h = torch.einsum("bnc,cw->bnw", y.float(), w1t.float()) + b1[None]
    da = torch.einsum("bnc,wc->bnw", gb.float(), w2t.float())
    dh = da * torch.exp(-0.5 * h * h) * (-h)
    return dh.to(y.dtype), dh.sum((0, 1))[None]


def _mlp_bwd_dx_ref(x, se, w1t, dh, gp) -> tuple:
    """Plain version of ``mlp_bwd_dx_kernel`` and its sums -> (dx in x's
    dtype, dse, dbe [B, C] fp32): dy = bf16(dh) @ w1t^T, dx = g' + dy se."""
    dy = torch.einsum("bnw,cw->bnc", dh.float(), w1t.float())
    return ((gp + dy * se[:, None]).to(x.dtype), (dy * x.float()).sum(1), dy.sum(1))


def _mlp_bwd_wgrad_ref(y, a, dh, gb) -> tuple:
    """Plain version of the weight-gradient products (``wgrad_kernel``) ->
    (dw1t [C, W], dw2t [W, C]) fp32: y^T bf16(dh) and bf16(a)^T bf16(g')
    over all rows."""
    return (torch.einsum("bnc,bnw->cw", y.float(), dh.float()),
            torch.einsum("bnw,bnc->wc", a.float(), gb.float()))


def _mlp_bwd_body(b: int, n: int, c: int, w: int, dtype=_BF16) -> str:
    """Which body of ``fused_mlp_residual_bwd`` takes these shapes on the
    card: "f32" (``f32.mlp_bwd``, any shape) for fp32 operands; for bf16
    ones "hopper" (csrc/mlp_bwd.cu, TMA and wgmma: C % 384 == 0, W % 384
    == 0; the flagship's C 384 and the 8k width's C 768) where it can, else
    "wmma" (csrc/mlp_bwd_wmma.cu: C % 128 == 0, C <= 768, W % 64 == 0; the
    upsample demo's C 128); both take any N (padded). Raises ValueError
    with both bodies' conditions otherwise."""
    if dtype == _F32:
        return "f32"
    if _mlp_hopper_takes(n, c, w):
        return "hopper"
    if c % 128 == 0 and c <= 768 and w % 64 == 0 and n >= 1:
        return "wmma"
    raise ValueError(
        f"fused_mlp_residual_bwd: no CUDA body takes B={b}, N={n}, C={c}, W={w}: the Hopper "
        f"body needs C % 384 == 0 and W % 384 == 0; the WMMA body C % 128 == 0, C <= 768 and "
        f"W % 64 == 0")


def fused_mlp_residual_bwd(x, se, be, w1t, b1, w2t, b2, g, g_sums) -> tuple:
    """Gradients of ``fused_mlp_residual`` against ``g`` [B, N, C] and
    ``g_sums`` [B, 2, C] -> (dx, dse, dbe, dw1t, db1, dw2t, db2), through
    the body that ``_mlp_bwd_body`` picks."""
    if x.device.type == "cpu":
        return _mlp_bwd_ref(x, se, be, w1t, b1, w2t, b2, g, g_sums)
    name = "fused_mlp_residual_bwd"
    b, n, c = x.shape
    w = w1t.shape[1]
    dt = f32.route(name, dict(x=x, w1t=w1t, w2t=w2t))
    g = g.to(x.dtype).contiguous()
    g_sums = g_sums.float().contiguous()
    _check(name, dict(x=x, se=se, be=be, w1t=w1t, b1=b1, w2t=w2t, b2=b2, g=g, g_sums=g_sums),
           dict(x=_BF16, se=_F32, be=_F32, w1t=_BF16, b1=_F32, w2t=_BF16, b2=_F32, g=_BF16,
                g_sums=_F32), dt)
    body = _mlp_bwd_body(b, n, c, w, dt)
    if body == "f32":
        fused_mlp_residual_bwd.launches_f32 += 1
        return f32.mlp_bwd(x, se, be, w1t, b1, w2t, b2, g, g_sums)
    run = _mlp_bwd_hopper if body == "hopper" else _mlp_bwd_wmma
    n_pad = _n_pad(n)
    dx, dse, dbe, dw1t, db1, dw2t, db2 = run(_pad_points(x, n_pad), se, be, w1t, b1, w2t, b2,
                                             _pad_points(g, n_pad), g_sums, n_valid=n)
    return (_unpad(dx, n), dse, dbe, dw1t.to(w1t.dtype), db1.to(b1.dtype), dw2t.to(w2t.dtype),
            db2.to(b2.dtype))


def _mlp_bwd_hopper(x, se, be, w1t, b1, w2t, b2, g, g_sums, mid: dict | None = None,
                    n_valid=None) -> tuple:
    """The Hopper body (csrc/mlp_bwd.cu) on x and g [B, N, C], N a multiple
    of 128, whose points from ``n_valid`` on are zero padding -> (dx, dse,
    dbe, dw1t, db1, dw2t, db2), the weight and bias gradients fp32;
    ``mid``, where given, receives the passes' y, a, g' (fp32), bf16(g')
    and dh, which ``probes.mlp_bwd`` holds against their plain pieces."""
    b, n, c = x.shape
    w = w1t.shape[1]
    dev = x.device
    buf = dict(y=torch.empty_like(x), a=torch.empty((b, n, w), dtype=_BF16, device=dev),
               gp=torch.empty((b, n, c), dtype=_F32, device=dev),
               gb=torch.empty_like(x),
               dh=torch.empty((b, n, w), dtype=_BF16, device=dev))
    dx = torch.empty_like(x)
    dsb = torch.empty((b, 2, c), dtype=_F32, device=dev)
    dw1t = torch.empty((c, w), dtype=_F32, device=dev)
    db1 = torch.empty((1, w), dtype=_F32, device=dev)
    dw2t = torch.empty((w, c), dtype=_F32, device=dev)
    db2 = torch.empty((1, c), dtype=_F32, device=dev)
    splits = _wgrad_splits(1, b * n // 64, c, w, dev)
    launch("mlp_bwd", "mlp_bwd_launch", x, se, be, w1t, b1, w2t, b2, g, g_sums,
           buf["y"], buf["a"], buf["gb"], buf["gp"], buf["dh"],
           torch.empty((b * n // 128, max(w, 2 * c)), dtype=_F32, device=dev),
           torch.empty((splits, c, w), dtype=_F32, device=dev) if splits > 1 else None,
           dx, dsb, dw1t, db1, dw2t, db2, b, n, c, w, splits, n if n_valid is None else n_valid)
    fused_mlp_residual_bwd.launches += 1
    if mid is not None:
        mid.update(buf)
    return dx, dsb[:, 0], dsb[:, 1], dw1t, db1, dw2t, db2


def _mlp_bwd_wmma(x, se, be, w1t, b1, w2t, b2, g, g_sums, n_valid=None) -> tuple:
    """The WMMA body (csrc/mlp_bwd_wmma.cu) on x and g [B, N, C], N a
    multiple of 128, whose points from ``n_valid`` on are zero padding ->
    (dx, dse, dbe, dw1t, db1, dw2t, db2), the weight and bias gradients
    fp32 (fp32 atomics)."""
    b, n, c = x.shape
    w = w1t.shape[1]
    dev = x.device
    a = torch.empty((b, n, w), dtype=_BF16, device=dev)
    dx = torch.empty_like(x)
    dse = torch.zeros((b, c), dtype=_F32, device=dev)
    dbe = torch.zeros_like(dse)
    dw1t = torch.zeros((c, w), dtype=_F32, device=dev)
    db1 = torch.zeros((1, w), dtype=_F32, device=dev)
    dw2t = torch.zeros((w, c), dtype=_F32, device=dev)
    db2 = torch.zeros((1, c), dtype=_F32, device=dev)
    launch("mlp_bwd_wmma", "mlp_bwd_wmma_launch", x, se, be, w1t, b1, w2t, b2, g, g_sums, a,
           torch.empty_like(a), torch.empty_like(x), dx, dse, dbe, dw1t, db1, dw2t, db2,
           b, n, c, w, n if n_valid is None else n_valid)
    fused_mlp_residual_bwd.launches_wmma += 1
    return dx, dse, dbe, dw1t, db1, dw2t, db2


fused_mlp_residual_bwd.launches = 0
fused_mlp_residual_bwd.launches_wmma = 0
fused_mlp_residual_bwd.launches_f32 = 0


# ----------------------------------------------------- fused unpool + mlp --


def _affine_from_sums(sums, n_tokens: int, sc2, bi2, num_groups: int) -> tuple:
    """The mlp_norm collapse from channel sums [B, 2, C] with explicit embed
    affines sc2/bi2 [B, C] fp32 -> (se2, be2) [B, C] fp32 (the JAX
    package's ``_affine_from_sums``)."""
    mean_c, inv_c = stats_from_sums(sums[:, 0], sums[:, 1], n_tokens, num_groups)
    se2 = sc2 * inv_c
    return se2, bi2 - mean_c * se2


def _unpool_mlp_ref(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2,
                    num_heads: int, num_groups: int, n_tokens: int) -> tuple:
    """Plain version of the megakernel: the plain unpool, the collapse and
    the plain MLP -> (out [B, N, C], out sums [B, 2, C] fp32)."""
    xr, sums = _unpool_ref(x, se1, be1, k, v, wq, wo, num_heads)
    se2, be2 = _affine_from_sums(sums, n_tokens, sc2, bi2, num_groups)
    return _mlp_ref(xr, se2, be2, w1t, b1, w2t, b2)


def _unpool_mlp_block_sums_ref(o, n_valid=None) -> torch.Tensor:
    """Plain version of the Hopper megakernel's block sums
    (csrc/unpool_mlp.cu, the epilogues of (a) and (c)): from o [B, N, C]
    fp32 (x' or out before their rounding), N a multiple of 128, each
    128-point block's channel sums of o and o^2 [B, N / 128, 2, C], its
    first 64-point tile's with the second's added; the points from
    ``n_valid`` on (a ragged tail's padding) stay out."""
    b, n, c = o.shape
    ok = _valid_rows(n, n_valid, o.device)
    if ok is not None:
        o = o.masked_fill(~ok, 0.0)
    t = o.reshape(b, n // _MEGA_ROWS, 2, _MEGA_ROWS // 2, c)
    s = torch.stack([t.sum(3), (t * t).sum(3)], dim=3)
    return s[:, :, 0] + s[:, :, 1]


def _unpool_mlp_merge_ref(block_sums) -> torch.Tensor:
    """The cluster's sums [B, 2, C]: the blocks' [B, CS, 2, C] added in rank
    order (csrc/unpool_mlp.cu (b) and (d))."""
    out = block_sums[:, 0]
    for r in range(1, block_sums.shape[1]):
        out = out + block_sums[:, r]
    return out


def _unpool_mlp_pieces(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2,
                       num_heads: int, num_groups: int, n_tokens: int) -> tuple:
    """The Hopper megakernel's algebra from plain pieces, on x zero-padded
    to 128s as the wrapper pads it -> (out [B, N, C], sums): the fold and
    the unpool's tiles (x'), x''s block sums merged in rank order and
    collapsed (``_affine_from_sums``), y = bf16(x' se2 + be2), the MLP's
    two products, out's block sums merged likewise."""
    n_valid = x.shape[1]
    x = _pad_points(x, _n_pad(n_valid))
    dt = x.dtype
    kft, vft, brow = _unpool_fold_ref(se1, be1, k, v, wq, wo, num_heads)
    o1 = _unpool_attn_ref(x, kft, vft, brow, num_heads)
    xr = o1.to(dt)
    se2, be2 = _affine_from_sums(_unpool_mlp_merge_ref(_unpool_mlp_block_sums_ref(o1, n_valid)),
                                 n_tokens, sc2, bi2, num_groups)
    g = _mlp_act_ref(_prenormed(xr, se2, be2).to(dt), w1t, b1)
    o2 = xr.float() + (torch.einsum("bnw,wc->bnc", g.float(), w2t.float()) + b2[None])
    sums = _unpool_mlp_merge_ref(_unpool_mlp_block_sums_ref(o2, n_valid))
    return _unpad(o2.to(dt), n_valid), sums


def _unpool_mlp_composed(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2,
                         num_heads: int, num_groups: int, n_tokens: int) -> tuple:
    """The same function through the two differentiable fused functions
    (the JAX package's ``_unpool_mlp_composed`` without its point-axis
    psum): the separate kernels on CUDA tensors, the plain versions on CPU
    tensors; the megakernel's backward recomputes through it."""
    xr, sums = folded_unpool(x, se1, be1, k, v, wq, wo, num_heads)
    se2, be2 = _affine_from_sums(sums, n_tokens, sc2, bi2, num_groups)
    return fused_mlp_residual(xr, se2, be2, w1t, b1, w2t, b2)


# the Hopper megakernel's block: two 64-point tiles of x' held in shared
# memory; a cluster of up to 16 blocks a batch element (csrc/unpool_mlp.cu
# kBlockRows, kMaxCluster)
_MEGA_ROWS = 128
_MEGA_CLUSTER = 16


def _unpool_mlp_hopper_smem(c: int) -> int:
    """Bytes of one block of the megakernel's Hopper body: csrc/unpool_mlp.cu
    ``Smem`` (change both together): x' (two 64-point tiles of C columns),
    both consumers' three-stage K-panel rings, one [C, 64] slab, the two p
    buffers, the warps' column sums [2][4][2][C / 4] fp32, three [2, C] fp32
    buffers (the block's x' and out sums, se2 | be2), 22 barriers (the two
    x tiles', both rings', both slab halves', the p buffers') and the
    alignment slack."""
    panel = 64 * 128
    return (2 * (c // 64) * panel + 2 * 3 * panel + c * 128 + 2 * panel + 2 * 4 * 2 * (c // 4) * 4
            + 3 * 2 * c * 4 + 22 * 8 + 1024)


def _unpool_mlp_hopper_takes(n: int, c: int, num_heads: int, i: int, w: int) -> bool:
    """The shapes of the megakernel's Hopper body (csrc/unpool_mlp.cu
    ``takes``: change both together): C == 384, I == 64, H even, D = C / H
    a multiple of 16 up to 64, W % 128 == 0, and N, padded to 128s, at
    most one cluster of 16 blocks of 128 points (2048)."""
    if c != 384 or i != 64 or num_heads < 2 or num_heads % 2 or c % num_heads:
        return False
    d = c // num_heads
    return (d % 16 == 0 and d <= 64 and w >= 128 and w % 128 == 0
            and 1 <= n and _n_pad(n) <= _MEGA_CLUSTER * _MEGA_ROWS
            and _unpool_mlp_hopper_smem(c) <= _MAX_SMEM)


def _mlp_wmma_smem(tn: int, c: int, w: int) -> int:
    """Bytes of one point tile of the WMMA MLP device code, or 0 where no
    plan fits the SM or its chunk does not divide W: csrc/mlp.cuh
    ``mlp_smem_plan`` (change both together)."""
    for chunk in (64, 32):
        ldy = c + _PAD
        region0 = (tn * ldy + c * (chunk + _PAD) + chunk * ldy) * 2
        region0 = max(region0, tn * (c + _PADF) * 4)
        region0 = -(-region0 // 128) * 128
        smem = region0 + tn * (chunk + _PADF) * 4 + tn * (chunk + _PAD) * 2
        if smem <= _MAX_SMEM:
            return smem if w % chunk == 0 else 0
    return 0


def _unpool_mlp_wmma_tile(n: int, c: int, i: int, w: int) -> int:
    """The point tile of the megakernel's WMMA body (csrc/unpool_mlp_wmma.cu
    ``plan``), or 0 where it does not take the shapes: a tile dividing N
    (no ragged tail), C and I multiples of 16, and both the unpool's and
    the MLP's tile plans within one SM (``_unpool_wmma_smem``,
    ``_mlp_wmma_smem``)."""
    try:
        tn = _row_tile(n, c)
    except ValueError:
        return 0
    if c % 16 or i % 16 or not (_unpool_wmma_smem(tn, c, i) and _mlp_wmma_smem(tn, c, w)):
        return 0
    return tn


def _unpool_mlp_body(n: int, c: int, num_heads: int, i: int, w: int,
                     dtype=_BF16) -> str | None:
    """Which body of ``fused_unpool_mlp`` takes these shapes on the card:
    "f32" (the unpool's and the MLP's fp32 routes in turn, any shape) for
    fp32 operands; for bf16 ones "hopper" (csrc/unpool_mlp.cu, a cluster per batch element holding x' in
    shared memory: ``_unpool_mlp_hopper_takes``; the flagship, any N up to
    2048) where it can, else "wmma" (csrc/unpool_mlp_wmma.cu, one
    cooperative launch: ``_unpool_mlp_wmma_tile``; the upsample demo's C
    128, N beyond one cluster), else None: the layer then runs the separate
    unpool and MLP kernels, as the JAX package's ``unpool_mlp_vmem_ok``
    gate does. Decided from the shapes alone, before any launch."""
    if dtype == _F32:
        return "f32"
    if _unpool_mlp_hopper_takes(n, c, num_heads, i, w):
        return "hopper"
    if c % num_heads == 0 and _unpool_mlp_wmma_tile(n, c, i, w):
        return "wmma"
    return None


def unpool_mlp_fits_sm(n: int, c: int, i: int, w: int, num_heads: int, dtype=_BF16) -> bool:
    """Whether a body of the megakernel takes these shapes and operand
    dtype on the card (``_unpool_mlp_body``). The plain version has no such
    limit, so CPU tensors need no gate."""
    return _unpool_mlp_body(n, c, num_heads, i, w, dtype) is not None


def _unpool_mlp_launch(x, se1, be1, k, v, wq, wo, sc2, bi2, gind, w1t, b1, w2t, b2,
                       num_heads: int, num_groups: int, n_tokens: int,
                       body: str | None = None) -> tuple:
    """The kernels of the body ``_unpool_mlp_body`` picks -> (out, sums).
    ``body`` ("hopper" or "wmma") forces one where both take the shapes,
    for timing the two in turns; a forced body that does not take them
    fails its launch."""
    name = "fused_unpool_mlp"
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    w = w1t.shape[1]
    dt = f32.route(name, dict(x=x, k=k, v=v, wq=wq, wo=wo, w1t=w1t, w2t=w2t))
    _check(name, dict(x=x, se1=se1, be1=be1, k=k, v=v, wq=wq, wo=wo, sc2=sc2, bi2=bi2, w1t=w1t,
                      b1=b1, w2t=w2t, b2=b2),
           dict(x=_BF16, se1=_F32, be1=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16, sc2=_F32,
                bi2=_F32, w1t=_BF16, b1=_F32, w2t=_BF16, b2=_F32), dt)
    _require(tuple(gind.shape) == (c, num_groups), name,
             f"gind of shape (C, G) = ({c}, {num_groups}), got {tuple(gind.shape)}")
    body = body or _unpool_mlp_body(n, c, num_heads, i, w, dt)
    if body == "f32":
        # the unpool's and the MLP's fp32 routes, counted there
        return _unpool_mlp_composed(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2,
                                    num_heads, num_groups, n_tokens)
    _require(body is not None, name,
             f"C 384, I 64, H even, D % 16 == 0, D <= 64, W % 128 == 0 and N <= 2048 (the "
             f"Hopper body), or a point tile dividing N, C % 16, I % 16 and one SM's shared "
             f"memory (the WMMA body); got N={n}, C={c}, H={num_heads}, I={i}, W={w}")
    dev = x.device
    kft = torch.empty((b, j, c), dtype=_BF16, device=dev)
    bq = torch.empty((b, c), dtype=_F32, device=dev)
    brow = torch.empty((b, j), dtype=_F32, device=dev)
    if body == "hopper":
        n_valid, n = n, _n_pad(n)
        x = _pad_points(x, n)
        out = torch.empty_like(x)
        sums = torch.empty((b, 2, c), dtype=_F32, device=dev)
        launch("unpool_mlp", "unpool_mlp_launch", x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1,
               w2t, b2, bq, kft, torch.empty((b, c, j), dtype=_BF16, device=dev), brow, out,
               sums, b, n, c, num_heads, i, w, num_groups, n_valid, n_tokens)
        fused_unpool_mlp.launches += 1
        return _unpad(out, n_valid), sums
    out = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), dtype=_F32, device=dev)
    launch("unpool_mlp_wmma", "unpool_mlp_wmma_launch", x, se1, be1, k, v, wq,
           wo.t().contiguous(), sc2, bi2, w1t, b1, w2t, b2, bq, kft, torch.empty_like(kft), brow,
           torch.empty_like(x), torch.zeros((b, 2, c), dtype=_F32, device=dev),
           torch.empty((b, c), dtype=_F32, device=dev),
           torch.empty((b, c), dtype=_F32, device=dev), out, sums, b, n, c, num_heads, i, w, num_groups, n_tokens, _row_tile(n, c))
    fused_unpool_mlp.launches_wmma += 1
    return out, sums


class _UnpoolMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, se1, be1, k, v, wq, wo, sc2, bi2, gind, w1t, b1, w2t, b2,
                num_heads, num_groups, n_tokens, need_grad):
        cfg = (num_heads, num_groups, n_tokens)
        if x.device.type == "cpu":
            out, sums = _unpool_mlp_ref(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2,
                                        *cfg)
        else:
            out, sums = _unpool_mlp_launch(x, se1, be1, k, v, wq, wo, sc2, bi2, gind, w1t, b1,
                                           w2t, b2, *cfg)
        if need_grad:
            ctx.save_for_backward(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2)
        ctx.cfg = cfg
        return out, sums

    @staticmethod
    def backward(ctx, g_out, g_sums):
        grads = vjp(lambda *a: _unpool_mlp_composed(*a, *ctx.cfg), ctx.saved_tensors,
                    (g_out, g_sums))
        # gind, the constant group indicator, takes no gradient
        return (*grads[:9], None, *grads[9:], None, None, None, None)


def fused_unpool_mlp(x, se1, be1, k, v, wq, wo, sc2, bi2, gind, w1t, b1, w2t, b2,
                     num_heads: int, num_groups: int, n_tokens: int) -> tuple:
    """x [B, N, C]; se1/be1 [B, C] fp32 (the collapsed broadcast_norm); k/v
    [B, I, C]; wq/wo [C, C]; sc2/bi2 [B, C] fp32 (mlp_norm's embed affine,
    raw: the group statistics of the unpool's output fold in inside);
    gind [C, G] (the group indicator of ``num_groups`` groups, as the JAX
    signature; the kernel takes the groups from ``num_groups``); w1t/b1/
    w2t/b2 the folded MLP operands; ``n_tokens`` the points the statistics
    count -> (out [B, N, C], out channel sums [B, 2, C] fp32). The same
    function as ``folded_unpool``, ``_affine_from_sums`` and
    ``fused_mlp_residual`` in turn. Differentiable in every tensor argument
    but gind."""
    need = needs_grad(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2)
    return _UnpoolMLP.apply(x, se1, be1, k, v, wq, wo, sc2, bi2, gind, w1t, b1, w2t, b2,
                            num_heads, num_groups, n_tokens, need)


fused_unpool_mlp.launches = 0
fused_unpool_mlp.launches_wmma = 0
