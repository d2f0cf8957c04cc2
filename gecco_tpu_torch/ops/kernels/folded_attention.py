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
- ``folded_pool_layer`` (``csrc/pool.cu``; backward ``csrc/pool_bwd.cu``):
  the resident pool, the same pooling with the set-level GroupNorm
  statistics of the stream computed on the card (``prenorm``, returned
  beside h0) or no pre-norm at all: the layer's sums-less route and the
  module-level pool.
- ``folded_unpool`` (``csrc/unpool.cu``; backward ``csrc/unpool_bwd.cu``,
  WMMA body ``csrc/unpool_bwd_wmma.cu``):
  the points attend to the inducer tokens (per-head softmax, each head block
  with its own max), plus the residual and the output's channel sums; the
  ``residual`` and ``prenorm`` flags turn the x term and the pre-norm off
  (the module-level unpool).
- ``fused_mlp_residual`` (``csrc/mlp.cu``; backward ``csrc/mlp_bwd.cu``):
  pre-norm + Gaussian MLP + residual, plus the output's channel sums.

and a fourth runs the second and third as one launch:

- ``fused_unpool_mlp`` (``csrc/unpool_mlp.cu``): unpool + residual, the
  mlp_norm statistics of the result from its channel sums, then the MLP +
  residual and the output's channel sums (the sampler's opt-in
  megakernel). Its backward recomputes through ``folded_unpool`` and
  ``fused_mlp_residual`` (``_unpool_mlp_composed``), whose backwards are
  the kernels above, as the JAX package's custom_vjp does.

The pool and unpool forwards and backwards each keep a second, WMMA body
(``csrc/*_wmma.cu``) for the shapes their Hopper design does not take;
``_pool_ext_body``, ``_unpool_body``, ``_pool_ext_bwd_body`` and
``_unpool_bwd_body`` choose by shape, and a shape that neither body takes
raises, as one that the MLP backward's one body (``_mlp_bwd_body``) does
not take does. A CUDA tensor never falls back to a plain version. Each
forward wrapper counts its kernel launches in ``.launches`` (the WMMA
body's in ``.launches_wmma``); each backward has its own wrapper
(``*_bwd``) and counters. As in the JAX package, the backward kernels
take the incoming cotangent rounded to the activation dtype, and the small
chains from the folded operands' gradients to the weights' (``dqf`` to
``dind2``/``dWk``; ``dkf``/``dvf`` to ``dk``/``dv``/``dWq``/``dWo``) are
plain PyTorch outside the kernels.
"""

from __future__ import annotations

import functools

import torch

from gecco_tpu_torch.ops.kernels._build import check_cuda, launch, library
from gecco_tpu_torch.ops.norms import group_norm_stats, stats_from_sums
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


# ------------------------------------------------------------------ pool --


def _pool_ref_from_y(y, ind2, kvw, wo, num_heads: int) -> torch.Tensor:
    """The pool of the pre-normed stream y [B, N, C] onto the inducers, as
    both plain versions compute it from y on: h0 [B, I, C] in y's dtype."""
    dt = y.dtype
    b, n, c = y.shape
    j, d = ind2.shape
    i = j // num_heads
    qf = fold_qf(ind2.to(dt), kvw.to(dt), num_heads)
    logits = torch.einsum("bnc,cj->bnj", y.float(), qf.float())
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


def _fold_qft_ref(ind2, kvw, num_heads: int) -> torch.Tensor:
    """Plain version of ``pool_fold_kernel``: the folded query transposed,
    qf^T [J, C] in kvw's dtype."""
    return fold_qf(ind2, kvw, num_heads).t()


def _pool_partials_ref(x, se, be, qft, kvw, num_heads: int) -> tuple:
    """Plain version of ``pool_chunk_kernel``: per chunk of ``_POOL_CHUNK`` points
    of y = x*se+be, each column's max m and sum l of e = exp(max(s - m,
    -80)) [B, N/rows, J] and P = e^T @ v [B, N/rows, J, D], fp32 (e and v
    rounded to x's dtype before the product)."""
    dt = x.dtype
    b, n, c = x.shape
    j = qft.shape[0]
    i, d = j // num_heads, c // num_heads
    rows = _POOL_CHUNK
    k = n // rows
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt)
    s = torch.einsum("bnc,jc->bnj", y.float(), qft.float()).reshape(b, k, rows, j)
    v = torch.einsum("bnc,dc->bnd", y.float(), kvw[c:].float()).to(dt)
    m = s.amax(2)
    e = torch.exp(torch.clamp(s - m[:, :, None], min=-80.0))
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


def _pool_ext_body(b: int, n: int, c: int, num_heads: int, i: int) -> str:
    """Which forward body of ``folded_pool_ext`` takes these shapes on the
    card: "hopper" (csrc/pool_ext.cu, TMA and wgmma: I == 64, D == 48,
    H % 8 == 0, C % 64 == 0, C <= 768) where it can, else "wmma"
    (csrc/pool_ext_wmma.cu: C % 64, D % 16 and I % 16 == 0, one block's
    shared memory within the SM's); both need N % 64 and B*I % 64 == 0.
    Raises ValueError with both bodies' conditions otherwise."""
    d = c // num_heads
    common = c % num_heads == 0 and n % 64 == 0 and (b * i) % 64 == 0
    if common and i == 64 and d == 48 and num_heads % 8 == 0 and c % 64 == 0 and c <= 768:
        return "hopper"
    if (common and c % 64 == 0 and d % 16 == 0 and i % 16 == 0
            and _pool_wmma_smem(c, i, d) <= _MAX_SMEM):
        return "wmma"
    raise ValueError(
        f"folded_pool_ext: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs I == 64, D == 48, H % 8 == 0, C % 64 == 0 and "
        f"C <= 768; the WMMA body C % 64, D % 16, I % 16 == 0 and its block within "
        f"{_MAX_SMEM} bytes of shared memory; both N % 64 == 0 and B*I % 64 == 0")


def _pool_ext_launch(x, se, be, ind2, kvw, wo, num_heads: int, stats: bool):
    """The forward kernels of the body ``_pool_ext_body`` picks -> (h0,
    qft, macc, sacc): the folded query qf^T [J, C] the logits were formed
    with, and the softmax's column max and sum [B, J] fp32, when ``stats``
    (else Nones). The Hopper body runs four launches (fold, chunks, merge,
    output projection), the WMMA body two (per-head pool, output
    projection) on a fold in PyTorch."""
    name = "folded_pool_ext"
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    check_cuda(
        name, dict(x=x, se=se, be=be, ind2=ind2, kvw=kvw, wo=wo),
        dict(x=_BF16, se=_F32, be=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16),
    )
    body = _pool_ext_body(b, n, c, num_heads, i)
    dev = x.device
    pooled = torch.empty((b, i, c), dtype=_BF16, device=dev)
    h0 = torch.empty_like(pooled)
    macc = torch.empty((b, j), dtype=_F32, device=dev) if stats else None
    sacc = torch.empty_like(macc) if stats else None
    if body == "hopper":
        rows = _POOL_CHUNK
        qft = torch.empty((j, c), dtype=_BF16, device=dev)
        part_m = torch.empty((b, n // rows, j), dtype=_F32, device=dev)
        part_l = torch.empty_like(part_m)
        part_p = torch.empty((b, n // rows, j, d), dtype=_F32, device=dev)
        launch("pool_ext", "pool_ext_launch", x, se, be, ind2, kvw, wo, qft, part_m, part_l,
               part_p, pooled, h0, macc, sacc, b, n, c, num_heads, i)
        folded_pool_ext.launches += 1
    else:
        qf = fold_qf(ind2, kvw, num_heads).contiguous()
        launch("pool_ext_wmma", "pool_ext_wmma_launch", x, se, be, qf, kvw, wo, pooled, h0,
               macc, sacc, b, n, c, num_heads, i)
        folded_pool_ext.launches_wmma += 1
        qft = qf.t().contiguous() if stats else None
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


def _pool_bwd_ety_ref(x, se, be, qft, macc) -> torch.Tensor:
    """Plain version of ``pool_bwd_ety_kernel``: eTy = bf16(e)^T y [B, J, C]
    in x's dtype, e = exp(max(y qf - macc, -80))."""
    dt = x.dtype
    y = _prenormed(x, se, be)
    s = torch.einsum("bnc,jc->bnj", y, qft.float())
    e = torch.exp(torch.clamp(s - macc[:, None], min=-80.0)).to(dt)
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


def _pool_bwd_dy_ref(x, se, be, qft, w3, macc, tacc) -> tuple:
    """Plain version of ``pool_bwd_dy_kernel`` -> (dx in x's dtype, dse,
    dbe [B, C] fp32, ds [B, N, J] in x's dtype): ds = e (y W3^T - tacc)
    where s - macc > -80, dy = ds qf^T + e W3 (e and ds rounded first)."""
    dt = x.dtype
    y = _prenormed(x, se, be)
    z = torch.einsum("bnc,jc->bnj", y, qft.float()) - macc[:, None]
    e = torch.exp(torch.clamp(z, min=-80.0))
    dp = torch.einsum("bnc,bjc->bnj", y, w3.float())
    ds = torch.where(z > -80.0, e * (dp - tacc[:, None]), 0.0).to(dt)
    dy = (torch.einsum("bnj,jc->bnc", ds.float(), qft.float())
          + torch.einsum("bnj,bjc->bnc", e.to(dt).float(), w3.float()))
    return (dy * se[:, None]).to(dt), (dy * x.float()).sum(1), dy.sum(1), ds


def _pool_bwd_dqf_ref(x, se, be, ds) -> torch.Tensor:
    """Plain version of the dqf product (``wgrad_kernel``) and its sum: dqf = the sum
    over the batch of y^T ds [C, J] fp32."""
    return torch.einsum("bnc,bnj->cj", _prenormed(x, se, be), ds.float())


def _pool_bwd_fold_smem(c: int, i: int, d: int) -> int:
    """Bytes of one block of the pool backward's fold (both bodies):
    csrc/backward.cuh ``launch_pool_bwd_fold`` (change both together): the
    product buffer, DMs_h and merged_h [I, D] bf16, pacc_h [I, D] fp32."""
    return 64 * (64 + _PADF) * 4 + 2 * i * (d + _PAD) * 2 + i * (d + _PADF) * 4


def _pool_ext_bwd_body(b: int, n: int, c: int, num_heads: int, i: int) -> str:
    """Which body of ``folded_pool_ext_bwd`` takes these shapes on the card:
    "hopper" (csrc/pool_ext_bwd.cu, TMA and wgmma: C in (384, 768), I ==
    64, D <= 64, J % 128 == 0) where it can, else "wmma"
    (csrc/pool_ext_bwd_wmma.cu: C % 128 == 0, C <= 768, I % 16 and J % 64
    == 0, the fold's block within the SM's shared memory); both need D % 16
    and N % 64 == 0. The upsample demo's C 128 and the three-head
    flagship's D 128 take the WMMA body. Raises ValueError with both
    bodies' conditions otherwise."""
    d = c // num_heads
    j = num_heads * i
    common = c % num_heads == 0 and d % 16 == 0 and n % 64 == 0
    if common and c in (384, 768) and i == 64 and d <= 64 and j % 128 == 0:
        return "hopper"
    if (common and c % 128 == 0 and c <= 768 and i % 16 == 0 and j % 64 == 0
            and _pool_bwd_fold_smem(c, i, d) <= _MAX_SMEM):
        return "wmma"
    raise ValueError(
        f"folded_pool_ext_bwd: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs C in (384, 768), I == 64, D <= 64 and J % 128 == 0; "
        f"the WMMA body C % 128 == 0, C <= 768, I % 16 == 0, J % 64 == 0 and its fold within "
        f"{_MAX_SMEM} bytes of shared memory; both D % 16 == 0 and N % 64 == 0")


def folded_pool_ext_bwd(x, se, be, ind2, kvw, wo, qft, macc, sacc, g_h0,
                        num_heads: int) -> tuple:
    """Gradients of ``folded_pool_ext`` against ``g_h0`` [B, I, C], from
    the forward's inputs, the folded query ``qft`` [J, C] its logits were
    formed with (so that the backward's logits are the forward's, as the
    statistics assume) and its softmax statistics ``macc``/``sacc`` [B, J]
    -> (dx, dse, dbe, dind2, dkvw, dwo), through the body that
    ``_pool_ext_bwd_body`` picks. CPU tensors take the plain version
    (which needs none of the forward's results)."""
    if x.device.type == "cpu":
        return _pool_ext_bwd_ref(x, se, be, ind2, kvw, wo, g_h0, num_heads)
    name = "folded_pool_ext_bwd"
    b, n, c = x.shape
    i = ind2.shape[0] // num_heads
    g = g_h0.to(x.dtype).contiguous()
    check_cuda(
        name, dict(x=x, se=se, be=be, ind2=ind2, kvw=kvw, wo=wo, qft=qft, g=g, macc=macc,
                   sacc=sacc),
        dict(x=_BF16, se=_F32, be=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16, qft=_BF16, g=_BF16,
             macc=_F32, sacc=_F32),
    )
    if _pool_ext_bwd_body(b, n, c, num_heads, i) == "hopper":
        dx, dse, dbe, dqf, dwv, dwo, _ = _pool_ext_bwd_hopper(x, se, be, qft, kvw, wo, g, macc,
                                                              sacc, num_heads)
    else:
        dx, dse, dbe, dqf, dwv, dwo = _pool_ext_bwd_wmma(x, se, be, qft, kvw, wo, g, macc, sacc,
                                                         num_heads)
    return dx, dse, dbe, *_chain_dqf(dqf, dwv, ind2, kvw, num_heads), dwo.to(wo.dtype)


def _pool_ext_bwd_hopper(x, se, be, qft, kvw, wo, g, macc, sacc, num_heads: int) -> tuple:
    """The kernel (csrc/pool_ext_bwd.cu) -> (dx, dse, dbe, dqf, dwv, dwo,
    intermediates): the last a dict of the passes' eTy, W3, tacc and ds,
    which ``probes.pool_bwd`` holds against their plain pieces."""
    b, n, c = x.shape
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
           splits)
    folded_pool_ext_bwd.launches += 1
    return (buf["dx"], buf["dse"], buf["dbe"], dqf, buf["dwv"], buf["dwo"],
            {k: buf[k] for k in ("ety", "w3", "tacc", "ds")})


def _pool_ext_bwd_wmma(x, se, be, qft, kvw, wo, g, macc, sacc, num_heads: int) -> tuple:
    """The WMMA body (csrc/pool_ext_bwd_wmma.cu), the same algebra as the
    Hopper body's -> (dx, dse, dbe, dqf, dwv, dwo)."""
    b, n, c = x.shape
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
           b, n, c, num_heads, i)
    folded_pool_ext_bwd.launches_wmma += 1
    return dx, dse, dbe, dqf, dwv, dwo


def _wgrad_splits(batch: int, tiles: int, m: int, p: int, device) -> int:
    """Splits of each batch element's 64-row tiles in the Hopper backwards'
    weight-gradient product (csrc/wgrad.cuh): enough blocks of (128 x 128
    output tile, batch element, split) to give every SM one, at most one
    split per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, -(-sms // (batch * (m // 128) * (p // 128)))))


folded_pool_ext_bwd.launches = 0
folded_pool_ext_bwd.launches_wmma = 0


# --------------------------------------------------------- resident pool --


def _pool_ref(x, scale, bias, ind2, kvw, wo, num_groups: int, num_heads: int,
              prenorm: bool = True) -> tuple:
    """Plain version (the JAX package's ``_pool_ref``) -> (h0 [B, I, C],
    mean_c, inv_c [B, C] fp32): with ``prenorm`` the set-level GroupNorm
    statistics of x and y = (x - mean_c) * (inv_c * scale) + bias; without,
    y = x, mean 0 and inv 1."""
    b, _, c = x.shape
    if prenorm:
        mean_c, inv_c = group_norm_stats(x, num_groups)
        y = ((x.float() - mean_c[:, None]) * (inv_c * scale)[:, None] + bias[:, None]).to(x.dtype)
    else:
        mean_c = torch.zeros((b, c), dtype=_F32, device=x.device)
        inv_c = torch.ones_like(mean_c)
        y = x
    return _pool_ref_from_y(y, ind2, kvw, wo, num_heads), mean_c, inv_c


def _pool_layer_launch(x, scale, bias, ind2, kvw, wo, gind, num_heads: int, prenorm: bool,
                       stats: bool) -> tuple:
    """The forward kernels -> (h0, mean_c, inv_c, (m, l, P, y)): the
    softmax's column max and sum [B, J], the fp32 pooled values [B, I, C]
    and the pre-normed stream y (x itself without the pre-norm) for the
    backward where ``stats``, else Nones."""
    name = "folded_pool_layer"
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    groups = gind.shape[1]
    check_cuda(
        name, dict(x=x, scale=scale, bias=bias, ind2=ind2, kvw=kvw, wo=wo),
        dict(x=_BF16, scale=_F32, bias=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16),
    )
    _require(tuple(gind.shape) == (c, groups) and c % groups == 0, name,
             f"gind of shape (C, G) with G dividing C = {c}, got {tuple(gind.shape)}")
    _require(n % 64 == 0 and c % 64 == 0 and c <= 2048, name,
             f"N % 64 == 0, C % 64 == 0 and C <= 2048 (N={n}, C={c})")
    _require(d % 16 == 0 and i % 16 == 0 and (b * i) % 64 == 0, name,
             f"D % 16, I % 16 and B*I % 64 == 0 (D={d}, I={i}, B={b})")
    dev = x.device
    qf = fold_qf(ind2, kvw, num_heads).contiguous()
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
    m = l = pacc = None
    if stats:
        m = torch.empty((b, j), dtype=_F32, device=dev)
        l = torch.empty_like(m)
        pacc = torch.empty((b, i, c), dtype=_F32, device=dev)
    launch("pool", "pool_layer_launch", x, scale, bias, qf, kvw, wo, part,
           mean_c if prenorm else None, inv_c, y, pooled, h0, m, l, pacc, b, n, c, num_heads, i,
           groups)
    folded_pool_layer.launches += 1
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


def folded_pool_layer_bwd(x, scale, bias, ind2, kvw, wo, gind, mean_c, inv_c, m, l, pacc, y,
                          g_h0, g_mean, g_inv, num_heads: int, prenorm: bool = True) -> tuple:
    """Gradients of ``folded_pool_layer`` against the cotangents of its
    three outputs (``g_h0`` [B, I, C], ``g_mean``/``g_inv`` [B, C]), from
    the forward's inputs, its statistics ``mean_c``/``inv_c``, its
    softmax's ``m``/``l`` [B, J], its fp32 pooled values ``pacc``
    [B, I, C] and its pre-normed stream ``y`` [B, N, C] -> (dx, dscale,
    dbias, dind2, dkvw, dwo). CPU tensors take the plain version (which
    needs none of the forward's results)."""
    if x.device.type == "cpu":
        return _pool_layer_bwd_ref(x, scale, bias, ind2, kvw, wo, gind, g_h0, g_mean, g_inv,
                                   num_heads, prenorm)
    name = "folded_pool_layer_bwd"
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    groups = gind.shape[1]
    g = g_h0.to(x.dtype).contiguous()
    g_mean, g_inv = g_mean.float().contiguous(), g_inv.float().contiguous()
    check_cuda(
        name, dict(x=x, scale=scale, bias=bias, ind2=ind2, kvw=kvw, wo=wo, g=g, g_mean=g_mean,
                   g_inv=g_inv, mean_c=mean_c, inv_c=inv_c, m=m, l=l, pacc=pacc, y=y),
        dict(x=_BF16, scale=_F32, bias=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16, g=_BF16,
             g_mean=_F32, g_inv=_F32, mean_c=_F32, inv_c=_F32, m=_F32, l=_F32, pacc=_F32,
             y=_BF16),
    )
    _require(c % 64 == 0 and c <= 768 and d % 16 == 0 and i % 16 == 0 and j % 64 == 0, name,
             f"C % 64 == 0, C <= 768, D % 16, I % 16 and J % 64 == 0 (C={c}, D={d}, I={i})")
    _require(n % 64 == 0 and c % groups == 0, name,
             f"N % 64 == 0 and G dividing C (N={n}, C={c}, G={groups})")
    dev = x.device
    qf = fold_qf(ind2, kvw, num_heads).contiguous()
    dpool = torch.empty((b, i, c), dtype=_BF16, device=dev)
    tacc = torch.empty((b, j), dtype=_F32, device=dev)
    ds = torch.empty((b, n, j), dtype=_BF16, device=dev)
    dv = torch.empty_like(x)
    dx = torch.empty_like(x)
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
    launch("pool_bwd", "pool_layer_bwd_launch", x, mean_c if prenorm else None, inv_c, scale, y,
           qf, kvw, wo, g, g_mean, g_inv, m, l, pacc, dpool, tacc, ds, dv, dy, sdyxc, sdy, dx,
           dscale, dbias, dqf, dwvt, dwo, b, n, c, num_heads, i, groups)
    folded_pool_layer_bwd.launches += 1
    return dx, dscale, dbias, *_chain_dqf(dqf, dwvt.t(), ind2, kvw, num_heads), dwo.to(wo.dtype)


folded_pool_layer_bwd.launches = 0


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


def _unpool_tiles_ref(x, kft, vft, brow, num_heads: int, residual: bool = True) -> tuple:
    """Plain version of ``unpool_tile_kernel``: logits x @ kft^T + brow, a
    softmax per head block with its own max (exp argument clamped at -80),
    bf16 p @ vf, the residual where ``residual`` -> (out, sums)."""
    dt = x.dtype
    b, n, _ = x.shape
    j = kft.shape[1]
    logits = torch.einsum("bnc,bjc->bnj", x.float(), kft.float()) + brow[:, None]
    lg = logits.reshape(b, n, num_heads, j // num_heads)
    e = torch.exp(torch.clamp(lg - lg.amax(-1, keepdim=True), min=-80.0))
    p = (e / e.sum(-1, keepdim=True)).reshape(b, n, j).to(dt)
    attn = torch.einsum("bnj,bcj->bnc", p.float(), vft.float())
    if residual:
        attn = x.float() + attn
    return attn.to(dt), torch.stack([attn.sum(1), (attn * attn).sum(1)], dim=1)


def _unpool_wmma_smem(tn: int, c: int, i: int) -> int:
    """Bytes of one point tile of the WMMA unpool body, or 0 where no plan
    fits the SM: csrc/unpool.cuh ``unpool_smem_plan`` (change both
    together)."""
    for dbl in (1, 0):
        region0 = max((tn + (1 + dbl) * i) * (c + _PAD) * 2, tn * (c + _PADF) * 4)
        region0 = -(-region0 // 128) * 128
        smem = region0 + tn * (i + _PADF) * 4 + tn * (i + _PAD) * 2
        if smem <= _MAX_SMEM:
            return smem
    return 0


def _unpool_body(b: int, n: int, c: int, num_heads: int, i: int) -> str:
    """Which forward body of ``folded_unpool`` takes these shapes on the
    card: "hopper" (csrc/unpool.cu, TMA and wgmma: I == 64, H even,
    D % 16 == 0, D <= 64, C in (192, 384, 768), N % 64 == 0) where it can,
    else "wmma" (csrc/unpool_wmma.cu: C % 16 and I % 16 == 0, a point tile
    of 64 or 32 rows dividing N whose shared memory fits the SM). Raises
    ValueError with both bodies' conditions otherwise."""
    d = c // num_heads
    if (c % num_heads == 0 and i == 64 and num_heads % 2 == 0 and d % 16 == 0 and d <= 64
            and c in (192, 384, 768) and n % 64 == 0):
        return "hopper"
    try:
        tn = _row_tile(n, c)
    except ValueError:
        tn = 0
    if c % num_heads == 0 and c % 16 == 0 and i % 16 == 0 and tn and _unpool_wmma_smem(tn, c, i):
        return "wmma"
    raise ValueError(
        f"folded_unpool: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs I == 64, H even, D % 16 == 0, D <= 64, "
        f"C in (192, 384, 768) and N % 64 == 0; the WMMA body C % 16 == 0, I % 16 == 0 "
        f"and a point tile (64 rows at C <= 384, 32 at C <= 768) dividing N whose block fits "
        f"{_MAX_SMEM} bytes of shared memory")


def _unpool_launch(x, se, be, k, v, wq, wo, num_heads: int, residual: bool, prenorm: bool):
    """The forward kernels of the body ``_unpool_body`` picks (bq, fold,
    point tiles) -> (out, sums)."""
    name = "folded_unpool"
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    check_cuda(
        name, dict(x=x, se=se, be=be, k=k, v=v, wq=wq, wo=wo),
        dict(x=_BF16, se=_F32, be=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16),
    )
    body = _unpool_body(b, n, c, num_heads, i)
    dev = x.device
    kft = torch.empty((b, j, c), dtype=_BF16, device=dev)
    brow = torch.empty((b, j), dtype=_F32, device=dev)
    bq = torch.empty((b, c), dtype=_F32, device=dev)
    out = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), dtype=_F32, device=dev)
    if body == "hopper":
        vft = torch.empty((b, c, j), dtype=_BF16, device=dev)
        launch("unpool", "unpool_launch", x, se, be, k, v, wq, wo, bq, kft, vft, brow, out,
               sums, b, n, c, num_heads, i, int(residual), int(prenorm))
        folded_unpool.launches += 1
    else:
        vf = torch.empty_like(kft)
        launch("unpool_wmma", "unpool_wmma_launch", x, se, be, k, v, wq, wo.t().contiguous(),
               bq, kft, vf, brow, out, sums, b, n, c, num_heads, i, _row_tile(n, c),
               int(residual), int(prenorm))
        folded_unpool.launches_wmma += 1
    return out, sums


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
                          prenorm: bool = True) -> tuple:
    """Plain version of the Hopper body's point-wise passes (the heads and
    rows kernels, both walks) -> (p, ds, d_attn [B, N, J or C] in x's
    dtype, dx, dse, dbe [B, C] fp32): per head block its own max, e =
    exp(max(. - m, -80)), p = e / sum e; attn = x + bf16(p) vf; d_attn = g +
    gs1 + 2 attn gs2; dp = bf16(d_attn) vf^T; ds = p (dp - blocksum(dp p))
    where the logit sits above the clamp; dy = bf16(ds) kft; dx = dy se +
    d_attn."""
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
    d_attn = g.float() + g_sums[:, 0:1].float() + 2.0 * attn * g_sums[:, 1:2].float()
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


def _unpool_bwd_body(b: int, n: int, c: int, num_heads: int, i: int) -> str:
    """Which body of ``folded_unpool_bwd`` takes these shapes on the card:
    "hopper" (csrc/unpool_bwd.cu, TMA and wgmma: I == 64, H even, C % 128
    == 0 and C <= 384 or C % 384 == 0) where it can, else "wmma"
    (csrc/unpool_bwd_wmma.cu: C % 128 == 0, C <= 768, I % 16 == 0, I <= 64,
    J % 64 == 0; its 32-point tile then fits the SM's shared memory); both
    need D % 16 and N % 64 == 0. The three-head flagship takes the WMMA
    body. Raises ValueError with both bodies' conditions otherwise."""
    d = c // num_heads
    common = c % num_heads == 0 and d % 16 == 0 and n % 64 == 0 and c % 128 == 0
    if common and i == 64 and num_heads % 2 == 0 and (c <= 384 or c % 384 == 0):
        return "hopper"
    if common and c <= 768 and i % 16 == 0 and i <= 64 and (num_heads * i) % 64 == 0:
        return "wmma"
    raise ValueError(
        f"folded_unpool_bwd: no CUDA body takes B={b}, N={n}, C={c}, H={num_heads}, I={i} "
        f"(D={d}): the Hopper body needs I == 64, H even and C <= 384 or C % 384 == 0; the "
        f"WMMA body C <= 768, I % 16 == 0, I <= 64 and J % 64 == 0; both C % 128 == 0, "
        f"D % 16 == 0 and N % 64 == 0")


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
    g = g.to(x.dtype).contiguous()
    g_sums = g_sums.float().contiguous()
    check_cuda(
        name, dict(x=x, se=se, be=be, k=k, v=v, wq=wq, wo=wo, g=g, g_sums=g_sums),
        dict(x=_BF16, se=_F32, be=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16, g=_BF16,
             g_sums=_F32),
    )
    run = _unpool_bwd_hopper if _unpool_bwd_body(b, n, c, num_heads, i) == "hopper" \
        else _unpool_bwd_wmma
    dx, dse, dbe, dkf, dvf = run(x, se, be, k, v, wq, wo, g, g_sums, num_heads, residual,
                                 prenorm)
    return (dx, dse, dbe, *_chain_unpool(dkf, dvf, k, v, wq, wo, num_heads))


def _unpool_bwd_hopper(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int, residual: bool,
                       prenorm: bool, mid: dict | None = None) -> tuple:
    """The Hopper body (csrc/unpool_bwd.cu) -> (dx, dse, dbe, dkf, dvf),
    dkf and dvf as [B, C, H, I] and [B, H, I, C] views of the per-head
    layout the kernel writes; ``mid``, where given, receives the passes'
    kft, vf, p, ds and d_attn, which ``probes.unpool_bwd`` holds against
    their plain pieces."""
    b, n, c = x.shape
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
           b, n, c, num_heads, i, int(residual), int(prenorm), splits)
    folded_unpool_bwd.launches += 1
    if mid is not None:
        mid.update(buf)
    return dx, dse, dbe, dkf.permute(2, 1, 0, 3), dvf.permute(1, 0, 2, 3)


def _unpool_bwd_wmma(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int, residual: bool,
                     prenorm: bool) -> tuple:
    """The WMMA body (csrc/unpool_bwd_wmma.cu) -> (dx, dse, dbe, dkf, dvf)."""
    b, n, c = x.shape
    i = k.shape[1]
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
           dvf, b, n, c, num_heads, i, int(residual), int(prenorm))
    folded_unpool_bwd.launches_wmma += 1
    return dx, dse, dbe, dkf, dvf


folded_unpool_bwd.launches = 0
folded_unpool_bwd.launches_wmma = 0


# ------------------------------------------------------------- fused mlp --


def _mlp_ref(x, se, be, w1t, b1, w2t, b2):
    """Plain version (the JAX package's ``_mlp_ref``)."""
    dt = x.dtype
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt)
    h = torch.einsum("bnc,cw->bnw", y.float(), w1t.float()) + b1[None]
    g = torch.exp(-0.5 * h * h).to(dt)
    o = x.float() + (torch.einsum("bnw,wc->bnc", g.float(), w2t.float()) + b2[None])
    return o.to(dt), torch.stack([o.sum(1), (o * o).sum(1)], dim=1)


def _mlp_launch(x, se, be, w1t, b1, w2t, b2):
    name = "fused_mlp_residual"
    b, n, c = x.shape
    w = w1t.shape[1]
    check_cuda(
        name, dict(x=x, se=se, be=be, w1t=w1t, b1=b1, w2t=w2t, b2=b2),
        dict(x=_BF16, se=_F32, be=_F32, w1t=_BF16, b1=_F32, w2t=_BF16, b2=_F32),
    )
    _require(c % 16 == 0 and w % 64 == 0, name, f"C % 16 and W % 64 == 0 (C={c}, W={w})")
    tn = _row_tile(n, c)
    out = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), dtype=_F32, device=x.device)
    launch("mlp", "mlp_launch", x, se, be, w1t, b1, w2t, b2, out, sums, b, n, c, w, tn)
    fused_mlp_residual.launches += 1
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
    Differentiable in every tensor argument, through both outputs."""
    need = needs_grad(x, se, be, w1t, b1, w2t, b2)
    return _MLP.apply(x, se, be, w1t, b1, w2t, b2, need)


fused_mlp_residual.launches = 0


def _mlp_bwd_ref(x, se, be, w1t, b1, w2t, b2, g, g_sums) -> tuple:
    """Plain version of the MLP backward: autograd through ``_mlp_ref`` ->
    (dx, dse, dbe, dw1t, db1, dw2t, db2)."""
    return vjp(_mlp_ref, (x, se, be, w1t, b1, w2t, b2), (g, g_sums))


def _mlp_bwd_body(b: int, n: int, c: int, w: int) -> str:
    """Which body of ``fused_mlp_residual_bwd`` takes these shapes on the
    card: "wmma" (csrc/mlp_bwd.cu, the one body: C % 128 == 0, C <= 768,
    W % 64 == 0, N % 64 == 0; 64-point tiles up to C 384, 32 above).
    Raises ValueError with its conditions otherwise."""
    if c % 128 == 0 and c <= 768 and w % 64 == 0 and n % 64 == 0:
        return "wmma"
    raise ValueError(
        f"fused_mlp_residual_bwd: no CUDA body takes B={b}, N={n}, C={c}, W={w}: the WMMA "
        f"body needs C % 128 == 0, C <= 768, W % 64 == 0 and N % 64 == 0")


def fused_mlp_residual_bwd(x, se, be, w1t, b1, w2t, b2, g, g_sums) -> tuple:
    """Gradients of ``fused_mlp_residual`` against ``g`` [B, N, C] and
    ``g_sums`` [B, 2, C] -> (dx, dse, dbe, dw1t, db1, dw2t, db2)."""
    if x.device.type == "cpu":
        return _mlp_bwd_ref(x, se, be, w1t, b1, w2t, b2, g, g_sums)
    name = "fused_mlp_residual_bwd"
    b, n, c = x.shape
    w = w1t.shape[1]
    g = g.to(x.dtype).contiguous()
    g_sums = g_sums.float().contiguous()
    check_cuda(
        name, dict(x=x, se=se, be=be, w1t=w1t, b1=b1, w2t=w2t, b2=b2, g=g, g_sums=g_sums),
        dict(x=_BF16, se=_F32, be=_F32, w1t=_BF16, b1=_F32, w2t=_BF16, b2=_F32, g=_BF16,
             g_sums=_F32),
    )
    _mlp_bwd_body(b, n, c, w)
    dev = x.device
    a = torch.empty((b, n, w), dtype=_BF16, device=dev)
    dh = torch.empty_like(a)
    gb = torch.empty_like(x)
    dx = torch.empty_like(x)
    dse = torch.zeros((b, c), dtype=_F32, device=dev)
    dbe = torch.zeros_like(dse)
    dw1t = torch.zeros((c, w), dtype=_F32, device=dev)
    db1 = torch.zeros((1, w), dtype=_F32, device=dev)
    dw2t = torch.zeros((w, c), dtype=_F32, device=dev)
    db2 = torch.zeros((1, c), dtype=_F32, device=dev)
    launch("mlp_bwd", "mlp_bwd_launch", x, se, be, w1t, b1, w2t, b2, g, g_sums, a, dh, gb,
           dx, dse, dbe, dw1t, db1, dw2t, db2, b, n, c, w)
    fused_mlp_residual_bwd.launches += 1
    return (dx, dse, dbe, dw1t.to(w1t.dtype), db1.to(b1.dtype), dw2t.to(w2t.dtype),
            db2.to(b2.dtype))


fused_mlp_residual_bwd.launches = 0


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


def _unpool_mlp_composed(x, se1, be1, k, v, wq, wo, sc2, bi2, w1t, b1, w2t, b2,
                         num_heads: int, num_groups: int, n_tokens: int) -> tuple:
    """The same function through the two differentiable fused functions
    (the JAX package's ``_unpool_mlp_composed`` without its point-axis
    psum): the separate kernels on CUDA tensors, the plain versions on CPU
    tensors; the megakernel's backward recomputes through it."""
    xr, sums = folded_unpool(x, se1, be1, k, v, wq, wo, num_heads)
    se2, be2 = _affine_from_sums(sums, n_tokens, sc2, bi2, num_groups)
    return fused_mlp_residual(xr, se2, be2, w1t, b1, w2t, b2)


@functools.lru_cache(maxsize=None)
def unpool_mlp_fits_sm(n: int, c: int, i: int, w: int) -> bool:
    """Whether the megakernel takes these shapes on the card: a point tile
    divides N, C and I are multiples of 16, and one block's shared memory
    (a point tile of the unpool, and one of the MLP, with their staging)
    fits the 227 KB of one SM (asks the built kernel library). The plain
    version has no such limit, so CPU tensors need no gate."""
    try:
        tn = _row_tile(n, c)
    except ValueError:
        return False
    if c % 16 or i % 16:
        return False
    return library("unpool_mlp").unpool_mlp_smem(c, i, w, tn) > 0


def _unpool_mlp_launch(x, se1, be1, k, v, wq, wo, sc2, bi2, gind, w1t, b1, w2t, b2,
                       num_heads: int, num_groups: int, n_tokens: int) -> tuple:
    name = "fused_unpool_mlp"
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    w = w1t.shape[1]
    check_cuda(
        name, dict(x=x, se1=se1, be1=be1, k=k, v=v, wq=wq, wo=wo, sc2=sc2, bi2=bi2, w1t=w1t,
                   b1=b1, w2t=w2t, b2=b2),
        dict(x=_BF16, se1=_F32, be1=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16, sc2=_F32,
             bi2=_F32, w1t=_BF16, b1=_F32, w2t=_BF16, b2=_F32),
    )
    _require(tuple(gind.shape) == (c, num_groups), name,
             f"gind of shape (C, G) = ({c}, {num_groups}), got {tuple(gind.shape)}")
    _require(unpool_mlp_fits_sm(n, c, i, w), name,
             f"a point tile dividing N, C % 16, I % 16 and one SM's shared memory "
             f"(N={n}, C={c}, I={i}, W={w})")
    dev = x.device
    kft = torch.empty((b, j, c), dtype=_BF16, device=dev)
    vf = torch.empty_like(kft)
    bq = torch.empty((b, c), dtype=_F32, device=dev)
    brow = torch.empty((b, j), dtype=_F32, device=dev)
    xp = torch.empty_like(x)
    sums1 = torch.zeros((b, 2, c), dtype=_F32, device=dev)
    se2 = torch.empty((b, c), dtype=_F32, device=dev)
    be2 = torch.empty_like(se2)
    out = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), dtype=_F32, device=dev)
    launch("unpool_mlp", "unpool_mlp_launch", x, se1, be1, k, v, wq, wo.t().contiguous(), sc2,
           bi2, w1t, b1, w2t, b2, bq, kft, vf, brow, xp, sums1, se2, be2, out, sums,
           b, n, c, num_heads, i, w, num_groups, n_tokens, _row_tile(n, c))
    fused_unpool_mlp.launches += 1
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
