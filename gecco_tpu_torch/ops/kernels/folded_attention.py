"""Folded induced-set attention and the fused MLP: Hopper kernels and their
plain PyTorch versions, forward and backward.

Counterpart of ``gecco_tpu/ops/pallas/folded_attention.py``. Three
differentiable functions carry a broadcasting layer's per-point work; each
is a ``torch.autograd.Function`` whose forward and backward launch CUDA
kernels (``gecco_tpu_torch/csrc``) for CUDA tensors and run their plain
versions (the JAX package's XLA twins, ported; the backward is autograd
through the plain forward, as the twins' ``jax.vjp``) for CPU tensors:

- ``folded_pool_ext`` (``csrc/pool_ext.cu``; backward ``csrc/pool_ext_bwd.cu``):
  the pre-normed stream pooled onto the inducers by a softmax over the point
  axis, online across tiles. When a gradient is needed the forward also
  returns the softmax statistics (column max and sum) the backward reads.
- ``folded_unpool`` (``csrc/unpool.cu``; backward ``csrc/unpool_bwd.cu``):
  the points attend to the inducer tokens (per-head softmax, each head block
  with its own max), plus the residual and the output's channel sums.
- ``fused_mlp_residual`` (``csrc/mlp.cu``; backward ``csrc/mlp_bwd.cu``):
  pre-norm + Gaussian MLP + residual, plus the output's channel sums.

and a fourth runs the second and third as one launch:

- ``fused_unpool_mlp`` (``csrc/unpool_mlp.cu``): unpool + residual, the
  mlp_norm statistics of the result from its channel sums, then the MLP +
  residual and the output's channel sums (the sampler's opt-in
  megakernel). Its backward recomputes through ``folded_unpool`` and
  ``fused_mlp_residual`` (``_unpool_mlp_composed``), whose backwards are
  the kernels above, as the JAX package's custom_vjp does.

A CUDA tensor never falls back to a plain version. Each forward wrapper
counts its kernel launches in ``.launches``; each backward has its own
wrapper (``*_bwd``) and counter. As in the JAX package, the backward kernels
take the incoming cotangent rounded to the activation dtype, and the small
chains from the folded operands' gradients to the weights' (``dqf`` to
``dind2``/``dWk``; ``dkf``/``dvf`` to ``dk``/``dv``/``dWq``/``dWo``) are
plain PyTorch outside the kernels.
"""

from __future__ import annotations

import functools

import torch

from gecco_tpu_torch.ops.kernels._build import check_cuda, launch, library
from gecco_tpu_torch.ops.norms import stats_from_sums
from gecco_tpu_torch.ops.kernels._grad import needs_grad, vjp

__all__ = [
    "folded_pool_ext",
    "folded_pool_ext_bwd",
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
    """Point tile of the unpool and MLP kernels: 64 rows where the [TN, C]
    fp32 output fits the register tiles (8 warps, each TN/16 rows x
    ceil(C/128) columns of 16 x 16 tiles, at most 12), else 32."""
    for tn in (64, 32):
        if -(-c // 128) * (tn // 16) <= 12 and n % tn == 0:
            return tn
    raise ValueError(f"no point tile divides N={n} at C={c}")


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: the CUDA kernel needs {what}")


# ------------------------------------------------------------------ pool --


def _pool_ext_ref(x, se, be, ind2, kvw, wo, num_heads: int) -> torch.Tensor:
    """Plain version (the JAX package's ``_pool_ext_ref``): h0 [B, I, C]."""
    dt = x.dtype
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt)
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


def _pool_ext_launch(x, se, be, ind2, kvw, wo, num_heads: int, stats: bool):
    """The forward kernel: h0, and the column max and sum [B, J] fp32 of
    the online softmax when ``stats`` (else None)."""
    name = "folded_pool_ext"
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    check_cuda(
        name, dict(x=x, se=se, be=be, ind2=ind2, kvw=kvw, wo=wo),
        dict(x=_BF16, se=_F32, be=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16),
    )
    _require(n % 64 == 0, name, f"N % 64 == 0 (N={n})")
    _require(c % 64 == 0 and d % 16 == 0 and i % 16 == 0, name,
             f"C % 64, D % 16 and I % 16 == 0 (C={c}, D={d}, I={i})")
    _require((b * i) % 64 == 0, name, f"B*I % 64 == 0 (B={b}, I={i})")
    qf = fold_qf(ind2, kvw, num_heads).contiguous()
    pooled = torch.empty((b, i, c), dtype=_BF16, device=x.device)
    h0 = torch.empty_like(pooled)
    macc = torch.empty((b, j), dtype=_F32, device=x.device) if stats else None
    sacc = torch.empty_like(macc) if stats else None
    launch("pool_ext", "pool_ext_launch", x, se, be, qf, kvw, wo, pooled, h0, macc, sacc,
           b, n, c, num_heads, i)
    folded_pool_ext.launches += 1
    return h0, macc, sacc


class _PoolExt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, se, be, ind2, kvw, wo, num_heads, need_grad):
        macc = sacc = None
        if x.device.type == "cpu":
            h0 = _pool_ext_ref(x, se, be, ind2, kvw, wo, num_heads)
        else:
            h0, macc, sacc = _pool_ext_launch(x, se, be, ind2, kvw, wo, num_heads, need_grad)
        if need_grad:
            ctx.save_for_backward(x, se, be, ind2, kvw, wo, macc, sacc)
        ctx.num_heads = num_heads
        return h0

    @staticmethod
    def backward(ctx, g_h0):
        x, se, be, ind2, kvw, wo, macc, sacc = ctx.saved_tensors
        grads = folded_pool_ext_bwd(x, se, be, ind2, kvw, wo, macc, sacc, g_h0, ctx.num_heads)
        return (*grads, None, None)


def folded_pool_ext(x, se, be, ind2, kvw, wo, num_heads: int) -> torch.Tensor:
    """x [B, N, C]; se/be [B, C] fp32 (the collapsed pre-norm ``x*se+be``,
    applied inline); ind2 [J, D] inducers; kvw [2C, C]; wo [C, C]
    -> h0 [B, I, C]. Differentiable in every tensor argument."""
    need = needs_grad(x, se, be, ind2, kvw, wo)
    return _PoolExt.apply(x, se, be, ind2, kvw, wo, num_heads, need)


folded_pool_ext.launches = 0


def _pool_ext_bwd_ref(x, se, be, ind2, kvw, wo, g_h0, num_heads: int) -> tuple:
    """Plain version of the pool backward: autograd through
    ``_pool_ext_ref`` -> (dx, dse, dbe, dind2, dkvw, dwo)."""
    return vjp(lambda *a: _pool_ext_ref(*a, num_heads), (x, se, be, ind2, kvw, wo), (g_h0,))


def folded_pool_ext_bwd(x, se, be, ind2, kvw, wo, macc, sacc, g_h0, num_heads: int) -> tuple:
    """Gradients of ``folded_pool_ext`` against ``g_h0`` [B, I, C], from
    the forward's inputs and its softmax statistics ``macc``/``sacc``
    [B, J] -> (dx, dse, dbe, dind2, dkvw, dwo). CPU tensors take the plain
    version (which needs no statistics)."""
    if x.device.type == "cpu":
        return _pool_ext_bwd_ref(x, se, be, ind2, kvw, wo, g_h0, num_heads)
    name = "folded_pool_ext_bwd"
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // num_heads
    g = g_h0.to(x.dtype).contiguous()
    check_cuda(
        name, dict(x=x, se=se, be=be, ind2=ind2, kvw=kvw, wo=wo, g=g, macc=macc, sacc=sacc),
        dict(x=_BF16, se=_F32, be=_F32, ind2=_BF16, kvw=_BF16, wo=_BF16, g=_BF16, macc=_F32,
             sacc=_F32),
    )
    _require(i == 64 and d % 16 == 0 and c in (384, 768), name,
             f"I == 64, D % 16 == 0 and C in (384, 768) (I={i}, D={d}, C={c})")
    _require(n % 64 == 0, name, f"N % 64 == 0 (N={n})")
    dev = x.device
    qf = fold_qf(ind2, kvw, num_heads).contiguous()
    ety = torch.empty((b, j, c), dtype=_BF16, device=dev)
    w2 = torch.empty((b, c, j), dtype=_BF16, device=dev)
    w3 = torch.empty((b, j, c), dtype=_BF16, device=dev)
    tacc = torch.empty((b, j), dtype=_F32, device=dev)
    ds = torch.empty((b, n, j), dtype=_BF16, device=dev)
    dx = torch.empty_like(x)
    dse = torch.zeros((b, c), dtype=_F32, device=dev)
    dbe = torch.zeros_like(dse)
    dqf = torch.zeros((c, j), dtype=_F32, device=dev)
    dwv = torch.zeros((c, c), dtype=_F32, device=dev)
    dwo = torch.zeros_like(dwv)
    launch("pool_ext_bwd", "pool_ext_bwd_launch", x, se, be, qf, kvw, wo, g, macc, sacc,
           ety, w2, w3, tacc, ds, dx, dse, dbe, dqf, dwv, dwo, b, n, c, num_heads, i)
    folded_pool_ext_bwd.launches += 1
    # dqf through the fold jacobian to the inducers and Wk (plain PyTorch,
    # as the JAX package leaves it to XLA)
    scale = 1.0 / d**0.5
    dqf_r = dqf.reshape(c, num_heads, i)
    dwk = scale * torch.einsum(
        "chi,hid->hdc", dqf_r, ind2.float().reshape(num_heads, i, d)).reshape(c, c)
    dind2 = scale * torch.einsum(
        "chi,hdc->hid", dqf_r, kvw[:c].float().reshape(num_heads, d, c)).reshape(j, d)
    dkvw = torch.cat([dwk, dwv], dim=0).to(kvw.dtype)
    return dx, dse, dbe, dind2.to(ind2.dtype), dkvw, dwo.to(wo.dtype)


folded_pool_ext_bwd.launches = 0


# ---------------------------------------------------------------- unpool --


def _unpool_ref(x, se, be, k, v, wq, wo, num_heads: int):
    """Plain version (the JAX package's ``_unpool_ref``, residual and
    pre-norm on): normalises x, then folds the unscaled wq. The forward
    kernel folds se into wq before rounding (as the TPU kernel does), so the
    two differ at bf16 rounding level by design; the backward kernel folds
    as this version does."""
    dt = x.dtype
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    d = c // num_heads
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt)
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
    attn = x.float() + torch.einsum("bnj,bjc->bnc", p.to(dt).float(), vf.float())
    return attn.to(dt), torch.stack([attn.sum(1), (attn * attn).sum(1)], dim=1)


def _unpool_launch(x, se, be, k, v, wq, wo, num_heads: int):
    name = "folded_unpool"
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    check_cuda(
        name, dict(x=x, se=se, be=be, k=k, v=v, wq=wq, wo=wo),
        dict(x=_BF16, se=_F32, be=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16),
    )
    _require(c % 16 == 0 and i % 16 == 0, name, f"C % 16 and I % 16 == 0 (C={c}, I={i})")
    tn = _row_tile(n, c)
    kft = torch.empty((b, j, c), dtype=_BF16, device=x.device)
    vf = torch.empty_like(kft)
    brow = torch.empty((b, j), dtype=_F32, device=x.device)
    bq = torch.empty((b, c), dtype=_F32, device=x.device)
    out = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), dtype=_F32, device=x.device)
    launch("unpool", "unpool_launch", x, se, be, k, v, wq, wo.t().contiguous(), bq, kft, vf,
           brow, out, sums, b, n, c, num_heads, i, tn)
    folded_unpool.launches += 1
    return out, sums


class _Unpool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, se, be, k, v, wq, wo, num_heads, need_grad):
        if x.device.type == "cpu":
            out, sums = _unpool_ref(x, se, be, k, v, wq, wo, num_heads)
        else:
            out, sums = _unpool_launch(x, se, be, k, v, wq, wo, num_heads)
        if need_grad:
            ctx.save_for_backward(x, se, be, k, v, wq, wo)
        ctx.num_heads = num_heads
        return out, sums

    @staticmethod
    def backward(ctx, g_out, g_sums):
        grads = folded_unpool_bwd(*ctx.saved_tensors, g_out, g_sums, ctx.num_heads)
        return (*grads, None, None)


def folded_unpool(x, se, be, k, v, wq, wo, num_heads: int):
    """x [B, N, C]; se/be [B, C] fp32; k/v [B, I, C] inducer-token
    projections; wq/wo [C, C] -> (x + attn(x*se+be), sums [B, 2, C] fp32).
    Differentiable in every tensor argument, through both outputs."""
    need = needs_grad(x, se, be, k, v, wq, wo)
    return _Unpool.apply(x, se, be, k, v, wq, wo, num_heads, need)


folded_unpool.launches = 0


def _unpool_bwd_ref(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int) -> tuple:
    """Plain version of the unpool backward: autograd through
    ``_unpool_ref`` -> (dx, dse, dbe, dk, dv, dwq, dwo)."""
    return vjp(lambda *a: _unpool_ref(*a, num_heads), (x, se, be, k, v, wq, wo), (g, g_sums))


def folded_unpool_bwd(x, se, be, k, v, wq, wo, g, g_sums, num_heads: int) -> tuple:
    """Gradients of ``folded_unpool`` against ``g`` [B, N, C] and
    ``g_sums`` [B, 2, C] -> (dx, dse, dbe, dk, dv, dwq, dwo)."""
    if x.device.type == "cpu":
        return _unpool_bwd_ref(x, se, be, k, v, wq, wo, g, g_sums, num_heads)
    name = "folded_unpool_bwd"
    b, n, c = x.shape
    i = k.shape[1]
    j = num_heads * i
    d = c // num_heads
    g = g.to(x.dtype).contiguous()
    g_sums = g_sums.float().contiguous()
    check_cuda(
        name, dict(x=x, se=se, be=be, k=k, v=v, wq=wq, wo=wo, g=g, g_sums=g_sums),
        dict(x=_BF16, se=_F32, be=_F32, k=_BF16, v=_BF16, wq=_BF16, wo=_BF16, g=_BF16,
             g_sums=_F32),
    )
    _require(i == 64 and d % 16 == 0 and c in (384, 768), name,
             f"I == 64, D % 16 == 0 and C in (384, 768) (I={i}, D={d}, C={c})")
    _require(n % 64 == 0, name, f"N % 64 == 0 (N={n})")
    dev = x.device
    kft = torch.empty((b, j, c), dtype=_BF16, device=dev)
    vf = torch.empty_like(kft)
    p = torch.empty((b, n, j), dtype=_BF16, device=dev)
    ds = torch.empty_like(p)
    da = torch.empty_like(x)
    dx = torch.empty_like(x)
    dse = torch.zeros((b, c), dtype=_F32, device=dev)
    dbe = torch.zeros_like(dse)
    dkf = torch.zeros((b, c, j), dtype=_F32, device=dev)
    dvf = torch.zeros((b, j, c), dtype=_F32, device=dev)
    launch("unpool_bwd", "unpool_bwd_launch", x, se, be, k, v, wq, wo, g, g_sums, kft, vf,
           p, ds, da, dx, dse, dbe, dkf, dvf, b, n, c, num_heads, i)
    folded_unpool_bwd.launches += 1
    # the folded operands' gradients through the fold jacobians (plain
    # PyTorch, as the JAX package leaves them to XLA)
    scale = 1.0 / d**0.5
    dkf_r = dkf.reshape(b, c, num_heads, i)
    dvf_r = dvf.reshape(b, num_heads, i, c)
    k_r = k.float().reshape(b, i, num_heads, d)
    v_r = v.float().reshape(b, i, num_heads, d)
    dk = scale * torch.einsum("hdc,bchi->bihd", wq.float().reshape(num_heads, d, c), dkf_r)
    dwq = scale * torch.einsum("bihd,bchi->hdc", k_r, dkf_r)
    dv = torch.einsum("chd,bhic->bihd", wo.float().reshape(c, num_heads, d), dvf_r)
    dwo = torch.einsum("bihd,bhic->chd", v_r, dvf_r)
    return (dx, dse, dbe, dk.reshape(b, i, c).to(k.dtype), dv.reshape(b, i, c).to(v.dtype),
            dwq.reshape(c, c).to(wq.dtype), dwo.reshape(c, c).to(wo.dtype))


folded_unpool_bwd.launches = 0


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
    _require(c in (384, 768) and w % 64 == 0, name,
             f"C in (384, 768) and W % 64 == 0 (C={c}, W={w})")
    _require(n % 64 == 0, name, f"N % 64 == 0 (N={n})")
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
