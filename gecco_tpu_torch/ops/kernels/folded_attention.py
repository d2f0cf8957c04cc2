"""Folded induced-set attention and the fused MLP: Hopper kernels and their
plain PyTorch versions.

Counterpart of ``gecco_tpu/ops/pallas/folded_attention.py``, forward only.
Three functions carry a broadcasting layer's per-point work; each launches
a CUDA kernel (``gecco_tpu_torch/csrc``) for CUDA tensors and runs its plain
version (the JAX package's XLA twin, ported) for CPU tensors:

- ``folded_pool_ext`` (``csrc/pool_ext.cu``): the pre-normed stream pooled
  onto the inducers by a softmax over the point axis, online across tiles.
- ``folded_unpool`` (``csrc/unpool.cu``): the points attend to the inducer
  tokens (per-head softmax, each head block with its own max), plus the
  residual and the output's channel sums.
- ``fused_mlp_residual`` (``csrc/mlp.cu``): pre-norm + Gaussian MLP +
  residual, plus the output's channel sums.

The wrappers are inference-only; a CUDA tensor never falls back to the
plain version. Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from gecco_tpu_torch.ops.kernels._build import check_cuda, launch

__all__ = [
    "folded_pool_ext",
    "folded_unpool",
    "fused_mlp_residual",
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
    p = torch.exp(lg - lg.amax(1, keepdim=True))
    p = (p / p.sum(1, keepdim=True)).to(dt)
    v = torch.einsum("bnc,dc->bnd", y.float(), kvw[c:].to(dt).float()).to(dt)
    pooled = torch.einsum(
        "bnhi,bnhd->bihd", p.float(), v.reshape(b, n, num_heads, d).float()
    ).to(dt)
    return torch.einsum(
        "bic,oc->bio", pooled.reshape(b, i, c).float(), wo.to(dt).float()
    ).to(dt)


def folded_pool_ext(x, se, be, ind2, kvw, wo, num_heads: int) -> torch.Tensor:
    """x [B, N, C]; se/be [B, C] fp32 (the collapsed pre-norm ``x*se+be``,
    applied inline); ind2 [J, D] inducers; kvw [2C, C]; wo [C, C]
    -> h0 [B, I, C]."""
    if x.device.type == "cpu":
        return _pool_ext_ref(x, se, be, ind2, kvw, wo, num_heads)
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
    launch("pool_ext", "pool_ext_launch", x, se, be, qf, kvw, wo, pooled, h0,
           b, n, c, num_heads, i)
    folded_pool_ext.launches += 1
    return h0


folded_pool_ext.launches = 0


# ---------------------------------------------------------------- unpool --


def _unpool_ref(x, se, be, k, v, wq, wo, num_heads: int):
    """Plain version (the JAX package's ``_unpool_ref``, residual and
    pre-norm on): normalises x, then folds the unscaled wq. The kernel folds
    se into wq before rounding (as the TPU kernel does), so the two differ
    at bf16 rounding level by design."""
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
    p = torch.exp(lg - lg.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).reshape(b, n, j)
    attn = x.float() + torch.einsum("bnj,bjc->bnc", p.to(dt).float(), vf.float())
    return attn.to(dt), torch.stack([attn.sum(1), (attn * attn).sum(1)], dim=1)


def folded_unpool(x, se, be, k, v, wq, wo, num_heads: int):
    """x [B, N, C]; se/be [B, C] fp32; k/v [B, I, C] inducer-token
    projections; wq/wo [C, C] -> (x + attn(x*se+be), sums [B, 2, C] fp32)."""
    if x.device.type == "cpu":
        return _unpool_ref(x, se, be, k, v, wq, wo, num_heads)
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


folded_unpool.launches = 0


# ------------------------------------------------------------- fused mlp --


def _mlp_ref(x, se, be, w1t, b1, w2t, b2):
    """Plain version (the JAX package's ``_mlp_ref``)."""
    dt = x.dtype
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(dt)
    h = torch.einsum("bnc,cw->bnw", y.float(), w1t.float()) + b1[None]
    g = torch.exp(-0.5 * h * h).to(dt)
    o = x.float() + (torch.einsum("bnw,wc->bnc", g.float(), w2t.float()) + b2[None])
    return o.to(dt), torch.stack([o.sum(1), (o * o).sum(1)], dim=1)


def fused_mlp_residual(x, se, be, w1t, b1, w2t, b2):
    """x [B, N, C]; se/be [B, C] fp32; w1t [C, W], b1 [1, W] fp32 (alpha
    folded); w2t [W, C], b2 [1, C] fp32 -> (x + mlp(x*se+be), output channel
    sums [B, 2, C] fp32), the sums feeding the next layer's pre-norm."""
    if x.device.type == "cpu":
        return _mlp_ref(x, se, be, w1t, b1, w2t, b2)
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


fused_mlp_residual.launches = 0
