"""Drifted-magnitude kernel certifier (counterpart of
``scripts/certify_kernels.py``):

    python -m gecco_tpu_torch.certify                    # the card
    python -m gecco_tpu_torch.certify --gains 1 12 --seeds 1
    python -m gecco_tpu_torch.certify --ema <run or checkpoint dir>
    python -m gecco_tpu_torch.certify --cpu --batch 2 --n-points 128 \\
        --width-c 64 --inducers 16 --heads 4 --mlp-width 128

Kernels that pass their checks at init-like operands can still fail once
trained magnitudes drift: per-head logit scales spreading over decades,
within-head logit ranges past where an exponential underflows. This script
synthesises each fused set-transformer wrapper's operands at such drift
profiles and holds the wrapper's forward and input gradients against its
plain PyTorch version on the same operands under one bf16-truncated
cotangent:

    folded_pool_ext    vs _pool_ext_ref   (the pool with its pre-norm)
    folded_pool_layer  vs _pool_ref       (the resident pool + GroupNorm)
    folded_unpool      vs _unpool_ref     (the unpool)
    fused_mlp_residual vs _mlp_ref        (the residual MLP and its sums)
    fused_h_side       vs _hside_ref      (the inducer side)

A check passes when both are finite and the wrapper's error against the
plain version in fp32 (the same function on fp32 casts of the operands: the
yardstick that tells a wrong kernel from bf16's conditioning) is within
``--ratio`` times the bf16 plain version's own error (floored at ``--tol``
for outputs, ``--gtol`` for gradients) and under 0.5. A wrong kernel is
NaN or off by orders of magnitude; conditioning hits both alike.
``--gains`` multiplies the per-head query-side weights by log-spaced
factors in [1, gain] and scales the stream: gain 1 is init-like, 5 mid
training, 12 late training. Each row (``PASS`` or ``FAIL``, then a JSON
object with the verdict under ``passed``) prints the achieved per-head
logit statistics. The exit code is nonzero on any failure.

``--ema DIR`` (or ``--model-arm``) adds the model arm: the flagship's
loss and gradients on ``folded_pallas`` against ``folded`` (the same
folded algebra in plain PyTorch) at the ``Trainer``'s ``ema.pt`` weights
(DIR holds ``ema.pt``, or is a run directory whose newest checkpoint
does), or at its seeded init.

The JAX script's ``--arms`` is left out: its arms re-run the script under
the TPU kernels' tiling and softmax switches (``GECCO_SOFTMAX_R4``,
``GECCO_TN_UNPOOL``, ``GECCO_PIPELINE_CHUNKS``), which have no
counterpart in the Hopper kernels (ROADMAP B5).

On the CPU (``--cpu``) each wrapper runs its plain version, so the script
checks only itself there; certification needs the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.ops.kernels import hside as hs
from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["FUSED", "PLAIN", "certify", "main", "make_cases", "model_arm"]

GROUPS = 32

# each case's plain version and fused wrapper, by name
PLAIN: Dict[str, Callable] = {
    "pool_ext": lambda *a, h: fa._pool_ext_ref(*a, h),
    "pool_layer": lambda *a, h: fa._pool_ref(*a, GROUPS, h)[0],
    "unpool": lambda *a, h: fa._unpool_ref(*a, h, True, True),
    "mlp": lambda *a, h: fa._mlp_ref(*a),
    "hside": lambda *a, h: hs._hside_ref(*a[:5], fa.group_indicator(a[0].shape[-1], GROUPS,
                                                                       a[0].device), *a[5:]),
}
FUSED: Dict[str, Callable] = {
    "pool_ext": lambda *a, h: fa.folded_pool_ext(*a, h),
    "pool_layer": lambda *a, h: fa.folded_pool_layer(
        *a[:6], fa.group_indicator(a[0].shape[-1], GROUPS, a[0].device), h)[0],
    "unpool": lambda *a, h: fa.folded_unpool(*a, h, True, True),
    "mlp": lambda *a, h: fa.fused_mlp_residual(*a),
    "hside": lambda *a, h: hs.fused_h_side(*a[:5], fa.group_indicator(a[0].shape[-1], GROUPS,
                                                                        a[0].device), *a[5:]),
}


def _rel_err(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def _numpy(tree) -> list:
    return [x.detach().float().cpu().numpy() for x in _leaves(tree)]


def _finite(arrays) -> bool:
    return all(bool(np.isfinite(a).all()) for a in arrays)


def _head_factors(rng: np.random.Generator, num_heads: int, gain: float) -> np.ndarray:
    """Per-head drift factors, log-spaced over [1, gain], shuffled."""
    f = np.logspace(0.0, np.log10(max(gain, 1.0)), num_heads)
    rng.shuffle(f)
    return np.asarray(f, np.float32)


def _logit_stats(logits, num_heads: int) -> dict:
    """[B, N, H*I] or [B, N, H, I] logits -> the spread of the per-head
    maxima, the largest within-head range and the largest magnitude."""
    lf = np.asarray(logits.detach().float().cpu() if isinstance(logits, torch.Tensor) else logits,
                    np.float32)
    if lf.ndim == 3:
        b, n, j = lf.shape
        lf = lf.reshape(b, n, num_heads, j // num_heads)
    hmax = lf.max(axis=(0, 1, 3))  # [H]
    hmin = lf.min(axis=(0, 1, 3))
    return {
        "head_max_spread": float(hmax.max() - hmax.min()),
        "within_head_range_max": float((hmax - hmin).max()),
        "abs_max": float(np.abs(lf).max()),
    }


def make_cases(batch, n_points, c, num_inducers, num_heads, width, gain, seed, device) -> dict:
    """Each kernel's operands at a drift profile: {name: (primals,
    logit statistics)}, the operands drawn on the CPU from ``seed`` and
    moved to ``device``."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    b, n, i, h = batch, n_points, num_inducers, num_heads
    d = c // h
    j = h * i

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def uniform(*shape, lo=0.5, hi=1.5):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    # the residual stream grows with training; gain scales its std too
    x_std = 1.0 + 0.15 * gain
    x = (randn(b, n, c) * x_std).to(bf)
    # the pre-norm's affine: se ~ AdaGN inv_std * scale (drifting with
    # gain), be a modest shift
    se = uniform(b, c) * (1.0 + 0.1 * gain) / x_std
    be = 0.2 * randn(b, c)
    hf = torch.from_numpy(_head_factors(rng, h, gain))
    cases = {}

    ind2 = (randn(j, d) * hf.repeat_interleave(i)[:, None]).to(bf)
    kvw = (randn(2 * c, c) / math.sqrt(c)).to(bf)
    wo = (randn(c, c) / math.sqrt(c)).to(bf)
    y = (x.float() * se[:, None, :] + be[:, None, :]).to(bf)
    bs = min(4, b)  # the logit statistics on a slice: diagnostics only
    pool_logits = torch.einsum("bnc,cj->bnj", y[:bs].float(), fa.fold_qf(ind2, kvw, h).float())
    pool_stats = _logit_stats(pool_logits, h)
    cases["pool_ext"] = ((x, se, be, ind2, kvw, wo), pool_stats)
    # the GroupNorm pre-norm variant; its group indicator is a constant the
    # case functions close over
    cases["pool_layer"] = ((x, se * x_std, be, ind2, kvw, wo), pool_stats)

    kk = (randn(b, i, c).reshape(b, i, h, d) * hf[None, None, :, None]).reshape(b, i, c).to(bf)
    vv = randn(b, i, c).to(bf)
    wq = (randn(c, c) / math.sqrt(c)).to(bf)
    wou = (randn(c, c) / math.sqrt(c)).to(bf)
    kfm = torch.einsum("hdc,bihd->bchi", wq.float().reshape(h, d, c),
                       kk[:bs].float().reshape(bs, i, h, d)).reshape(bs, c, j) / math.sqrt(d)
    unpool_logits = torch.einsum("bnc,bcj->bnj", y[:bs].float(), kfm)
    cases["unpool"] = ((x, se, be, kk, vv, wq, wou), _logit_stats(unpool_logits, h))

    w1t = (randn(c, width) / math.sqrt(c) * (1.0 + 0.2 * gain)).to(bf)
    b1 = 0.1 * randn(1, width)
    w2t = (randn(width, c) / math.sqrt(width)).to(bf)
    b2 = 0.1 * randn(1, c)
    cases["mlp"] = ((x, se, be, w1t, b1, w2t, b2), {})

    h0 = (randn(b, i, c) * x_std).to(bf)
    s2 = uniform(b, c) * (1.0 + 0.1 * gain)
    b2n = 0.2 * randn(b, c)
    wk = (randn(c, c) / math.sqrt(c) * hf.repeat_interleave(d)[:, None]).to(bf)
    wv = (randn(c, c) / math.sqrt(c)).to(bf)
    cases["hside"] = ((h0, se, be, s2, b2n, w1t, b1, w2t, b2, wk, wv), {})
    return {k: (tuple(p.to(device) for p in primals), stats)
            for k, (primals, stats) in cases.items()}


def run_value_and_grad(fn: Callable, primals: Sequence[torch.Tensor], cot_seed: int) -> tuple:
    """The outputs and the gradients into every primal under one
    cotangent per output, standard normal from ``cot_seed`` truncated to
    bf16 (the same draw for every arm)."""
    primals = [p.detach().requires_grad_(True) for p in primals]
    with torch.enable_grad():
        outs = _leaves(fn(*primals))
        cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(cot_seed))
                .to(torch.bfloat16).to(o.dtype).to(o.device) for o in outs]
        grads = torch.autograd.grad(outs, primals, cots, allow_unused=True)
    return _numpy(outs), _numpy([torch.zeros_like(p) if gr is None else gr
                                 for p, gr in zip(primals, grads)])


def _fp32(primals) -> tuple:
    return tuple(p.float() if p.dtype == torch.bfloat16 else p for p in primals)


def certify(args, device) -> int:
    """The kernels' checks at every gain and seed; returns the number of
    failures."""
    t0 = time.time()
    results, failures = [], 0
    only = set(args.only.split(",")) if args.only else None
    for gain in args.gains:
        for seed in range(args.seeds):
            cases = make_cases(args.batch, args.n_points, args.width_c, args.inducers,
                               args.heads, args.mlp_width, gain, seed, device)
            for name, (primals, lstats) in cases.items():
                if only and name not in only:
                    continue
                fused = lambda *a, f=FUSED[name]: f(*a, h=args.heads)
                plain = lambda *a, f=PLAIN[name]: f(*a, h=args.heads)
                fo, fg = run_value_and_grad(fused, primals, 1000 + seed)
                to, tg = run_value_and_grad(plain, primals, 1000 + seed)
                xo, xg = run_value_and_grad(plain, _fp32(primals), 1000 + seed)
                fin_f, fin_t = _finite(fo + fg), _finite(to + tg)
                e_fo = max(_rel_err(a, b) for a, b in zip(fo, xo))
                e_to = max(_rel_err(a, b) for a, b in zip(to, xo))
                e_fg = max(_rel_err(a, b) for a, b in zip(fg, xg))
                e_tg = max(_rel_err(a, b) for a, b in zip(tg, xg))
                ok = (fin_f and fin_t
                      and e_fo <= args.ratio * max(e_to, args.tol) and e_fo <= 0.5
                      and e_fg <= args.ratio * max(e_tg, args.gtol) and e_fg <= 0.5)
                failures += not ok
                rec = {"kernel": name, "gain": gain, "seed": seed, "finite_fused": fin_f,
                       "finite_twin": fin_t, "err_out_fused": round(e_fo, 6),
                       "err_out_twin": round(e_to, 6), "err_grad_fused": round(e_fg, 6),
                       "err_grad_twin": round(e_tg, 6), "passed": ok, **lstats}
                results.append(rec)
                print(("PASS " if ok else "FAIL ") + json.dumps(rec), flush=True)
    print(f"[certify] {len(results)} checks, {failures} failures, {time.time() - t0:.0f}s",
          flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return failures


def _ema_path(path: str) -> str:
    if os.path.isfile(os.path.join(path, "ema.pt")):
        return os.path.join(path, "ema.pt")
    from gecco_tpu_torch.config import latest_checkpoint

    return os.path.join(latest_checkpoint(path), "ema.pt")


def model_arm(args, device) -> int:
    """The flagship's loss and gradients, ``folded_pallas`` against
    ``folded``, at the EMA weights of ``args.ema`` (or the seeded init);
    returns the number of failures."""
    from gecco_tpu_torch import Diffusion, GaussianReparam, LogUniformSchedule
    from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork

    gen = torch.Generator().manual_seed(7)
    backbone = SetTransformer(args.layers, args.width_c, args.inducers, embed_dim=1,
                              num_heads=args.heads, compute_dtype=torch.bfloat16,
                              attn_impl="folded_pallas", device=device, generator=gen)
    net = UnconditionalPointNetwork(backbone, args.width_c, device=device, generator=gen)
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=64)
    model = Diffusion(net, sched, reparam=GaussianReparam([0.0] * 3, [0.35] * 3, device=device))
    if args.ema:
        path = _ema_path(args.ema)
        model.load_state_dict(torch.load(path, map_location=device))
        print(f"[certify] model arm: EMA weights from {path}", flush=True)
    pts = 0.35 * torch.randn((args.batch, args.n_points, 3),
                             generator=torch.Generator().manual_seed(11)).to(device)
    sigma, noise = model.draw_sigma_noise(torch.Generator().manual_seed(3), pts)

    def loss_and_grads(impl):
        model.network.backbone.attn_impl = impl
        model.zero_grad(set_to_none=True)
        loss = model.loss_from(pts, sigma, noise)
        loss.backward()
        return float(loss.detach()), [p.grad.detach().float().cpu().numpy() if p.grad is not None
                             else np.zeros(tuple(p.shape), np.float32)
                             for p in model.parameters()]

    lf, gf = loss_and_grads("folded_pallas")
    lt, gt = loss_and_grads("folded")
    model.network.backbone.attn_impl = "folded_pallas"
    fin = _finite([np.asarray([lf, lt])] + gf + gt)
    le = abs(lf - lt) / max(abs(lt), 1e-6)
    ge = max((_rel_err(a, b) if b.size and np.abs(b).max() > 1e-4 else 0.0)
             for a, b in zip(gf, gt))
    ok = fin and le <= args.tol and ge <= args.model_gtol
    rec = {"kernel": "MODEL", "loss_fused": lf, "loss_twin": lt, "finite": fin,
           "rel_err_loss": round(le, 6), "rel_err_grad": round(ge, 6), "passed": ok}
    print(("PASS " if ok else "FAIL ") + json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0 if ok else 1


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gains", type=float, nargs="+", default=[1.0, 5.0, 12.0],
                    help="drift profiles: 1 init-like (per-head logit |max| ~6), 5 mid "
                    "training (~50), 12 late training (~150)")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--n-points", type=int, default=2048)
    ap.add_argument("--width-c", type=int, default=384)
    ap.add_argument("--inducers", type=int, default=64)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--mlp-width", type=int, default=768)
    ap.add_argument("--tol", type=float, default=1e-2,
                    help="floor of the plain bf16 version's output error in the ratio test")
    ap.add_argument("--gtol", type=float, default=3e-2,
                    help="floor of the plain bf16 version's gradient error")
    ap.add_argument("--ratio", type=float, default=8.0,
                    help="the wrapper's error against the fp32 plain version may exceed the "
                    "bf16 plain version's by at most this factor (and never 0.5)")
    ap.add_argument("--model-gtol", type=float, default=0.15,
                    help="the model arm's gradient tolerance")
    ap.add_argument("--only", default="", help="a comma list of kernels to check")
    ap.add_argument("--model-arm", action="store_true")
    ap.add_argument("--ema", default="",
                    help="a checkpoint dir holding ema.pt, or a run dir, for the model arm")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--out", default="", help="append the rows as JSON lines here")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, where every wrapper is its plain version: checks "
                    "the script, certifies nothing")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The certifier; returns its exit code (1 on any failure)."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    failures = certify(args, device)
    if args.model_arm or args.ema:
        failures += model_arm(args, device)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
