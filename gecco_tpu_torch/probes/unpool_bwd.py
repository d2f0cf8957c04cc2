"""The Hopper unpool backward pass by pass, beside the WMMA body, timed and
split by launch.

    python3 -m gecco_tpu_torch.probes.unpool_bwd

``csrc/unpool_bwd.cu`` runs the fold (kft, vf), the pre-norm, the heads
kernel twice (p, then ds), the rows kernel twice (d_attn, then dx, dse,
dbe) and the weight-gradient products (dkf, dvf). At the flagship's
training shapes (B 48, N 2048, C 384, 8 heads), the 8k width (B 2, N 8192,
C 768, 16 heads), the upsample demo's model (B 48, C 128, 4 heads) and
three heads at the flagship's width (C 384, 3 heads of 128: J 192, whose
last block of four heads reaches past the tensor's end and whose dvf
takes the weight gradients' 64-row tail), ordinary and with drifted
logits, this holds each pass's outputs against its plain piece fed the
kernel's own inputs to that pass (so a fault shows in the pass that makes
it), and the whole backward of both bodies against
autograd of the plain version; the flag variants (residual, prenorm) at
the flagship's shapes; dkf and dvf the same bits in two calls. It times
both bodies in turns (40 calls each) on the ordinary operands and splits
the Hopper body's device time by launch with ``torch.profiler``. It
prints the card's name and power limit and one JSON line, and raises after
printing if a check fails. Needs the card.
"""

from __future__ import annotations

import json
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import launch_split, rel, timed

SHAPES = {"flagship": (48, 2048, 384, 8, 64), "8k width": (2, 8192, 768, 16, 64),
          "demo": (48, 2048, 128, 4, 64), "three heads": (48, 2048, 384, 3, 64)}
# each pass against its plain piece on the kernel's inputs: bf16 outputs a
# few bf16 steps (2^-8) of their largest value (sums in other orders move
# roundings); dkf and dvf fp32 sums of the same bf16 products
TOL_PASS, TOL_WGRAD = 2e-2, 1e-3
# the whole backward against autograd of the plain version: chip_smoke.py's
# TOL_GRAD and TOL_AFFINE
TOL_GRAD, TOL_AFFINE = 3e-2, 3e-2
OUTS = ("dx", "dse", "dbe", "dk", "dv", "dwq", "dwo")


def operands(g, b, n, c, heads, i, drift, device):
    """Unpool operands as ``chip_smoke.py`` draws them: with ``drift``, the
    k rows of each head scaled by 60, 1, 0.1, 0.01 in turn; the cotangents
    beside them."""
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    bf = torch.bfloat16
    se = torch.ones(b, c, device=device) if drift else 1.0 + 0.1 * r(b, c)
    be = torch.zeros(b, c, device=device) if drift else 0.1 * r(b, c)
    scale = torch.ones(c, device=device)
    if drift:
        pattern = torch.tensor([60.0, 1.0, 0.1, 0.01], device=device)
        scale = pattern.repeat(heads // 4 + 1)[:heads].repeat_interleave(c // heads)
    ops = (r(b, n, c).to(bf), se, be, (r(b, i, c) * scale).to(bf), r(b, i, c).to(bf),
           (r(c, c) / c**0.5).to(bf), (r(c, c) / c**0.5).to(bf))
    return ops, (0.1 * r(b, n, c)).to(bf), 1e-3 * r(b, 2, c)


def passes(ops, g, gs, heads, residual=True, prenorm=True) -> dict:
    """Each pass of the Hopper body against its plain piece on the kernel's
    own inputs."""
    x, se, be, k, v, wq, wo = ops
    mid = {}
    dx, dse, dbe, dkf, dvf = fa._unpool_bwd_hopper(*ops, g, gs, heads, residual, prenorm, mid)
    kft, vf = fa._unpool_bwd_fold_ref(k, v, wq, wo, heads)
    p, ds, da, r_dx, r_dse, r_dbe = fa._unpool_bwd_tiles_ref(x, se, be, mid["kft"], mid["vf"], g,
                                                             gs, heads, residual, prenorm)
    r_dkf, r_dvf = fa._unpool_bwd_wgrad_ref(x, se, be, mid["p"], mid["ds"], mid["d_attn"],
                                            prenorm)
    errs = {"kft": rel(mid["kft"], kft), "vf": rel(mid["vf"], vf), "p": rel(mid["p"], p),
            "d_attn": rel(mid["d_attn"], da), "ds": rel(mid["ds"], ds), "dx": rel(dx, r_dx),
            "dkf": rel(dkf.reshape(r_dkf.shape), r_dkf), "dvf": rel(dvf.reshape(r_dvf.shape), r_dvf)}
    if prenorm:
        errs.update(dse=rel(dse, r_dse), dbe=rel(dbe, r_dbe))
    return errs


def whole(ops, g, gs, heads, residual=True, prenorm=True) -> dict:
    """Both bodies' gradients against autograd of the plain version."""
    want = fa._unpool_bwd_ref(*ops, g, gs, heads, residual, prenorm)
    out = {}
    for body, run in (("hopper", fa._unpool_bwd_hopper), ("wmma", fa._unpool_bwd_wmma)):
        dx, dse, dbe, dkf, dvf = run(*ops, g, gs, heads, residual, prenorm)
        got = (dx, dse, dbe, *fa._chain_unpool(dkf, dvf, *ops[3:], heads))
        out[body] = {k: rel(a, r) for k, a, r in zip(OUTS, got, want)
                     if prenorm or k not in ("dse", "dbe")}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.unpool_bwd: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(1)
    result, failed = {}, []

    def hold(tag, errs, tol_of):
        for k, e in errs.items():
            if not e <= tol_of(k):
                failed.append(f"{tag} {k}: {e:.3e}")

    for width, (b, n, c, heads, i) in SHAPES.items():
        assert fa._unpool_bwd_body(b, n, c, heads, i) == "hopper", width
        for drift in (False, True):
            ops, g, gs = operands(gen, b, n, c, heads, i, drift, dev)
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            errs = passes(ops, g, gs, heads)
            hold(tag + " pass", errs, lambda k: TOL_WGRAD if k in ("dkf", "dvf") else TOL_PASS)
            both = whole(ops, g, gs, heads)
            for body, e in both.items():
                hold(f"{tag} {body}", e, lambda k: TOL_AFFINE if k in ("dse", "dbe") else TOL_GRAD)
            print(f"  {tag}: passes against their plain pieces (max|err|/max|ref|): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            for body, e in both.items():
                print(f"    {body} body against the plain backward: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
            result[tag] = {"passes": errs, "whole": both}
        ops, g, gs = operands(gen, b, n, c, heads, i, False, dev)
        first = fa._unpool_bwd_hopper(*ops, g, gs, heads, True, True)
        again = fa._unpool_bwd_hopper(*ops, g, gs, heads, True, True)
        same = torch.equal(first[3], again[3]) and torch.equal(first[4], again[4])
        if not same:
            failed.append(f"{width}: dkf/dvf differ between two calls")
        hopper = lambda: fa.folded_unpool_bwd(*ops, g, gs, heads)
        wmma = lambda: fa._unpool_bwd_wmma(*ops, g, gs, heads, True, True)
        t_w1, t_h1, t_h2, t_w2 = timed(wmma), timed(hopper), timed(hopper), timed(wmma)
        th, tw = sorted(t_h1 + t_h2), sorted(t_w1 + t_w2)
        med = lambda t: (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2
        split = launch_split(hopper)
        print(f"  {width}: Hopper body median {med(th):.3f} ms of {len(th)} (min {th[0]:.3f}, "
              f"max {th[-1]:.3f}); WMMA body {med(tw):.3f} (min {tw[0]:.3f}, max {tw[-1]:.3f}); "
              f"dkf/dvf {'the same bits' if same else 'DIFFER'} in two calls; Hopper per launch "
              f"(ms): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        result[width] = {"hopper_ms": med(th), "hopper_min_max_ms": [th[0], th[-1]],
                         "wmma_ms": med(tw), "wmma_min_max_ms": [tw[0], tw[-1]],
                         "per_launch_ms": split}
    b, n, c, heads, i = SHAPES["flagship"]
    for residual, prenorm in ((False, False), (True, False), (False, True)):
        ops, g, gs = operands(gen, b, n, c, heads, i, False, dev)
        tag = f"flagship, residual={residual}, prenorm={prenorm}"
        errs = passes(ops, g, gs, heads, residual, prenorm)
        both = whole(ops, g, gs, heads, residual, prenorm)
        hold(tag + " pass", errs, lambda k: TOL_WGRAD if k in ("dkf", "dvf") else TOL_PASS)
        for body, e in both.items():
            hold(f"{tag} {body}", e, lambda k: TOL_AFFINE if k in ("dse", "dbe") else TOL_GRAD)
        print(f"  {tag}: passes " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + "; Hopper body whole " + ", ".join(f"{k} {v:.3e}"
                                                  for k, v in both["hopper"].items()))
        result[tag] = {"passes": errs, "whole": both}
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.unpool_bwd: " + "; ".join(failed))


if __name__ == "__main__":
    main()
