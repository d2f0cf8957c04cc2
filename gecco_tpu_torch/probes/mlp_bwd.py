"""The Hopper MLP backward and forward pass by pass, beside the WMMA bodies,
timed and split by launch.

    python3 -m gecco_tpu_torch.probes.mlp_bwd

``csrc/mlp_bwd.cu`` runs the pre-norm, four product passes (a; g' and
bf16(g'); dh; dx) with the fixed-order column sums after three of them
(db2; db1; dse and dbe), and the two weight-gradient products (dw1t,
dw2t); ``csrc/mlp.cu`` the pre-norm, the first of those passes (g) and an
output pass (out and the channel sums). At the flagship's shapes (C 384, W
768; the backward at the training batch 48, the forward at the sampler's
64) and the 8k width (B 2, N 8192, C 768, W 1536), ordinary and with
drifted inputs, this holds each pass's outputs against its plain piece fed
the kernel's own inputs to that pass (so a fault shows in the pass that
makes it), and both bodies of both functions against the plain versions
(the backward against autograd of the plain forward, nonzero sums
cotangents); at the upsample demo's C 128 the same, the backward's passes
in their 128-column instances and the forward whole through its narrow
body (``csrc/mlp_narrow.cu``, the switch's pick there). Every output of the
Hopper backward must be the same bits in two calls. It times both bodies of each function in turns (40 calls each) on
the ordinary operands and splits the Hopper bodies' device time by launch
with ``torch.profiler``. It prints the card's name and power limit and one
JSON line, and raises after printing if a check fails. Needs the card.
"""

from __future__ import annotations

import json
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import launch_split, rel, timed

# (B of the backward, B of the forward, N, C, W)
SHAPES = {"flagship": (48, 64, 2048, 384, 768), "8k width": (2, 2, 8192, 768, 1536),
          "demo": (48, 64, 2048, 128, 256)}
# each pass against its plain piece on the kernel's inputs: bf16 outputs a
# few bf16 steps (2^-8) of their largest value (fp32 sums in other orders
# move roundings); the fp32 outputs (g', the column sums, dw1t, dw2t) sums
# of the same products in other orders
TOL_PASS, TOL_FP32 = 2e-2, 1e-3
# whole functions against their plain versions: chip_smoke.py's TOL_OUT and
# TOL_SUMS (forward), TOL_GRAD and TOL_AFFINE (backward)
TOL_OUT, TOL_SUMS, TOL_GRAD, TOL_AFFINE = 2e-2, 1e-2, 3e-2, 3e-2
OUTS = ("dx", "dse", "dbe", "dw1t", "db1", "dw2t", "db2")


def operands(gen, b, n, c, w, drift, device):
    """MLP operands as ``chip_smoke.py`` draws them (with ``drift``, the
    channels of x scaled by 60, 1, 0.1, 0.01 in turn over eight blocks), and
    the cotangents beside them."""
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    bf = torch.bfloat16
    scale = torch.ones(c, device=device)
    if drift:
        scale = torch.tensor([60.0, 1.0, 0.1, 0.01], device=device).repeat(3)[:8]
        scale = scale.repeat_interleave(c // 8)
    ops = ((r(b, n, c) * scale).to(bf), 1.0 + 0.1 * r(b, c), 0.1 * r(b, c),
           (r(c, w) / c**0.5).to(bf), 0.1 * r(1, w), (r(w, c) / w**0.5).to(bf), 0.1 * r(1, c))
    return ops, (0.1 * r(b, n, c)).to(bf), 1e-3 * r(b, 2, c)


def bwd_passes(ops, g, gs) -> dict:
    """Each pass of the Hopper backward against its plain piece on the
    kernel's own inputs."""
    x, se, be, w1t, b1, w2t, b2 = ops
    mid = {}
    dx, dse, dbe, dw1t, db1, dw2t, db2 = fa._mlp_bwd_hopper(*ops, g, gs, mid)
    y = mid["y"]
    gp, gb, r_db2 = fa._mlp_bwd_grad_ref(x, mid["a"], w2t, b2, g, gs)
    dh, r_db1 = fa._mlp_bwd_dh_ref(y, w1t, b1, w2t, mid["gb"])
    r_dx, r_dse, r_dbe = fa._mlp_bwd_dx_ref(x, se, w1t, mid["dh"], mid["gp"])
    r_dw1t, r_dw2t = fa._mlp_bwd_wgrad_ref(y, mid["a"], mid["dh"], mid["gb"])
    return {"y": rel(y, fa._prenormed(x, se, be).to(x.dtype)),
            "a": rel(mid["a"], fa._mlp_act_ref(y, w1t, b1)), "gp": rel(mid["gp"], gp),
            "gb": rel(mid["gb"], gb), "db2": rel(db2, r_db2), "dh": rel(mid["dh"], dh),
            "db1": rel(db1, r_db1), "dx": rel(dx, r_dx), "dse": rel(dse, r_dse),
            "dbe": rel(dbe, r_dbe), "dw1t": rel(dw1t, r_dw1t), "dw2t": rel(dw2t, r_dw2t)}


def fwd_passes(ops) -> dict:
    """Both passes of the Hopper forward against their plain pieces."""
    x, se, be, w1t, b1, w2t, b2 = ops
    mid = {}
    out, sums = fa._mlp_hopper(*ops, mid)
    r_out, r_sums = fa._mlp_out_ref(x, mid["g"], w2t, b2)
    return {"g": rel(mid["g"], fa._mlp_act_ref(mid["y"], w1t, b1)), "out": rel(out, r_out),
            "sums": rel(sums, r_sums)}


def whole(ops, g, gs, bodies, narrow=False) -> dict:
    """Each body of both functions against the plain versions (with
    ``narrow``, the forward's "hopper" body is the narrow one)."""
    want_f = fa._mlp_ref(*ops)
    want_b = fa._mlp_bwd_ref(*ops, g, gs)
    runs = {"hopper": (fa._mlp_narrow if narrow else fa._mlp_hopper, fa._mlp_bwd_hopper),
            "wmma": (fa._mlp_wmma, fa._mlp_bwd_wmma)}
    out = {}
    for body in bodies:
        fwd, bwd = runs[body]
        f = fwd(*ops)
        e = {"out": rel(f[0], want_f[0]), "sums": rel(f[1], want_f[1])}
        e.update({k: rel(a, r) for k, a, r in zip(OUTS, bwd(*ops, g, gs), want_b)})
        out[body] = e
    return out


def tol_whole(k):
    return {"out": TOL_OUT, "sums": TOL_SUMS, "dse": TOL_AFFINE, "dbe": TOL_AFFINE}.get(k, TOL_GRAD)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.mlp_bwd: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(1)
    result, failed = {}, []

    def hold(tag, errs, tol_of):
        for k, e in errs.items():
            if not e <= tol_of(k):
                failed.append(f"{tag} {k}: {e:.3e}")

    fp32 = ("gp", "db2", "db1", "dse", "dbe", "dw1t", "dw2t", "sums")
    for width, (bb, bf, n, c, w) in SHAPES.items():
        hopper = fa._mlp_bwd_body(bb, n, c, w) == "hopper"
        narrow = fa._mlp_body(bf, n, c, w) == "narrow"
        assert hopper == (fa._mlp_body(bf, n, c, w) in ("hopper", "narrow")), width
        bodies = ("hopper", "wmma") if hopper else ("wmma",)
        for drift in (False, True):
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            ops, g, gs = operands(gen, bb, n, c, w, drift, dev)
            rec = {"whole": whole(ops, g, gs, bodies, narrow)}
            if hopper:
                rec["passes"] = {**bwd_passes(ops, g, gs),
                                 **fwd_passes(operands(gen, bf, n, c, w, drift, dev)[0])}
                hold(tag + " pass", rec["passes"], lambda k: TOL_FP32 if k in fp32 else TOL_PASS)
                print(f"  {tag}: passes against their plain pieces (max|err|/max|ref|): "
                      + ", ".join(f"{k} {v:.3e}" for k, v in rec["passes"].items()))
            for body, e in rec["whole"].items():
                hold(f"{tag} {body}", e, tol_whole)
                print(f"    {body} bodies against the plain versions: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
            result[tag] = rec
        ops, g, gs = operands(gen, bb, n, c, w, False, dev)
        fops = operands(gen, bf, n, c, w, False, dev)[0]
        rec = {}
        if hopper:
            first = fa._mlp_bwd_hopper(*ops, g, gs)
            again = fa._mlp_bwd_hopper(*ops, g, gs)
            same = all(torch.equal(p, q) for p, q in zip(first, again))
            if not same:
                failed.append(f"{width}: the Hopper backward's outputs differ between two calls")
            rec["same_bits"] = same
        for what, runs in (
                ("bwd", {"hopper": lambda: fa.fused_mlp_residual_bwd(*ops, g, gs),
                         "wmma": lambda: fa._mlp_bwd_wmma(*ops, g, gs)}),
                ("fwd", {"hopper": lambda: fa.fused_mlp_residual(*fops),
                         "wmma": lambda: fa._mlp_wmma(*fops)})):
            if not hopper:
                t = sorted(timed(runs["wmma"]) + timed(runs["wmma"]))
                rec[what] = {"wmma_ms": t[len(t) // 2], "wmma_min_max_ms": [t[0], t[-1]]}
                continue
            t_w1, t_h1, t_h2, t_w2 = (timed(runs["wmma"]), timed(runs["hopper"]),
                                      timed(runs["hopper"]), timed(runs["wmma"]))
            th, tw = sorted(t_h1 + t_h2), sorted(t_w1 + t_w2)
            med = lambda t: (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2
            rec[what] = {"hopper_ms": med(th), "hopper_min_max_ms": [th[0], th[-1]],
                         "wmma_ms": med(tw), "wmma_min_max_ms": [tw[0], tw[-1]],
                         "per_launch_ms": launch_split(runs["hopper"])}
        print(f"  {width}: " + "; ".join(
            f"{what} " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in r.items())
            for what, r in rec.items() if isinstance(r, dict)))
        if hopper:
            print(f"  {width}: the Hopper backward's outputs "
                  f"{'the same bits' if rec['same_bits'] else 'DIFFER'} in two calls")
        result[width] = rec
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.mlp_bwd: " + "; ".join(failed))


if __name__ == "__main__":
    main()
