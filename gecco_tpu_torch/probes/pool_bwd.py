"""The Hopper pool backward pass by pass, beside the WMMA body, timed and
split by launch.

    python3 -m gecco_tpu_torch.probes.pool_bwd

``csrc/pool_ext_bwd.cu`` runs the pre-norm, pass 0 (eTy), the fold (tacc,
W3, dWv, dWo), pass 1 (ds, dx, dse, dbe) and the dqf product. At the
flagship's training shapes (B 48, N 2048, C 384, 8 heads), the 8k width
(B 2, N 8192, C 768, 16 heads), the upsample demo's model (B 48, C 128, 4
heads of 32) and three heads at the flagship's width (C 384, 3 heads of
128, J 192), ordinary and with drifted logits, this holds each pass's
outputs against its plain piece fed the kernel's own inputs to that pass
(so a fault shows in the pass that makes it), times the Hopper body and
the WMMA body in turns (40 calls each) on the ordinary operands, and
splits both bodies' device time by launch with ``torch.profiler``. It
prints the card's name and power limit and one JSON line, and raises after
printing if a pass is off its plain piece. Needs the card.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa

SHAPES = {"flagship": (48, 2048, 384, 8, 64), "8k width": (2, 8192, 768, 16, 64),
          "demo": (48, 2048, 128, 4, 64), "three heads": (48, 2048, 384, 3, 64)}
# each pass against its plain piece on the kernel's inputs: bf16 outputs
# (eTy, W3, ds, dx) a few bf16 steps (2^-8) of their largest value; fp32
# sums of the same bf16 products (tacc, dWv, dWo, dqf) to rounding; the
# column sums dse, dbe at chip_smoke.py's TOL_AFFINE (the drifted dbe is a
# residue of cancelling terms)
TOL_PASS, TOL_SUM, TOL_AFFINE = 2e-2, 1e-3, 3e-2


def operands(g, b, n, c, heads, i, drift, device):
    """Pool operands as ``chip_smoke.py`` draws them: with ``drift``, the
    k rows of each head scaled by 60, 1, 0.1, 0.01 in turn."""
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    d = c // heads
    kvw = r(2 * c, c) / c**0.5
    if drift:
        scale = torch.tensor([60.0, 1.0, 0.1, 0.01], device=device)
        kvw[:c] *= scale.repeat(heads // 4 + 1)[:heads].repeat_interleave(d)[:, None]
    se = torch.ones(b, c, device=device) if drift else 1.0 + 0.1 * r(b, c)
    be = torch.zeros(b, c, device=device) if drift else 0.1 * r(b, c)
    bf = torch.bfloat16
    return (r(b, n, c).to(bf), se, be, r(heads * i, d).to(bf), kvw.to(bf),
            (r(c, c) / c**0.5).to(bf))


def rel(a, ref) -> float:
    a, ref = a.float(), ref.float()
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def passes(ops, heads, g) -> dict:
    """Each pass against its plain piece on the kernel's own inputs."""
    x, se, be, _, kvw, wo = ops
    _, qft, macc, sacc = fa._pool_ext_launch(*ops, heads, True)
    gh = (0.1 * torch.randn(x.shape[0], qft.shape[0] // heads, x.shape[2], generator=g,
                            device=x.device)).to(x.dtype)
    dx, dse, dbe, dqf, dwv, dwo, mid = fa._pool_ext_bwd_hopper(*ops[:3], qft, kvw, wo, gh, macc,
                                                               sacc, heads)
    tacc, w3, r_dwv, r_dwo = fa._pool_bwd_fold_ref(mid["ety"], gh, kvw, wo, sacc, heads)
    r_dx, r_dse, r_dbe, r_ds = fa._pool_bwd_dy_ref(x, se, be, qft, mid["w3"], macc, mid["tacc"])
    return {
        "ety": rel(mid["ety"], fa._pool_bwd_ety_ref(x, se, be, qft, macc)),
        "tacc": rel(mid["tacc"], tacc), "w3": rel(mid["w3"], w3), "dwv": rel(dwv, r_dwv),
        "dwo": rel(dwo, r_dwo), "ds": rel(mid["ds"], r_ds), "dx": rel(dx, r_dx),
        "dse": rel(dse, r_dse), "dbe": rel(dbe, r_dbe),
        "dqf": rel(dqf, fa._pool_bwd_dqf_ref(x, se, be, mid["ds"])),
    }, (qft, macc, sacc, gh)


def timed(fn, reps=20) -> list:
    fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def launch_split(fn, n=5) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            ids = [m for m in re.findall(r"(\w+)(?:<[^()]*>)?\(", evt.key) if m != "void"]
            name = ids[0] if ids else evt.key
            split[name] = split.get(name, 0.0) + evt.self_device_time_total / 1e3 / n
    return split


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.pool_bwd: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(1)
    result, failed = {}, []
    tol = lambda k: (TOL_PASS if k in ("ety", "w3", "ds", "dx")
                     else TOL_AFFINE if k in ("dse", "dbe") else TOL_SUM)
    for width, (b, n, c, heads, i) in SHAPES.items():
        assert fa._pool_ext_bwd_body(b, n, c, heads, i) == "hopper", width
        for drift in (False, True):
            ops = operands(g, b, n, c, heads, i, drift, dev)
            errs, (qft, macc, sacc, gh) = passes(ops, heads, g)
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            print(f"  {tag}: each pass against its plain piece (max|err|/max|ref|): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            failed += [f"{tag} {k}: {e:.3e}" for k, e in errs.items() if not e <= tol(k)]
            result[tag] = {"passes": errs}
            if not drift:
                case = (ops, qft, macc, sacc, gh)
        ops, qft, macc, sacc, gh = case
        x, se, be, _, kvw, wo = ops
        hopper = lambda: fa.folded_pool_ext_bwd(*ops, qft, macc, sacc, gh, heads)
        wmma = lambda: fa._pool_ext_bwd_wmma(x, se, be, qft, kvw, wo, gh, macc, sacc, heads)
        t_w1, t_h1, t_h2, t_w2 = timed(wmma), timed(hopper), timed(hopper), timed(wmma)
        th, tw = sorted(t_h1 + t_h2), sorted(t_w1 + t_w2)
        split, split_w = launch_split(hopper), launch_split(wmma)
        print(f"  {width}: Hopper body median {statistics.median(th):.3f} ms of {len(th)} (min "
              f"{th[0]:.3f}, max {th[-1]:.3f}); WMMA body {statistics.median(tw):.3f} (min "
              f"{tw[0]:.3f}, max {tw[-1]:.3f}); device time a call: Hopper "
              f"{sum(split.values()):.3f}, WMMA {sum(split_w.values()):.3f}; Hopper per launch "
              f"(ms): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        result[width] = {"median_ms": statistics.median(th), "min_max_ms": [th[0], th[-1]],
                         "wmma_ms": statistics.median(tw), "wmma_min_max_ms": [tw[0], tw[-1]],
                         "per_launch_ms": split, "wmma_per_launch_ms": split_w}
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.pool_bwd: " + "; ".join(failed))


if __name__ == "__main__":
    main()
