"""The projective gather's Hopper and SIMT bodies side by side.

    python3 -m gecco_tpu_torch.probes.gather            # checks and times
    python3 -m gecco_tpu_torch.probes.gather --quick    # checks only
    PYTHONPATH=TREE python3 gecco_tpu_torch/probes/gather.py --host-only

At the image-conditional model's pyramid (256^2 images: levels of 64^2,
32^2 and 16^2 pixels and C 96, 192, 384; batch 48, 2048 points) on two
coordinate sets, uniform in [-0.1, 1.1] and the model's own
(``UVLReparam.diffusion_to_hw`` of ``make_conditional_batch``'s clean
clouds, which crowd onto the objects' silhouettes), this holds the Hopper
forward bit for bit against the SIMT body, and both bodies' backwards
against autograd of the plain version run in fp32 on the same inputs (the
Hopper body's outputs the same bits in two calls). It then times the two
bodies of each in turns (CUDA events around each call), reads their device
time by launch (``torch.profiler``) and the host's time to make one call.
``--host-only`` reads only the host's time to make one forward and one
backward through the public wrappers, with whatever package ``PYTHONPATH``
points at (a parent tree's, for a before and after). Prints the card's name and power limit and one
JSON line; raises after printing if a check fails. Needs the card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import time
import types

import numpy as np
import torch

# the module (the package's attribute of that name is the wrapper function)
pg = importlib.import_module("gecco_tpu_torch.ops.kernels.projective_gather")

B, N, IMAGE = 48, 2048, 256
CTX_DIMS = (96, 192, 384)


def levels_of(gen, b, image_size, device, dt=torch.bfloat16):
    """The ConvNeXt-tiny pyramid's shapes for ``image_size``^2 images
    (strides 4, 8, 16; VALID convolutions, so 137 gives 34, 17, 8),
    standard normal features."""
    levels, size = [], (image_size - 4) // 4 + 1
    for c in CTX_DIMS:
        levels.append(torch.randn(b, size, size, c, generator=gen, device=device).to(dt))
        size = (size - 2) // 2 + 1
    return levels


def uniform_hw01(gen, b, n, device):
    """hw01 uniform in [-0.1, 1.1], so that corners fall outside the image
    on every side."""
    return -0.1 + 1.2 * torch.rand(b, n, 2, generator=gen, device=device)


def model_hw01(b, n, device, seed=0):
    """The coordinates the conditional model hands the gather for clean
    clouds: ``diffusion_to_hw`` of ``make_conditional_batch``'s points taken
    to diffusion space by the model's ``UVLReparam``."""
    from gecco_tpu_torch.data.procedural import make_conditional_batch
    from gecco_tpu_torch.reparam import UVLReparam

    pts, _, K = make_conditional_batch(np.random.default_rng(seed), b, n, image_size=8)
    reparam = UVLReparam(device=device)
    ctx = types.SimpleNamespace(K=torch.from_numpy(K).to(device))
    x = reparam.data_to_diffusion(torch.from_numpy(pts).to(device), ctx)
    return reparam.diffusion_to_hw(x, ctx.K).float().contiguous()


def rel(a, ref) -> float:
    a, ref = a.float(), ref.float()
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def check_bodies(levels, hw01, cot) -> dict:
    """The two bodies on one operand set: whether the forwards are the same
    bits; each forward's error against the plain version; each backward's
    error per output (dF per level, d hw01) against autograd of the plain
    version in fp32; whether the Hopper backward gives the same bits in two
    calls, with and without the coordinate gradient."""
    with torch.no_grad():
        hop, simt = pg._gather_hopper(hw01, levels), pg._gather_simt(hw01, levels)
        want = pg._gather_ref(hw01, *levels)
    d_h = pg._gather_bwd_hopper(levels, hw01, cot, True)
    d_h2 = pg._gather_bwd_hopper(levels, hw01, cot, True)
    d_only = pg._gather_bwd_hopper(levels, hw01, cot, False)
    d_only2 = pg._gather_bwd_hopper(levels, hw01, cot, False)
    d_s = pg._gather_bwd_simt(levels, hw01, cot, True)
    ref = pg._gather_bwd_ref([lv.float() for lv in levels], hw01, cot.float())
    torch.cuda.synchronize()
    errs = lambda d: {**{f"dF{q}": rel(a, r) for q, (a, r) in enumerate(zip(d[1], ref[1]))},
                      "dhw01": rel(d[0], ref[0])}
    abs_err = lambda d: max(float((a.float() - r).abs().max()) for a, r in zip(d[1], ref[1]))
    return dict(
        fwd_equal=torch.equal(hop, simt), fwd_err=rel(hop, want), fwd_err_simt=rel(simt, want),
        fwd_abs_err=float((hop.float() - want.float()).abs().max()),
        bwd_same_bits=(torch.equal(d_h[0], d_h2[0])
                       and all(torch.equal(a, b) for a, b in zip(d_h[1], d_h2[1]))
                       and all(torch.equal(a, b) for a, b in zip(d_only[1], d_only2[1]))),
        bwd_only_equal=all(torch.equal(a, b) for a, b in zip(d_only[1], d_h[1])),
        bwd_err=errs(d_h), bwd_err_simt=errs(d_s), bwd_abs_err=abs_err(d_h),
        bwd_abs_err_simt=abs_err(d_s))


def timed(fn, reps) -> list:
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def in_turns(new, old, reps=20) -> dict:
    """Two bodies timed in turns (old, new, new, old; ``reps`` / 2 calls
    each, after one warm-up call of each) -> sorted ms per body."""
    new(), old()
    half = max(1, reps // 2)
    t_old = timed(old, half)
    t_new = timed(new, half) + timed(new, half)
    return {"new": sorted(t_new), "old": sorted(t_old + timed(old, half))}


def device_split(fn, n=5) -> dict:
    """Device milliseconds per call of each kernel ``fn`` launches
    (``torch.profiler``, the device's own events)."""
    from gecco_tpu_torch.probes.pool_bwd import launch_split

    return launch_split(fn, n)


def host_ms(fn, reps=40) -> float:
    """Median host milliseconds to make one call, the card idle before
    each."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return sorted(out)[reps // 2]


def med(t) -> float:
    return (t[(len(t) - 1) // 2] + t[len(t) // 2]) / 2


def time_bodies(levels, hw01, cot, reps=20) -> dict:
    """Each function's two bodies in turns on one operand set: the forward,
    the backward as the train step calls it (dF only) and with the
    coordinate gradient; event ms (median, min, max), device ms per call by
    launch, host ms to make one call."""
    fns = {
        "forward": (lambda: pg._gather_hopper(hw01, levels),
                    lambda: pg._gather_simt(hw01, levels)),
        "backward": (lambda: pg._gather_bwd_hopper(levels, hw01, cot, False),
                     lambda: pg._gather_bwd_simt(levels, hw01, cot, False)),
        "backward_coords": (lambda: pg._gather_bwd_hopper(levels, hw01, cot, True),
                            lambda: pg._gather_bwd_simt(levels, hw01, cot, True)),
    }
    out = {}
    with torch.no_grad():
        for name, (new, old) in fns.items():
            t = in_turns(new, old, reps)
            s_new, s_old = device_split(new), device_split(old)
            out[name] = {body: dict(ms=med(t[body]), ms_min_max=[t[body][0], t[body][-1]],
                                    device_ms=sum(s.values()), per_launch_ms=s,
                                    host_ms=host_ms(fn))
                         for body, fn, s in (("new", new, s_new), ("old", old, s_old))}
    return out


def host_only(dev) -> dict:
    """The host's time to make one call through the public wrappers (the
    forward under ``no_grad`` as the sampler calls it, the backward dF
    only), with whatever package is imported."""
    gen = torch.Generator(device=dev).manual_seed(0)
    levels = levels_of(gen, B, IMAGE, dev)
    hw01 = uniform_hw01(gen, B, N, dev)
    cot = torch.randn(B, N, sum(CTX_DIMS), generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        fwd = host_ms(lambda: pg.projective_gather(levels, hw01))
    bwd = host_ms(lambda: pg.projective_gather_bwd(levels, hw01, cot, False))
    return dict(forward_host_ms=fwd, backward_host_ms=bwd)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="checks only")
    ap.add_argument("--bwd", action="store_true",
                    help="checks, then only the Hopper backward's times (dF only)")
    ap.add_argument("--host-only", action="store_true",
                    help="only the host's time to make one call of each wrapper")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probes.gather: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    if args.host_only:
        res = host_only(dev)
        print(card)
        print(json.dumps(res))
        return
    gen = torch.Generator(device=dev).manual_seed(0)
    levels = levels_of(gen, B, IMAGE, dev)
    cot = torch.randn(B, N, sum(CTX_DIMS), generator=gen, device=dev).to(torch.bfloat16)
    sets = {"uniform": uniform_hw01(gen, B, N, dev), "model": model_hw01(B, N, dev)}
    failed, result = [], {}
    for name, hw01 in sets.items():
        rec = check_bodies(levels, hw01, cot)
        worse = {k: v for k, v in rec["bwd_err"].items() if v > 1.25 * rec["bwd_err_simt"][k]}
        if not (rec["fwd_equal"] and rec["bwd_same_bits"] and rec["bwd_only_equal"]) or worse:
            failed.append(f"{name}: {rec}")
        errs = lambda key: ", ".join(f"{k} {v:.3e}" for k, v in rec[key].items())
        print(f"  {name} coordinates: forward "
              f"{'the same bits as' if rec['fwd_equal'] else 'DIFFERS from'} the SIMT body "
              f"(against the plain version {rec['fwd_err']:.3e}); backward "
              f"{'the same bits' if rec['bwd_same_bits'] else 'DIFFERENT bits'} in two calls, "
              f"against fp32: Hopper {errs('bwd_err')}; SIMT {errs('bwd_err_simt')}")
        if args.bwd:
            fn = lambda: pg._gather_bwd_hopper(levels, hw01, cot, False)
            fn()
            t = sorted(timed(fn, 20))
            split = device_split(fn)
            # each level alone, its slice of the cotangent
            offs = np.cumsum([0, *CTX_DIMS])
            alone = [device_split(lambda q=q: pg._gather_bwd_hopper(
                [levels[q]], hw01, cot[..., offs[q]:offs[q + 1]].contiguous(), False))
                for q in range(len(levels))]
            # a digest of dF's bits, to compare builds
            digest = sum(int((d.view(torch.int16).long().flatten()
                              * (torch.arange(d.numel(), device=dev) % 9973 + 1)).sum())
                         for d in fn()[1])
            rec["bwd"] = dict(ms=med(t), device_ms=sum(split.values()), per_launch_ms=split,
                              per_level_ms=alone, digest=digest)
            print(f"    Hopper backward (dF only): {med(t):.4f} ms, device "
                  f"{sum(split.values()):.4f} ms (" + ", ".join(f"{k} {v:.4f}"
                                                           for k, v in split.items())
                  + f"); dF digest {digest}; each level alone: " + "; ".join(
                      ", ".join(f"{k} {v:.4f}" for k, v in a.items()) for a in alone))
        elif not args.quick:
            rec["times"] = time_bodies(levels, hw01, cot)
            for fn, bodies in rec["times"].items():
                print(f"    {fn}: " + "; ".join(
                    f"{body} {r['ms']:.4f} ms ({r['ms_min_max'][0]:.4f}-{r['ms_min_max'][1]:.4f}), "
                    f"device {r['device_ms']:.4f} ms ("
                    + ", ".join(f"{k} {v:.4f}" for k, v in r["per_launch_ms"].items())
                    + f"), host {r['host_ms']:.4f} ms" for body, r in bodies.items()))
        result[name] = rec
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.gather: " + "; ".join(failed))


if __name__ == "__main__":
    main()
