"""The Hopper h-side pass by pass, beside its WMMA body, timed and split by
launch.

    python3 -m gecco_tpu_torch.probes.hside

``csrc/hside.cu`` runs norm_1, the act product (g), the out product (hh and
its 16-row slab sums), norm_2 and the [k | v] product, each over all B I
token rows. At the flagship's shapes (B 64, I 64, C 384, W 768; and B 48,
the train step's), the 8k width (B 2, C 768, W 1536), the upsample demo's C
128 and at 16, 32, 48 and 128 inducers, ordinary and with drifted tokens,
this holds each pass's output against its plain piece fed the kernel's own
inputs to that pass, and the whole function against the plain version; every
output must be the same bits in two calls. It times the Hopper body and,
where it takes the shape, the WMMA body in turns (40 calls each, CUDA
events around each wrapper call) and splits the Hopper body's device time
by launch with ``torch.profiler``; beside them the host's time to launch one
call of each body. It prints the card's name and power
limit and one JSON line, and raises after printing if a check fails. Needs
the card.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.ops.kernels import hside as hs
from gecco_tpu_torch.probes.pool_bwd import launch_split, rel, timed

# (B, I, C, W)
SHAPES = {"flagship": (64, 64, 384, 768), "flagship, B 48": (48, 64, 384, 768),
          "8k width": (2, 64, 768, 1536), "demo": (48, 64, 128, 256),
          "I 16": (64, 16, 384, 768), "I 32": (64, 32, 384, 768), "I 48": (64, 48, 384, 768),
          "I 128": (64, 128, 384, 768)}
GROUPS = 32
# each pass against its plain piece on the kernel's inputs: bf16 outputs
# a few bf16 steps (2^-8) of their largest value; the fp32 hh and slab
# sums sums of the same products in other orders
TOL_PASS, TOL_FP32 = 2e-2, 1e-3
# the whole function against its plain version: chip_smoke.py's TOL_OUT
TOL_OUT = 2e-2


def operands(gen, b, i, c, w, drift, device):
    """The h-side's operands as ``chip_smoke.py`` draws them (with
    ``drift``, the tokens' channels scaled by 60, 1, 0.1, 0.01 in turn over
    eight blocks)."""
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    bf = torch.bfloat16
    scale = torch.ones(c, device=device)
    if drift:
        scale = torch.tensor([60.0, 1.0, 0.1, 0.01], device=device).repeat(2)
        scale = scale.repeat_interleave(c // 8)
    aff = [1.0 + 0.2 * r(b, c), 0.2 * r(b, c), 1.0 + 0.2 * r(b, c), 0.2 * r(b, c)]
    return ((r(b, i, c) * scale).to(bf), *aff, fa.group_indicator(c, GROUPS, device),
            (r(c, w) / c**0.5).to(bf), 0.1 * r(1, w), (r(w, c) / w**0.5).to(bf), 0.1 * r(1, c),
            (r(c, c) / c**0.5).to(bf), (r(c, c) / c**0.5).to(bf))


def passes(ops) -> dict:
    """Each pass of the Hopper body against its plain piece on the kernel's
    own inputs."""
    h0, s1, b1n, s2, b2n, gind, w1t, b1, w2t, b2, wk, wv = ops
    b, i, c = h0.shape
    groups, dt = gind.shape[1], h0.dtype
    mid = {}
    h, k, v = hs._hside_hopper(*ops, mid=mid)
    y1, g = mid["y1"].view(b, i, c), mid["g"].view(b, i, -1)
    hh, part = hs._hside_out_ref(g, w2t, b2)
    sums = mid["part"].view(part.shape).sum(1)
    r_k, r_v = hs._hside_kv_ref(h, wk, wv)
    return {"y1": rel(y1, hs._hside_norm_ref(h0, s1, b1n, groups, dt)),
            "g": rel(g, fa._mlp_act_ref(y1, w1t, b1)),
            "hh": rel(mid["hh"].view(b, i, c), hh),
            "slabs": rel(mid["part"].view(part.shape), part),
            "h": rel(h, hs._hside_norm_ref(mid["hh"].view(b, i, c), s2, b2n, groups, dt, sums)),
            "k": rel(k, r_k), "v": rel(v, r_v)}


def host_ms(fn, reps=40) -> float:
    """Median host milliseconds to launch one call (the wrapper's Python and
    its launches, not waiting for the card), the card idle before each."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return sorted(out)[reps // 2]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.hside: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    failed, result = [], {}

    def hold(what, errs, tol):
        bad = {k: v for k, v in errs.items() if not v <= tol}
        if bad:
            failed.append(f"{what}: {bad} above {tol:.0e}")

    for name, (b, i, c, w) in SHAPES.items():
        rec = {}
        for drift in (False, True):
            tag = f"{name}, {'drift' if drift else 'ordinary'}"
            ops = operands(gen, b, i, c, w, drift, dev)
            p = passes(ops)
            hold(f"{tag} passes", {k: v for k, v in p.items() if k not in ("hh", "slabs")},
                 TOL_PASS)
            hold(f"{tag} passes", {k: p[k] for k in ("hh", "slabs")}, TOL_FP32)
            first, want = hs.fused_h_side(*ops), hs._hside_ref(*ops)
            whole = {q: rel(a, r) for q, a, r in zip("hkv", first, want)}
            hold(f"{tag} whole", whole, TOL_OUT)
            same = all(torch.equal(a, z) for a, z in zip(first, hs.fused_h_side(*ops)))
            if not same:
                failed.append(f"{tag}: two calls differ")
            print(f"  {tag}: passes " + ", ".join(f"{k} {v:.3e}" for k, v in p.items())
                  + "; whole " + ", ".join(f"{k} {v:.3e}" for k, v in whole.items())
                  + f"; {'the same bits' if same else 'DIFFERENT bits'} in two calls")
            rec[f"passes_{'drift' if drift else 'ordinary'}"] = p
        ops = operands(gen, b, i, c, w, False, dev)
        hopper = lambda: hs.fused_h_side(*ops)
        med = lambda t: (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2
        if hs._hside_takes(i, c, w, GROUPS):
            wmma = lambda: hs._hside_wmma(*ops)
            t_w1, t_h1, t_h2, t_w2 = timed(wmma), timed(hopper), timed(hopper), timed(wmma)
            tw = sorted(t_w1 + t_w2)
            rec.update(wmma_ms=med(tw), wmma_min_max_ms=[tw[0], tw[-1]])
        else:
            t_h1, t_h2 = timed(hopper), timed(hopper)
        th = sorted(t_h1 + t_h2)
        split = launch_split(hopper)
        rec.update(hopper_ms=med(th), hopper_min_max_ms=[th[0], th[-1]], per_launch_ms=split,
                   device_ms=sum(split.values()), hopper_host_ms=host_ms(hopper))
        if "wmma_ms" in rec:
            rec.update(wmma_host_ms=host_ms(wmma),
                       wmma_device_ms=sum(launch_split(wmma).values()))
        print(f"  {name}: hopper {rec['hopper_ms']:.3f} ms ({th[0]:.3f}-{th[-1]:.3f}), device "
              f"{rec['device_ms']:.3f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"), host {rec['hopper_host_ms']:.3f} ms"
              + (f"; wmma {rec['wmma_ms']:.3f} ms, device {rec['wmma_device_ms']:.3f} ms, "
                 f"host {rec['wmma_host_ms']:.3f} ms"
                 if "wmma_ms" in rec else ""))
        result[name] = rec
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.hside: " + "; ".join(failed))


if __name__ == "__main__":
    main()
