"""The resident pool's Hopper body pass by pass, beside its WMMA body,
timed and split by launch.

    python3 -m gecco_tpu_torch.probes.pool_layer

``csrc/pool.cu`` runs the pre-norm (its statistics and y), pass A (each
64-point chunk's column max and sum), the merge (M, L), pass B (each chunk's
P_c = p^T v), the chunk sum (pacc, pooled) and the output projection. At the
flagship's width (B 64, N 2048, C 384, 8 heads, 64 inducers), the 8k width
(C 768, 16 heads, at B 64 and N 2048 and at B 2 and N 8192), 16, 128 and 256
inducers and N 2000, with and without the pre-norm, ordinary and with
drifted logits, this holds each pass's output against its plain piece fed
the kernel's own inputs to that pass, and the whole function against the
plain version; every output must be the same bits in two calls. It times the
Hopper body and, where it takes the shape, the WMMA body in turns (20 calls
each, CUDA events around each wrapper call) and splits both bodies' device
time by launch with ``torch.profiler``. It prints the card's name and power
limit and one JSON line, and raises after printing if a check fails. Needs
the card.
"""

from __future__ import annotations

import json
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import launch_split, rel, timed

# (B, N, C, H, I)
SHAPES = {"flagship": (64, 2048, 384, 8, 64), "8k width, B 64": (64, 2048, 768, 16, 64),
          "8k width": (2, 8192, 768, 16, 64), "I 16": (64, 2048, 384, 8, 16),
          "I 128": (64, 2048, 384, 8, 128), "I 256": (32, 2048, 384, 8, 256),
          "N 2000": (64, 2000, 384, 8, 64)}
GROUPS = 32
# each pass against its plain piece on the kernel's inputs: the chunk
# maxima are the same fp32 logits summed in another order; the sums and
# the chunk sum fp32 sums in other orders; P_c rounds p to bf16 (a
# rounding flip moves a value by one bf16 step, 2^-8, of the largest)
TOL_MAX, TOL_FP32, TOL_PASS = 1e-5, 1e-4, 2e-2
# the whole function against its plain version: chip_smoke.py's TOL_OUT
# (h0) and TOL_STATS (the GroupNorm statistics)
TOL_OUT, TOL_STATS = 2e-2, 1e-4


def operands(gen, b, n, c, heads, i, drift, device):
    """The resident pool's operands as ``chip_smoke.py`` draws them: the
    stream with per-channel offsets (non-zero group means), with ``drift``
    the k rows of each head scaled by 60, 1, 0.1, 0.01 in turn, and the
    group indicator."""
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    d = c // heads
    kvw = r(2 * c, c) / c**0.5
    if drift:
        scale = torch.tensor([60.0, 1.0, 0.1, 0.01], device=device)
        kvw[:c] *= scale.repeat(heads // 4 + 1)[:heads].repeat_interleave(d)[:, None]
    bf = torch.bfloat16
    x = (1.5 * r(b, n, c) + 0.3 * r(1, 1, c)).to(bf)
    return (x, 1.0 + 0.1 * r(b, c), 0.1 * r(b, c), r(heads * i, d).to(bf), kvw.to(bf),
            (r(c, c) / c**0.5).to(bf), fa.group_indicator(c, GROUPS, device))


def passes(ops, heads, prenorm) -> tuple:
    """Each pass of the Hopper body against its plain piece on the kernel's
    own inputs -> (errors, the call's outputs)."""
    x, _, _, _, kvw, wo, _ = ops
    n_valid = x.shape[1]
    mid = {}
    h0, mean_c, inv_c, (m, l, pacc, y) = fa._pool_layer_launch(*ops, heads, prenorm, True, mid)
    r_m, r_l = fa._pool_layer_chunks_ref(y, mid["qft"], n_valid)
    r_mm, r_ll = fa._pool_layer_merge_ref(mid["part_m"], mid["part_l"])
    ok = r_m > -torch.inf  # a chunk of padding alone: m_c = -inf on both sides
    errs = {
        "part_m": rel(torch.where(ok, mid["part_m"], 0.0), torch.where(ok, r_m, 0.0)),
        "part_l": rel(mid["part_l"], r_l), "m": rel(m, r_mm), "l": rel(l, r_ll),
        "part_p": rel(mid["part_p"],
                      fa._pool_layer_partials_ref(y, mid["qft"], kvw, m, l, heads, n_valid)),
        "pacc": rel(pacc, fa._pool_layer_sum_ref(mid["part_p"], heads)),
        "h0": rel(h0, (pacc.to(x.dtype).float() @ wo.float().t()).to(x.dtype)),
    }
    return errs, (h0, mean_c, inv_c, m, l, pacc)


TOLS = {"part_m": TOL_MAX, "part_l": TOL_FP32, "m": TOL_MAX, "l": TOL_FP32,
        "part_p": TOL_PASS, "pacc": TOL_FP32, "h0": TOL_PASS}


def check_shape(ops, heads, failed: list, tag: str) -> dict:
    """Passes, the whole function against the plain version and the same
    bits in two calls, with and without the pre-norm; returns the errors."""
    out = {}
    for prenorm in (True, False):
        what = f"{tag}, {'prenorm' if prenorm else 'no pre-norm'}"
        errs, first = passes(ops, heads, prenorm)
        bad = {k: v for k, v in errs.items() if not v <= TOLS[k]}
        if bad:
            failed.append(f"{what} passes: {bad}")
        with torch.no_grad():
            want = fa._pool_ref(*ops[:6], GROUPS, heads, prenorm)
        whole = {q: rel(a, r) for q, a, r in zip(("h0", "mean_c", "inv_c"), first, want)}
        bad = {k: v for k, v in whole.items()
               if not v <= (TOL_OUT if k == "h0" else TOL_STATS)}
        if bad:
            failed.append(f"{what} whole: {bad}")
        second = passes(ops, heads, prenorm)[1]
        same = all(torch.equal(a, z) for a, z in zip(first, second))
        if not same:
            failed.append(f"{what}: two calls differ")
        print(f"  {what}: passes " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + "; whole " + ", ".join(f"{k} {v:.3e}" for k, v in whole.items())
              + f"; {'the same bits' if same else 'DIFFERENT bits'} in two calls")
        out["prenorm" if prenorm else "raw"] = dict(passes=errs, whole=whole, same_bits=same)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.pool_layer: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    failed, result = [], {}
    med = lambda t: (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2
    for name, (b, n, c, heads, i) in SHAPES.items():
        body = fa._pool_layer_body(b, n, c, heads, i)
        if body != "hopper":
            failed.append(f"{name}: the switch picks {body}")
            continue
        rec = {}
        for drift in (False, True):
            ops = operands(gen, b, n, c, heads, i, drift, dev)
            rec["drift" if drift else "ordinary"] = check_shape(
                ops, heads, failed, f"{name}, {'drift' if drift else 'ordinary'}")
        ops = operands(gen, b, n, c, heads, i, False, dev)
        wmma_takes = fa._pool_wmma_block(c, i, c // heads) > 0
        for prenorm in (True, False):
            key = "prenorm" if prenorm else "raw"
            run = lambda body: (lambda: fa._pool_layer_launch(*ops, heads, prenorm, False,
                                                              body=body))
            hopper, wmma = run("hopper"), run("wmma")
            t = {}
            if wmma_takes:
                t_w1, t_h1, t_h2, t_w2 = timed(wmma), timed(hopper), timed(hopper), timed(wmma)
                tw = sorted(t_w1 + t_w2)
                t.update(wmma_ms=med(tw), wmma_min_max_ms=[tw[0], tw[-1]],
                         wmma_device_ms=sum(launch_split(wmma).values()))
            else:
                t_h1, t_h2 = timed(hopper), timed(hopper)
            th = sorted(t_h1 + t_h2)
            split = launch_split(hopper)
            t.update(hopper_ms=med(th), hopper_min_max_ms=[th[0], th[-1]], per_launch_ms=split,
                     device_ms=sum(split.values()))
            print(f"  {name}, {key}: hopper {t['hopper_ms']:.3f} ms ({th[0]:.3f}-{th[-1]:.3f}), "
                  f"device {t['device_ms']:.3f} ms ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + ")"
                  + (f"; wmma {t['wmma_ms']:.3f} ms, device {t['wmma_device_ms']:.3f} ms"
                     if "wmma_ms" in t else ""))
            rec[f"times_{key}"] = t
        result[name] = rec
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.pool_layer: " + "; ".join(failed))


if __name__ == "__main__":
    main()
