"""The pool backward's v1, v2 and v2j bodies, checked, timed and split by
launch.

    python3 -m gecco_tpu_torch.probes.pool_bwd_twopass

``csrc/pool_bwd_twopass.cuh`` (instances in ``csrc/pool_ext_bwd_v1.cu``
and ``csrc/pool_ext_bwd_v2.cu``) runs the pre-norm, the fold (DM or DMs),
pass 0 (per head and batch element over all points), pass 1 (per point
tile), the column sums and three weight-gradient products. At the
flagship's training shapes (B 48, N 2048, C 384, 8 heads) and the 8k width
(B 2, N 8192, C 768, 16 heads), ordinary and with drifted logits, this
holds each body's outputs against its plain version (``_pool_bwd_v1_ref``,
``_pool_bwd_v2_ref``), checks that two calls give the same bits and that
v2j gives v2's, times the v3 Hopper body and each of the three (20
calls each) on the ordinary operands, and splits each body's device time
by launch with ``torch.profiler``. It prints the card's name and power limit
and one JSON line. Needs the card.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import TWOPASS_BODIES as BODIES
from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import SHAPES, launch_split, operands, rel, timed

OUTPUTS = ("dx", "dse", "dbe", "dqf", "dwv", "dwo")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.pool_bwd_twopass: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(1)
    result = {}
    for width, (b, n, c, heads, i) in SHAPES.items():
        for drift in (False, True):
            ops = operands(g, b, n, c, heads, i, drift, dev)
            x, se, be, _, kvw, wo = ops
            _, qft, macc, sacc = fa._pool_ext_launch(*ops, heads, True)
            gh = (0.1 * torch.randn(b, i, c, generator=g, device=dev)).to(x.dtype)
            raw = (x, se, be, qft, kvw, wo, gh, macc, sacc, heads)
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            outs = {}
            for body in BODIES:
                got = fa._pool_ext_bwd_twopass(*raw, body)
                again = fa._pool_ext_bwd_twopass(*raw, body)
                ref = fa._TWOPASS_REFS[body](*raw)
                errs = {k: rel(a, r) for k, a, r in zip(OUTPUTS, got, ref)}
                same = all(torch.equal(p, q) for p, q in zip(got, again))
                outs[body] = got
                print(f"  {tag}, {body}: against its plain version (max|err|/max|ref|): "
                      + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                      + f"; two calls {'the same bits' if same else 'DIFFER'}")
                result[f"{tag}, {body}"] = {"errors": errs, "same_bits": same}
            v2j = all(torch.equal(p, q) for p, q in zip(outs["v2"], outs["v2j"]))
            print(f"  {tag}: v2j against v2 {'the same bits' if v2j else 'DIFFER'}")
            result[f"{tag}, v2j is v2"] = v2j
            if not drift:
                case = raw
        v3 = timed(lambda: fa._pool_ext_bwd_hopper(*case))
        print(f"  {width}, v3 Hopper body: median {statistics.median(v3):.3f} ms")
        result[f"{width}, v3"] = {"median_ms": statistics.median(v3)}
        for body in BODIES:
            call = lambda b_=body: fa._pool_ext_bwd_twopass(*case, b_)
            t = timed(call)
            split = launch_split(call)
            print(f"  {width}, {body}: median {statistics.median(t):.3f} ms of {len(t)} (min "
                  f"{min(t):.3f}, max {max(t):.3f}); per launch (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
            result[f"{width}, {body}"] = {"median_ms": statistics.median(t),
                                          "min_max_ms": [min(t), max(t)], "per_launch_ms": split}
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
