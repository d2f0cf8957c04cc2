"""The unpool + MLP megakernel's two bodies against their plain version and
the separate kernels, timed in turns.

    python3 -m gecco_tpu_torch.probes.unpool_mlp [--quick]

Run from the repo's root (it takes ``chip_smoke.py``'s operands and
tolerances). It builds the megakernel's libraries and prints the Hopper
body's ``ptxas`` report, holds the shared-memory mirrors of both bodies
against the built libraries, and reads how many of the Hopper body's
clusters the card runs at once (``cudaOccupancyMaxActiveClusters``) at 16,
8, 4 and 2 blocks a cluster. At the flagship's operands (B 64, C 384, 8
heads of 48, 64 inducers, W 768; ``--quick``: B 4) and at N 2048 and 2000,
ordinary and with drifted logits, it holds the Hopper body against the
plain version (``_unpool_mlp_ref``) and against the separate unpool and
MLP kernels (``_unpool_mlp_composed``), and the forced WMMA body at N 2048;
the Hopper body's out and sums must be the same bits in two calls. Then it
times the Hopper body, the WMMA body and the separate kernels in turns
(CUDA events around each wrapper call, medians of 20) at N 2048 and reads
each one's device time by launch with ``torch.profiler``. It prints the
card's name and power limit and one JSON line, and raises after printing
if a check fails. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.ops.kernels._build import build_all, library
from gecco_tpu_torch.probes.pool_bwd import launch_split, rel, timed

C, HEADS, I, W = 384, 8, 64, 768
POINTS = (2048, 2000)


def operands(gen, b, n, drift, device):
    """The megakernel's operands as ``chip_smoke.py``'s megakernel phase
    draws them: the unpool's, mlp_norm's raw embed affine, the MLP's."""
    from chip_smoke import mlp_operands, unpool_operands

    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    ops = unpool_operands(gen, b, n, C, HEADS, I, drift, device, torch.bfloat16)
    mlp = mlp_operands(gen, 1, 64, C, W, False, device, torch.bfloat16)[3:]
    return (*ops, 1.0 + 0.2 * r(b, C), 0.2 * r(b, C)), mlp


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="batch 4, the checks and one timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probes.unpool_mlp: no CUDA device")
    from chip_smoke import GROUPS, TOL_OUT, TOL_SUMS

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    reports = build_all(("unpool_mlp", "unpool_mlp_wmma", "unpool", "mlp"))
    for line in reports.get("unpool_mlp", "").splitlines():
        if re.search(r"registers|spill", line):
            print("  ptxas:", line.strip())
    failed, result = [], {}
    hop, wm = library("unpool_mlp"), library("unpool_mlp_wmma")
    smem = hop.unpool_mlp_smem()
    if smem != fa._unpool_mlp_hopper_smem(C):
        failed.append(f"Hopper smem {smem} != the mirror's {fa._unpool_mlp_hopper_smem(C)}")
    for c, w in ((384, 768), (128, 256), (768, 1536)):
        tn = fa._row_tile(2048, c)
        lib_b = wm.unpool_mlp_wmma_smem(c, I, w, tn)
        mirror = max(fa._unpool_wmma_smem(tn, c, I), fa._mlp_wmma_smem(tn, c, w))
        if lib_b != mirror:
            failed.append(f"WMMA smem at C {c}: {lib_b} != the mirror's {mirror}")
    clusters = {cs: hop.unpool_mlp_clusters(cs) for cs in (16, 8, 4, 2)}
    print(f"  Hopper body: {smem} bytes a block; clusters at once {clusters}")
    result.update(smem=smem, clusters=clusters)

    b = 4 if args.quick else 64
    gen = torch.Generator(device=dev).manual_seed(0)
    gind = fa.group_indicator(C, GROUPS, dev)
    with torch.no_grad():
        for n in POINTS:
            for drift in (False, True):
                tag = f"N {n}, {'drift' if drift else 'ordinary'}"
                ops, mlp = operands(gen, b, n, drift, dev)
                got = fa._unpool_mlp_launch(*ops, gind, *mlp, HEADS, GROUPS, n, body="hopper")
                again = fa._unpool_mlp_launch(*ops, gind, *mlp, HEADS, GROUPS, n, body="hopper")
                want = fa._unpool_mlp_ref(*ops, *mlp, HEADS, GROUPS, n)
                sep = fa._unpool_mlp_composed(*ops, *mlp, HEADS, GROUPS, n)
                errs = {"out": rel(got[0], want[0]), "sums": rel(got[1], want[1]),
                        "out_sep": rel(got[0], sep[0]), "sums_sep": rel(got[1], sep[1])}
                if n % 64 == 0:
                    wmma = fa._unpool_mlp_launch(*ops, gind, *mlp, HEADS, GROUPS, n, body="wmma")
                    errs.update(wmma_out=rel(wmma[0], want[0]), wmma_sums=rel(wmma[1], want[1]))
                same = all(torch.equal(a, z) for a, z in zip(got, again))
                for k, v in errs.items():
                    if not v <= (TOL_SUMS if "sums" in k else TOL_OUT):
                        failed.append(f"{tag} {k} {v:.3e}")
                if not same:
                    failed.append(f"{tag}: two calls differ")
                print(f"  {tag}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                      + f"; {'the same bits' if same else 'DIFFERENT bits'} in two calls")
                result[tag] = errs

        ops, mlp = operands(gen, b, POINTS[0], False, dev)
        fns = {
            "hopper": lambda: fa._unpool_mlp_launch(*ops, gind, *mlp, HEADS, GROUPS, POINTS[0],
                                                    body="hopper"),
            "wmma": lambda: fa._unpool_mlp_launch(*ops, gind, *mlp, HEADS, GROUPS, POINTS[0],
                                                  body="wmma"),
            "separate": lambda: fa._unpool_mlp_composed(*ops, *mlp, HEADS, GROUPS, POINTS[0]),
        }
        times = {k: [] for k in fns}
        for turn in range(1 if args.quick else 2):
            for k in (fns if turn % 2 == 0 else reversed(list(fns))):
                times[k] += timed(fns[k])
        med = lambda t: sorted(t)[len(t) // 2]
        for k, fn in fns.items():
            split = launch_split(fn)
            t = sorted(times[k])
            result[k] = dict(ms=med(t), min_max_ms=[t[0], t[-1]], device_ms=sum(split.values()),
                             per_launch_ms=split)
            print(f"  {k} (B {b}, N {POINTS[0]}): {med(t):.3f} ms ({t[0]:.3f}-{t[-1]:.3f}), "
                  f"device {sum(split.values()):.3f} ms ("
                  + ", ".join(f"{q} {v:.4f}" for q, v in split.items()) + ")")
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.unpool_mlp: " + "; ".join(failed))


if __name__ == "__main__":
    main()
