"""The Hopper pool and unpool forwards at every width their instances take,
beside their WMMA bodies, timed and split by launch.

    python3 -m gecco_tpu_torch.probes.forwards [--quick]

``csrc/pool_ext.cu`` (the chunk kernel templated on the head width D and
the heads per block G) and ``csrc/unpool.cu`` (the tile kernel templated on
its column block) take the flagship (C 384, 8 heads of 48), the 8k width
(C 768, 16 heads), the upsample demo's C 128 (4 heads of 32) and the other
widths below. At each, ordinary and with drifted logits (one head's ~60x
another's), this holds the body ``_pool_ext_body`` / ``_unpool_body`` picks
against the plain version (``chip_smoke.py``'s tolerances), and for the
pool its folded query and softmax statistics against their plain pieces
(``_fold_qft_ref``, ``_pool_partials_ref`` merged by ``_pool_merge_ref``),
failing if the body that ran is not the one picked. At the flagship, the
8k width and the demo it times the Hopper body and the WMMA body in turns
on the same operands (20 calls each, CUDA events around each wrapper
call, the WMMA body forced through the launchers' private ``body``
argument) and splits both bodies' device time by launch with
``torch.profiler``; at three heads (B 48, C 384, D 128), the WMMA bodies'
own shape, it times the WMMA body alone. Beside each it reads the SDPA
yardstick (one call on the unfolded operands, ``chip_smoke.sdpa_pool`` /
``sdpa_unpool``: events and device time), times the chain yardstick (the
function as PyTorch calls, ``chain_pool`` / ``chain_unpool``) and computes
the bound as ``chip_smoke.py`` does (the operands' and outputs' bytes over
3.35 TB/s or the products over the bf16 peak, the larger). ``--quick``
takes the demo's shapes and three heads only. It prints the card's name
and power limit and one JSON line, and raises after printing if a check
fails. Run from the repository's root (it draws its operands with
``chip_smoke.py``'s functions). Needs the card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from gecco_tpu_torch.ops import kernels
from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import launch_split, rel, timed

# (B, N, C, H), 64 inducers a head; the first three are timed
SHAPES = {"flagship": (64, 2048, 384, 8), "8k width": (2, 8192, 768, 16),
          "demo": (48, 2048, 128, 4), "demo, N 2000": (48, 2000, 128, 4),
          "C 64, D 16": (16, 2048, 64, 4), "C 128, D 16": (16, 2048, 128, 8),
          "C 192, D 48": (16, 2048, 192, 4), "C 256, D 64": (16, 2048, 256, 4),
          "C 256, D 32": (16, 2048, 256, 8), "C 320, D 32": (16, 2048, 320, 10),
          "C 512, D 64": (16, 2048, 512, 8), "three heads": (48, 2048, 384, 3)}
TIMED = ("flagship", "8k width", "demo", "three heads")
I = 64
# the pool's statistics against their plain pieces: fp32 sums of the same
# bf16 products in other orders; the folded query qf^T is bf16 (the card's
# fold accumulates in fp32 before its rounding, PyTorch's in its own order:
# a bf16 step apart here and there, ~1e-3 of max |qf^T|), held as
# chip_smoke.py holds a bf16 output
TOL_STATS = 1e-3


def bodies(name, b, n, c, h, dev):
    """The pool's and the unpool's forced bodies at (B, N, C, H): name ->
    (the body picked, the operands' maker, the Hopper call, the WMMA call,
    the plain version, the SDPA yardstick's maker, the chain yardstick's
    maker, the bound's (ms, "bytes" or "operations") on the operands)."""
    from chip_smoke import (bound, chain_pool, chain_unpool, nbytes, pool_operands, sdpa_pool,
                            sdpa_unpool, unpool_operands)

    dt = torch.bfloat16
    out = {}
    out["pool"] = (
        fa._pool_ext_body(b, n, c, h, I),
        lambda g, drift: pool_operands(g, b, n, c, h, I, drift, dev, dt),
        lambda *a: fa._pool_ext_launch(*a, h, False, body="hopper")[0],
        lambda *a: fa._pool_ext_launch(*a, h, False, body="wmma")[0],
        lambda *a: fa._pool_ext_ref(*a, h),
        lambda ops: sdpa_pool(ops, h), lambda ops: chain_pool(ops, h),
        lambda ops: bound(2 * b * n * c * (h * I) + 2 * b * n * c * c + 2 * b * n * h * I * (c // h)
                          + 2 * b * I * c * c, nbytes(*ops) + b * I * c * 2))
    out["unpool"] = (
        fa._unpool_body(b, n, c, h, I),
        lambda g, drift: unpool_operands(g, b, n, c, h, I, drift, dev, dt),
        lambda *a: fa._unpool_launch(*a, h, True, True, body="hopper"),
        lambda *a: fa._unpool_launch(*a, h, True, True, body="wmma"),
        lambda *a: fa._unpool_ref(*a, h),
        lambda ops: sdpa_unpool(ops, h), lambda ops: chain_unpool(ops, h),
        lambda ops: bound(4 * b * n * c * (h * I) + 4 * b * h * I * c * (c // h),
                          nbytes(*ops) + nbytes(ops[0]) + b * 2 * c * 4))
    return out


def pool_statistics(ops, h) -> dict:
    """The Hopper pool's folded query and softmax statistics against their
    plain pieces on the same operands."""
    x, se, be, ind2, kvw, wo = ops
    _, qft, macc, sacc = fa._pool_ext_launch(*ops, h, True, body="hopper")
    r_qft = fa._fold_qft_ref(ind2, kvw, h)
    xp = fa._pad_points(x, fa._n_pad(x.shape[1]))
    _, mm, ll = fa._pool_merge_ref(*fa._pool_partials_ref(xp, se, be, qft, kvw, h, x.shape[1]),
                                   wo, h)
    return {"qft": rel(qft, r_qft), "macc": rel(macc, mm), "sacc": rel(sacc, ll)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.forwards: no CUDA device")
    from chip_smoke import TOL_OUT, TOL_SUMS

    quick = "--quick" in sys.argv[1:]
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    failed, result = [], {}
    med = lambda t: (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2
    shapes = {k: v for k, v in SHAPES.items()
              if not quick or k.startswith("demo") or k == "three heads"}
    for name, (b, n, c, h) in shapes.items():
        for fn_name, (picked, make, hopper, wmma, plain, sdpa, chain, bound_of) in bodies(
                name, b, n, c, h, dev).items():
            rec = {"body": picked}
            call = hopper if picked == "hopper" else wmma
            for drift in (False, True):
                tag = f"{fn_name} at {name}, {'drift' if drift else 'ordinary'}"
                ops = make(gen, drift)
                kernels.reset_launch_counts()
                got, want = call(*ops), plain(*ops)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                errs = {q: rel(a, r) for q, a, r in zip(("out", "sums"), got, want)}
                counts = kernels.launch_counts()
                key = "folded_pool_ext" if fn_name == "pool" else "folded_unpool"
                key = key if picked == "hopper" else f"{key}_wmma"
                if counts[key] != 1 or sum(counts.values()) != 1:
                    failed.append(f"{tag}: launches {counts}, not one of {key}")
                for q, err in errs.items():
                    if not err <= (TOL_SUMS if q == "sums" else TOL_OUT):
                        failed.append(f"{tag} {q}: {err:.3e}")
                line = ", ".join(f"{q} {v:.3e}" for q, v in errs.items())
                if fn_name == "pool" and picked == "hopper":
                    st = pool_statistics(ops, h)
                    bad = {k: v for k, v in st.items()
                           if not v <= (TOL_OUT if k == "qft" else TOL_STATS)}
                    if bad:
                        failed.append(f"{tag} statistics: {bad}")
                    line += "; " + ", ".join(f"{k} {v:.3e}" for k, v in st.items())
                    errs.update(st)
                rec[f"err_{'drift' if drift else 'ordinary'}"] = errs
                print(f"  {tag} ({picked} body): {line}", flush=True)
            if name in TIMED:
                ops = make(gen, False)
                lib = sdpa(ops)
                h_call, w_call = (lambda: hopper(*ops)), (lambda: wmma(*ops))
                if picked == "hopper":
                    t_w1, t_h1, t_h2, t_w2 = (timed(w_call), timed(h_call), timed(h_call),
                                              timed(w_call))
                    th, hs = sorted(t_h1 + t_h2), launch_split(h_call)
                    rec.update(hopper_ms=med(th), hopper_min_max_ms=[th[0], th[-1]],
                               hopper_device_ms=sum(hs.values()), hopper_per_launch_ms=hs)
                else:
                    t_w1, t_w2 = timed(w_call), timed(w_call)
                tw, ws = sorted(t_w1 + t_w2), launch_split(w_call)
                tl, tc = sorted(timed(lib)), sorted(timed(chain(ops)))
                rec.update(wmma_ms=med(tw), wmma_min_max_ms=[tw[0], tw[-1]],
                           wmma_device_ms=sum(ws.values()), wmma_per_launch_ms=ws,
                           sdpa_ms=med(tl), sdpa_device_ms=sum(launch_split(lib).values()),
                           chain_ms=med(tc), bound=bound_of(ops))
                if fn_name == "pool" and picked == "hopper":
                    rec["partials_mb"] = b * fa._n_pad(n) // fa._POOL_CHUNK * h * I * (
                        c // h + 2) * 4 / 1e6
                hopper_txt = "" if picked != "hopper" else (
                    f"hopper {rec['hopper_ms']:.3f} ms ({th[0]:.3f}-{th[-1]:.3f}), device "
                    f"{rec['hopper_device_ms']:.3f} ms ("
                    + ", ".join(f"{k} {v:.4f}" for k, v in hs.items()) + "); ")
                print(f"  {fn_name} at {name}: " + hopper_txt
                      + f"wmma {rec['wmma_ms']:.3f} ms ({tw[0]:.3f}-{tw[-1]:.3f}), device "
                      f"{rec['wmma_device_ms']:.3f} ms ("
                      + ", ".join(f"{k} {v:.4f}" for k, v in ws.items())
                      + f"); sdpa {rec['sdpa_ms']:.3f} ms, device {rec['sdpa_device_ms']:.3f} ms; "
                      f"chain {rec['chain_ms']:.3f} ms; bound {rec['bound'][0]:.4f} ms "
                      f"({rec['bound'][1]})",
                      flush=True)
            result[f"{fn_name} at {name}"] = rec
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.forwards: " + "; ".join(failed))


if __name__ == "__main__":
    main()
