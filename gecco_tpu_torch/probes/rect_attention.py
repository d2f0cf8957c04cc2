"""The per-head rect attention's Hopper bodies against their plain
versions, timed in turns with their WMMA bodies on the same operands.

    python3 -m gecco_tpu_torch.probes.rect_attention [--quick]

Builds the four libraries of ``rect_attention_fwd`` and
``rect_attention_bwd`` (``csrc/induced_attention.cu``,
``induced_attention_bwd.cu`` and their ``_wmma`` bodies) and prints what
``ptxas`` reports for the Hopper ones (registers, spills). Then at each
head width the Hopper bodies take at C 384 (the flagship's 8 heads of 48,
12 of 32, 6 of 64 and 3 of 128), 64 inducers and 2048 points, and at
8192 points (D 128, whose pool forward streams its k tiles twice, and the
8k width's 16 heads of 48, batch 2), both
directions (the pool: the inducers against the points; the unpool: the
reverse), ordinary and with drifted logits (one head's ~60x another's):
the forward at batch 64 (o and lse against the plain version and against
the Hopper design's plain pieces, ``_rect_fwd_pieces``) and the backward
at batch 48 (dq, dk and dv against autograd of the plain version, against
the TPU algebra's witness ``_rect_bwd_tpu_algebra`` and against the plain
pieces ``_rect_bwd_pieces``), at ``chip_smoke.py``'s tolerances, each
output the same bits in two calls, failing unless the switch
(``_rect_fwd_body`` / ``_rect_bwd_body``) picks the Hopper body. Then each
direction's Hopper and WMMA bodies timed in turns (``chip_smoke.py``'s
``bodies_in_turns``: CUDA events, medians of 20 calls each), each one's
device time (``torch.profiler``), SDPA's time on the same q, k, v and the
bound as ``chip_smoke.py`` computes it. ``--quick``: the checks only, at
batch 4. Prints one JSON line and the card's name and power limit, and
raises after printing if a check failed. Run from the repository's root
(it draws its operands with ``chip_smoke.py``'s functions). Needs the
card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from gecco_tpu_torch.ops.kernels import _build
from gecco_tpu_torch.ops.kernels import induced_attention as ia

# name -> (C, heads, points, forward batch, backward batch), 64 inducers:
# the first four timed; the last two at 8192 points, where the pool
# forward streams its k tiles twice (D 128) or keeps sixteen resident
WIDTHS = {"D 48": (384, 8, 2048, 64, 48), "D 32": (384, 12, 2048, 64, 48),
          "D 64": (384, 6, 2048, 64, 48), "D 128": (384, 3, 2048, 64, 48),
          "D 128, N 8192": (384, 3, 8192, 2, 2), "D 48, N 8192": (768, 16, 8192, 2, 2)}
TIMED = ("D 48", "D 32", "D 64", "D 128")
I = 64
LIBRARIES = ("induced_attention", "induced_attention_bwd", "induced_attention_wmma",
             "induced_attention_bwd_wmma")


def main():
    quick = "--quick" in sys.argv[1:]
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("probes.rect_attention: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), torch.bfloat16
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    for name, text in _build.build_all(LIBRARIES).items():
        for line in text.splitlines():
            if name in LIBRARIES[:2] and ("registers" in line or "spill" in line
                                          or "Compiling entry" in line):
                print(f"  {name}: {line.strip()}")
    g = torch.Generator(device=dev).manual_seed(4)
    failed, result = [], {}

    def hold(what, err, tol):
        print(f"  {what}: {err:.3e} (tol {tol:.0e}){'' if err <= tol else '  FAILED'}")
        if not err <= tol:
            failed.append(what)

    def same(what, first, second):
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            print(f"  {what}: not the same bits in two calls  FAILED")
            failed.append(what)

    for wname, (c, h, n, fb, bb) in WIDTHS.items():
        if quick:
            fb, bb = min(fb, 4), min(bb, 4)
        for direction in ("pool", "unpool"):
            for drift in (False, True):
                what = f"{wname}, {direction}, {'drift' if drift else 'ordinary'}"
                q, k, v = cs.attn_operands(g, fb, n, c, h, I, direction, drift, dev, dt)
                if ia._rect_fwd_body(q, k, v) != "hopper":
                    failed.append(f"forward {what}: the switch did not pick the Hopper body")
                got = ia._rect_attention_fwd_hopper(q, k, v)
                again = ia._rect_attention_fwd_hopper(q, k, v)
                want, pieces = ia._rect_attention_ref(q, k, v), ia._rect_fwd_pieces(q, k, v)
                torch.cuda.synchronize()
                for key, a, ref, pc, tol in zip(("o", "lse"), got, want, pieces,
                                               (cs.TOL_OUT, cs.TOL_LSE)):
                    hold(f"forward {what} {key}", cs.rel_err(a, ref), tol)
                    hold(f"forward {what} {key} against the plain pieces", cs.rel_err(a, pc), tol)
                same(f"forward {what}", got, again)
                q, k, v = cs.attn_operands(g, bb, n, c, h, I, direction, drift, dev, dt)
                o, lse = ia._rect_attention_fwd_hopper(q, k, v)
                gg = cs.merged_randn(g, o)
                ops = (q, k, v, o, lse, gg)
                if ia._rect_bwd_body(q, k, v, o, gg) != "hopper":
                    failed.append(f"backward {what}: the switch did not pick the Hopper body")
                got = ia._rect_attention_bwd_hopper(*ops)
                again = ia._rect_attention_bwd_hopper(*ops)
                refs = {"autograd of the plain version": ia._rect_attention_bwd_ref(q, k, v, gg),
                        "the TPU algebra": ia._rect_bwd_tpu_algebra(*ops),
                        "the plain pieces": ia._rect_bwd_pieces(*ops)}
                torch.cuda.synchronize()
                for against, want in refs.items():
                    for key, a, ref in zip(("dq", "dk", "dv"), got, want):
                        hold(f"backward {what} {key} against {against}", cs.rel_err(a, ref),
                             cs.TOL_GRAD)
                same(f"backward {what}", got, again)
        if quick or wname not in TIMED:
            continue
        for direction in ("pool", "unpool"):
            q, k, v = cs.attn_operands(g, fb, n, c, h, I, direction, False, dev, dt)
            runs = {"hopper": lambda: ia._rect_attention_fwd_hopper(q, k, v),
                    "wmma": lambda: ia._rect_attention_fwd_wmma(q, k, v)}
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            bms, by = cs.bound(4 * fb * h * q.shape[2] * k.shape[2] * (c // h),
                               cs.q_bytes(q) + cs.nbytes(k, v)
                               + fb * h * q.shape[2] * (2 * (c // h) + 4))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qc, kc, vc)
            fwd = timings(cs, runs, sdpa, dev, bms, by)
            q, k, v = cs.attn_operands(g, bb, n, c, h, I, direction, False, dev, dt)
            o, lse = ia._rect_attention_fwd_hopper(q, k, v)
            gg = cs.merged_randn(g, o)
            ops = (q, k, v, o, lse, gg)
            runs = {"hopper": lambda: ia._rect_attention_bwd_hopper(*ops),
                    "wmma": lambda: ia._rect_attention_bwd_wmma(*ops)}
            bms, by = cs.bound(10 * bb * h * q.shape[2] * k.shape[2] * (c // h),
                               cs.q_bytes(q) + cs.nbytes(k, v, o, gg, lse)
                               + cs.nbytes(q.expand_as(o), k, v))
            sdpa = cs.sdpa_backward(*(t.contiguous() for t in (q, k, v)), g)
            bwd = timings(cs, runs, sdpa, dev, bms, by)
            result[f"{wname} {direction}"] = {"forward": fwd, "backward": bwd}
            for part, t in (("forward", fwd), ("backward", bwd)):
                print(f"  {wname} {direction} {part}: Hopper {t['hopper_ms']:.4f} ms (device "
                      f"{t['hopper_device_ms']:.4f}), WMMA {t['wmma_ms']:.4f} ms (device "
                      f"{t['wmma_device_ms']:.4f}), SDPA {t['sdpa_ms']:.4f} ms (device "
                      f"{t['sdpa_device_ms']:.4f}), bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    print(json.dumps({"card": card, "quick": quick, "timings": result, "failed": failed}))
    print(card)
    if failed:
        raise SystemExit(f"probes.rect_attention: {len(failed)} checks failed: {failed[:5]}")


def timings(cs, runs, sdpa, dev, bms, by) -> dict:
    """The two bodies in turns (medians), each one's and SDPA's device
    milliseconds, SDPA's events, and the bound."""
    turns = cs.bodies_in_turns(runs["hopper"], runs["wmma"], dev, 20)
    return {"hopper_ms": statistics.median(turns["hopper"]),
            "wmma_ms": statistics.median(turns["wmma"]),
            "hopper_device_ms": cs.device_ms(runs["hopper"], dev),
            "wmma_device_ms": cs.device_ms(runs["wmma"], dev),
            "sdpa_ms": cs.time_ms(sdpa, dev, 20), "sdpa_device_ms": cs.device_ms(sdpa, dev),
            "bound_ms": bms, "bound_by": by}


if __name__ == "__main__":
    main()
