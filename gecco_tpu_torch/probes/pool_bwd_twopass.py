"""The pool backward's v1, v2 and v2j bodies, checked, timed and split by
launch.

    python3 -m gecco_tpu_torch.probes.pool_bwd_twopass [--heads 3]

Each algebra has two bodies: the Hopper body (``csrc/pool_ext_bwd_twopass.cu``:
the pre-norm, the fold, the S and V products, pass 0's range partials,
their merge, pass 1 per tile, the dy product with dx and the column sums'
partials, the column sums, three weight-gradient products) at the
flagship's and the 8k width, and the WMMA body
(``csrc/pool_bwd_twopass.cuh``, instances in ``csrc/pool_ext_bwd_v1.cu``
and ``csrc/pool_ext_bwd_v2.cu``) for every other shape. At the flagship's
training shapes (B 48, N 2048, C 384, 8 heads) and the 8k width (B 2, N
8192, C 768, 16 heads), ordinary and with drifted logits, this holds both
bodies' outputs against the plain version (``_pool_bwd_v1_ref``,
``_pool_bwd_v2_ref``), each pass of the Hopper body against its plain
piece fed the kernel's own inputs to that pass (so a fault shows in the
pass that makes it), checks that two calls give the same bits and that
v2j gives v2's, times the v3 body (the one its switch picks), the Hopper
body and the WMMA body of each algebra in turns (20 calls each) on the
ordinary operands, reads SDPA's backward on the unfolded q/k/v in device
time beside them,
splits both bodies' device time by launch with ``torch.profiler``, reads
what the Hopper body's fp32 logits S cost (its bytes, and the rates of
the three kernels that write and read it) and the memory each body's
call holds at its peak. With ``--heads 3`` it does so at three heads of
64 inducers at C 384 instead (B 48, N 2048: D 128, J 192, the Hopper
body's D 128 instance; v3 there is its WMMA body). It prints the card's
name and power limit and one JSON line. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import TWOPASS_BODIES as BODIES
from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import SHAPES, launch_split, operands, rel, timed

# --heads 3: three heads of 64 inducers at the flagship's C (D 128, J 192)
SHAPES_3H = {"three heads": (48, 2048, 384, 3, 64)}

OUTPUTS = ("dx", "dse", "dbe", "dqf", "dwv", "dwo")
IMPLS = ("hopper", "wmma")
# a pass against its plain piece on the kernel's own inputs: the bf16
# outputs a few bf16 steps (2^-8) of the largest value, the fp32 ones
# (logits, partials, tacc) summed in other orders
TOL_PASS, TOL_FP32 = 2e-2, 1e-3
FP32_PASSES = ("s", "ppart", "tpart", "tacc")


def raw_operands(g, b, n, c, heads, i, drift, device):
    """The two-pass bodies' arguments: the pool's operands, the forward's
    folded query and statistics, a bf16 cotangent."""
    ops = operands(g, b, n, c, heads, i, drift, device)
    x, se, be, _, kvw, wo = ops
    _, qft, macc, sacc = fa._pool_ext_launch(*ops, heads, True)
    gh = (0.1 * torch.randn(b, i, c, generator=g, device=device)).to(x.dtype)
    return ops, (x, se, be, qft, kvw, wo, gh, macc, sacc, heads)


def passes(raw, body) -> dict:
    """Each pass of the Hopper body of ``body`` against its plain piece on
    the kernel's own inputs -> max|err|/max|ref| per pass."""
    x, se, be, qft, kvw, wo, gh, macc, sacc, heads = raw
    v1 = body == "v1"
    outs, mid = fa._twopass_hopper(*raw, body)
    b, n_valid, c = x.shape
    n = mid["s"].shape[1]
    j = qft.shape[0]
    i, d = j // heads, c // heads
    nv = n_valid if n_valid < n else None
    y = mid["y"].float()
    s = torch.einsum("bnc,jc->bnj", y, qft.float())
    v = torch.einsum("bnc,dc->bnd", y, kvw[c:].float()).to(x.dtype)
    ppart, tpart = fa._twopass_ranges_ref(mid["s"], mid["v"], mid["dm"], macc, heads, v1, nv)
    tacc, merged = fa._twopass_merge_ref(mid["ppart"], mid["tpart"] if v1 else None, mid["dm"],
                                         sacc, x.dtype)
    ds, dv = fa._twopass_tiles_ref(mid["s"], mid["v"], mid["dm"], macc, sacc, mid["tacc"], heads,
                                   v1, nv)
    merged_k = mid["merged"].reshape(b, i, heads, d).permute(0, 2, 1, 3)
    xp = fa._pad_points(x, n)
    rest = fa._twopass_outputs(xp, se, y, mid["ds"].float(), mid["dv"].float(), qft, kvw, gh,
                               merged_k.float())
    out = {
        "dm": rel(mid["dm"], fa._twopass_fold_ref(gh, wo, sacc, heads, v1)),
        "s": rel(mid["s"], s), "v": rel(mid["v"], v), "ppart": rel(mid["ppart"], ppart),
        "tacc": rel(mid["tacc"], tacc), "merged": rel(merged_k.reshape(b, j, d), merged),
        "ds": rel(mid["ds"], ds), "dv": rel(mid["dv"], dv),
        "dx": rel(outs[0], rest[0][:, :n_valid]),
        **{k: rel(a, r) for k, a, r in zip(OUTPUTS[1:], outs[1:], rest[1:])},
    }
    if v1:
        out["tpart"] = rel(mid["tpart"], tpart)
    return out


def pass_failures(errs: dict) -> list:
    """The passes beyond their tolerances."""
    return [f"{k} {v:.3e}" for k, v in errs.items()
            if v > (TOL_FP32 if k in FP32_PASSES else TOL_PASS)]


def in_turns(fns: dict, reps=20) -> dict:
    """Each of ``fns`` timed in turns (reps / 2 calls each forward, then
    reps / 2 each in reverse order) -> sorted milliseconds per name."""
    out = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            out[k] += timed(fns[k], max(1, reps // 2))
    return {k: sorted(v) for k, v in out.items()}


def peak_mb(fn) -> float:
    """MB that one call of ``fn`` holds at its peak above what was
    allocated before it (scratch and outputs)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 1e6


def s_traffic(b, n, c, heads, i, split) -> dict:
    """What the Hopper body's fp32 logits S [B N, J] cost: its MB, the MB
    each of the three kernels that write or read it moves (each operand
    once) and the rate each reached in ``split``'s device time, and the
    least time S's own three passes take at 3.35 TB/s."""
    j, d = heads * i, c // heads
    ranges = -(-n // fa._TWOPASS_RANGE)
    s_b, y_b, dm_b = 4 * b * n * j, 2 * b * n * c, 2 * b * j * d
    # the S product's kernel: 128-column tiles, 64 where J % 128 != 0
    s_kernel = "twopass_s_kernel" if j % 128 == 0 else "twopass_s64_kernel"
    moved = {s_kernel: y_b + 2 * j * c + s_b,
             "twopass_range_kernel": s_b + y_b + dm_b + 4 * ranges * b * j * (d + 1),
             "twopass_tile_kernel": s_b + y_b + dm_b + 4 * b * j + 2 * b * n * j + y_b}
    out = {"s_mb": s_b / 1e6, "s_floor_ms": 3 * s_b / 3.35e9}
    for k, by in moved.items():
        out[k] = {"mb": by / 1e6, "ms": split[k], "tb_per_s": by / split[k] / 1e9}
    return out


def sdpa_bwd(ops, heads, g):
    """SDPA's backward on the pool's unfolded q/k/v (``chip_smoke.py``'s
    yardstick), the forward run once outside the call."""
    x, se, be, ind2, kvw, _ = ops
    b, n, c = x.shape
    d = c // heads
    y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2).contiguous().requires_grad_(True)
    k, v = (split(t) for t in (y @ kvw.T).chunk(2, dim=-1))
    q = ind2.reshape(heads, -1, d)[None].expand(b, -1, -1, -1).contiguous().requires_grad_(True)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    go = torch.randn(out.shape, generator=g, device=out.device).to(out.dtype)
    return lambda: torch.autograd.grad(out, (q, k, v), go, retain_graph=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, choices=(3,), default=None,
                    help="three heads of 64 inducers at C 384 instead of the flagship's and the "
                         "8k width")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probes.pool_bwd_twopass: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(1)
    result = {}
    failed = []
    for width, (b, n, c, heads, i) in (SHAPES_3H if args.heads == 3 else SHAPES).items():
        for drift in (False, True):
            ops, raw = raw_operands(g, b, n, c, heads, i, drift, dev)
            tag = f"{width}, {'drift' if drift else 'ordinary'}"
            outs = {}
            for body in BODIES:
                ref = fa._TWOPASS_REFS[body](*raw)
                for impl in IMPLS:
                    got = fa._pool_ext_bwd_twopass(*raw, body, impl)
                    again = fa._pool_ext_bwd_twopass(*raw, body, impl)
                    errs = {k: rel(a, r) for k, a, r in zip(OUTPUTS, got, ref)}
                    same = all(torch.equal(p, q) for p, q in zip(got, again))
                    outs[body, impl] = got
                    print(f"  {tag}, {body} {impl}: against its plain version "
                          f"(max|err|/max|ref|): " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                               errs.items())
                          + f"; two calls {'the same bits' if same else 'DIFFER'}")
                    result[f"{tag}, {body} {impl}"] = {"errors": errs, "same_bits": same}
                    if not same:
                        failed.append(f"{tag}, {body} {impl}: two calls differ")
                p = passes(raw, body)
                print(f"  {tag}, {body} hopper passes against their pieces: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in p.items()))
                result[f"{tag}, {body} passes"] = p
                failed += [f"{tag}, {body} pass {f}" for f in pass_failures(p)]
            for impl in IMPLS:
                v2j = all(torch.equal(p, q) for p, q in zip(outs["v2", impl], outs["v2j", impl]))
                print(f"  {tag}: {impl} v2j against v2 {'the same bits' if v2j else 'DIFFER'}")
                result[f"{tag}, {impl} v2j is v2"] = v2j
                if not v2j:
                    failed.append(f"{tag}, {impl}: v2j differs from v2")
            if not drift:
                case, case_ops = raw, ops
        v3 = (fa._pool_ext_bwd_hopper if fa._pool_ext_bwd_body(b, n, c, heads, i) == "hopper"
              else fa._pool_ext_bwd_wmma)
        sdpa_ms = sum(launch_split(sdpa_bwd(case_ops, heads, g)).values())
        print(f"  {width}: SDPA's backward, device {sdpa_ms:.3f} ms a call")
        result[f"{width}, sdpa backward device ms"] = sdpa_ms
        for body in BODIES:
            fns = {"v3": lambda: v3(*case),
                   **{impl: (lambda b_=body, m=impl: fa._pool_ext_bwd_twopass(*case, b_, m))
                      for impl in IMPLS}}
            turns = in_turns(fns)
            print(f"  {width}, {body} in turns (ms of 20 calls, median (min, max)): "
                  + ", ".join(f"{k} {statistics.median(t):.3f} ({t[0]:.3f}, {t[-1]:.3f})"
                              for k, t in turns.items()))
            rec = {k: {"median_ms": statistics.median(t), "min_max_ms": [t[0], t[-1]]}
                   for k, t in turns.items()}
            for impl in ("v3", *IMPLS):
                split = launch_split(fns[impl])
                print(f"  {width}, {body} {impl}: per launch (ms): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
                rec[impl]["per_launch_ms"] = split
            rec["s_traffic"] = st = s_traffic(b, n, c, heads, i, rec["hopper"]["per_launch_ms"])
            print(f"  {width}, {body} hopper: S {st['s_mb']:.1f} MB fp32, its three passes "
                  f">= {st['s_floor_ms']:.3f} ms at 3.35 TB/s; "
                  + ", ".join(f"{k} {v['mb']:.1f} MB in {v['ms']:.3f} ms = "
                              f"{v['tb_per_s']:.2f} TB/s" for k, v in st.items()
                              if isinstance(v, dict)))
            rec["peak_mb"] = {k: peak_mb(f) for k, f in fns.items()}
            print(f"  {width}, {body}: MB a call holds above its inputs at its peak: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in rec["peak_mb"].items()))
            result[f"{width}, {body}"] = rec
    print(card)
    print(json.dumps(result))
    if failed:
        raise SystemExit("probes.pool_bwd_twopass: " + "; ".join(failed))


if __name__ == "__main__":
    main()
