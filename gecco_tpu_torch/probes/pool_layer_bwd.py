"""The resident pool's backward: its Hopper body pass by pass, beside its
WMMA body, timed and split by launch.

    python3 -m gecco_tpu_torch.probes.pool_layer_bwd

``csrc/pool_bwd.cu`` runs the dpool product (bf16(g Wo) for all heads), the
t kernel (t = sum_d dpool P and merged = bf16(P)), dWo's weight gradient, the
main pass (per 64-point tile and group of eight heads: s, v, p, dp, ds and
dv), the dy product (dx, or the fp32 dy and its column sums' partials), with
the pre-norm the column sums and the dx kernel, and the dqf and dWv weight
gradients. At the flagship's training shapes (B 48, N 2048, C 384, 8 heads,
64 inducers), the 8k width (B 2, N 8192, C 768, 16 heads), 256 inducers
and N 2000, with and without the pre-norm, ordinary and with drifted
logits, this holds each pass's output against its plain piece fed the
kernel's own inputs to that pass (so a fault shows in the pass that makes
it), the whole against the TPU algebra's plain pieces composed
(``_pool_layer_bwd_pieces``) and the plain version, and requires every
output to be the same bits in two calls. It times the Hopper body and the
WMMA body in turns (20 calls each, CUDA events around each wrapper call),
splits both bodies' device time by launch with ``torch.profiler``, and
reads SDPA's backward on the unfolded q/k/v beside them in device time. It
prints the card's name and power limit and one JSON line, and raises after
printing if a check fails. Needs the card.
"""

from __future__ import annotations

import json
import subprocess

import torch

from gecco_tpu_torch.ops.kernels import folded_attention as fa
from gecco_tpu_torch.probes.pool_bwd import launch_split, rel, timed
from gecco_tpu_torch.probes.pool_layer import operands

# (B, N, C, H, I)
SHAPES = {"flagship": (48, 2048, 384, 8, 64), "8k width": (2, 8192, 768, 16, 64),
          "I 256": (48, 2048, 384, 8, 256), "N 2000": (48, 2000, 384, 8, 64)}
# each pass against its plain piece on the kernel's inputs: the bf16 outputs
# within a few bf16 steps (2^-8) of the largest value (a logit summed in
# another order can flip p's rounding), the fp32 ones (t, dy) fp32 sums in
# other orders, dscale and dbias residues of cancelling sums over N
# (chip_smoke.py's TOL_AFFINE)
TOL_PASS, TOL_FP32, TOL_AFFINE = 2e-2, 1e-3, 3e-2
FP32_PASSES = ("tacc", "dy")
# the whole against the TPU algebra's pieces composed (the same roundings,
# sums in other orders: chip_smoke.py's TOL_ALGEBRA_GRAD, TOL_AFFINE for
# dscale and dbias) and against the plain version (TOL_GRAD; the drifted
# dbias departs from it by the algebra itself: TOL_POOL_DRIFT_DBE)
TOL_ALGEBRA, TOL_GRAD, TOL_DRIFT_DBIAS = 1e-2, 3e-2, 1e-1
NAMES = ("dx", "dscale", "dbias", "dind2", "dkvw", "dwo")


def saved(ops, heads, prenorm, gen) -> tuple:
    """The forward's saved tensors (its Hopper body: mean, inv, (M, L, P,
    y)) and the cotangents of h0, mean_c and inv_c."""
    x = ops[0]
    b, _, c = x.shape
    i = ops[3].shape[0] // heads
    _, mean, inv, fwd = fa._pool_layer_launch(*ops, heads, prenorm, True)
    r = lambda *s: torch.randn(*s, generator=gen, device=x.device)
    return mean, inv, fwd, ((0.1 * r(b, i, c)).to(x.dtype), 1e-2 * r(b, c), 1e-2 * r(b, c))


def passes(ops, heads, prenorm, args) -> tuple:
    """Each pass of the Hopper body against its plain piece on the kernel's
    own inputs -> (max|err|/max|ref| per pass, the call's outputs)."""
    x, scale, _, ind2, kvw, wo, gind = ops
    mean, inv, (m, l, pacc, y), cot = args
    mid = {}
    outs = fa._pool_layer_bwd_launch(*ops, mean, inv, m, l, pacc, y, *cot, heads, prenorm,
                                     body="hopper", mid=mid)
    n_valid = x.shape[1]
    n = mid["ds"].shape[1]
    nv = n_valid if n_valid < n else None
    xp, yp = fa._pad_points(x, n), fa._pad_points(y, n)
    g = cot[0].to(x.dtype)
    dpool, _, merged = fa._pool_layer_bwd_fold_ref(g, wo, pacc, heads)
    tacc = fa._pool_layer_bwd_t_ref(mid["dpool"], pacc, heads)
    ds, dv = fa._pool_layer_bwd_tiles_ref(yp, mid["qft"], kvw, m, l, mid["dpool"], mid["tacc"],
                                          heads, nv)
    dy = fa._pool_layer_bwd_dy_ref(mid["ds"], mid["dv"], mid["qft"], kvw)
    dx, dscale, dbias = fa._pool_layer_bwd_dx_ref(
        xp, mid["dy"] if prenorm else dy, mean, inv, scale, cot[1].float(), cot[2].float(),
        gind.shape[1], prenorm, nv)
    dqf, dwv, dwo = fa._pool_layer_bwd_wgrad_ref(yp, mid["ds"], mid["dv"], g, mid["merged"])
    dind2, dkvw = fa._chain_dqf(dqf, dwv, ind2, kvw, heads)
    errs = {"dpool": rel(mid["dpool"], dpool), "tacc": rel(mid["tacc"], tacc),
            "merged": rel(mid["merged"], merged), "ds": rel(mid["ds"], ds),
            "dv": rel(mid["dv"], dv), "dx": rel(outs[0], dx[:, :n_valid]),
            "dind2": rel(outs[3], dind2), "dkvw": rel(outs[4], dkvw),
            "dwo": rel(outs[5], dwo.to(wo.dtype))}
    if prenorm:
        errs.update(dy=rel(mid["dy"], dy), dscale=rel(outs[1], dscale),
                    dbias=rel(outs[2], dbias))
    return errs, outs


def pass_failures(errs: dict) -> list:
    """The passes beyond their tolerances."""
    tol = lambda k: (TOL_FP32 if k in FP32_PASSES
                     else TOL_AFFINE if k in ("dscale", "dbias") else TOL_PASS)
    return [f"{k} {v:.3e}" for k, v in errs.items() if not v <= tol(k)]


def check_shape(ops, heads, gen, failed: list, tag: str, drift: bool) -> dict:
    """With and without the pre-norm: the passes, the whole against the TPU
    algebra's pieces and the plain version, and the same bits in two calls
    (every output); returns the errors."""
    out = {}
    for prenorm in (True, False):
        what = f"{tag}, {'prenorm' if prenorm else 'no pre-norm'}"
        args = saved(ops, heads, prenorm, gen)
        errs, first = passes(ops, heads, prenorm, args)
        failed += [f"{what} pass {f}" for f in pass_failures(errs)]
        mean, inv, fwd, cot = args
        # the pieces on the stream zero-padded as the kernels see it
        n_valid, n_pad = ops[0].shape[1], fwd[3].shape[1]
        alg = fa._pool_layer_bwd_pieces(fa._pad_points(ops[0], n_pad), *ops[1:], mean, inv,
                                        *fwd, *cot, heads, prenorm,
                                        n_valid if n_valid < n_pad else None)
        alg = (alg[0][:, :n_valid], *alg[1:])
        plain = fa._pool_layer_bwd_ref(*ops, *cot, heads, prenorm)
        whole = {}
        for k, a, ra, rp in zip(NAMES, first, alg, plain):
            if not prenorm and k in ("dscale", "dbias"):
                continue
            affine = k in ("dscale", "dbias")
            whole[k] = (rel(a, ra), rel(a, rp))
            lim_p = TOL_DRIFT_DBIAS if drift and k == "dbias" else (
                TOL_AFFINE if affine else TOL_GRAD)
            if not (whole[k][0] <= (TOL_AFFINE if affine else TOL_ALGEBRA)
                    and whole[k][1] <= lim_p):
                failed.append(f"{what} {k}: {whole[k][0]:.3e} from the algebra, "
                              f"{whole[k][1]:.3e} from the plain version")
        second = passes(ops, heads, prenorm, args)[1]
        same = all(torch.equal(a, z) for a, z in zip(first, second))
        if not same:
            failed.append(f"{what}: two calls differ")
        print(f"  {what}: passes " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + "; whole (against the algebra, the plain version) "
              + ", ".join(f"{k} {a:.3e}/{p:.3e}" for k, (a, p) in whole.items())
              + f"; {'the same bits' if same else 'DIFFERENT bits'} in two calls")
        out["prenorm" if prenorm else "raw"] = dict(passes=errs, whole=whole, same_bits=same)
    return out


def sdpa_bwd(ops, heads, gen):
    """SDPA's backward on the unfolded q/k/v of the pool without its
    pre-norm (``chip_smoke.py``'s yardstick): one call, ``torch.profiler``
    reads its device time."""
    import torch.nn.functional as F

    x, _, _, ind2, kvw, _, _ = ops
    b, n, c = x.shape
    j, d = ind2.shape
    i = j // heads
    q = ind2.reshape(heads, i, d)[None].expand(b, heads, i, d).contiguous().requires_grad_(True)
    kv = torch.einsum("bnc,oc->bno", x, kvw)
    k = kv[..., :c].reshape(b, n, heads, d).transpose(1, 2).contiguous().requires_grad_(True)
    v = kv[..., c:].reshape(b, n, heads, d).transpose(1, 2).contiguous().requires_grad_(True)
    o = F.scaled_dot_product_attention(q, k, v)
    gg = torch.randn(o.shape, generator=gen, device=x.device).to(o.dtype)
    return lambda: torch.autograd.grad(o, (q, k, v), gg, retain_graph=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.pool_layer_bwd: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    failed, result = [], {}
    med = lambda t: (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2
    for name, (b, n, c, heads, i) in SHAPES.items():
        body = fa._pool_layer_bwd_body(b, n, c, heads, i)
        if body != "hopper":
            failed.append(f"{name}: the switch picks {body}")
            continue
        rec = {}
        for drift in (False, True):
            ops = operands(gen, b, n, c, heads, i, drift, dev)
            rec["drift" if drift else "ordinary"] = check_shape(
                ops, heads, gen, failed, f"{name}, {'drift' if drift else 'ordinary'}", drift)
        ops = operands(gen, b, n, c, heads, i, False, dev)
        wmma_takes = fa._pool_layer_bwd_smem(c, fa._i_pad(i), c // heads) <= fa._MAX_SMEM
        for prenorm in (True, False):
            key = "prenorm" if prenorm else "raw"
            args = saved(ops, heads, prenorm, gen)
            mean, inv, fwd, cot = args
            run = lambda body: (lambda: fa._pool_layer_bwd_launch(*ops, mean, inv, *fwd, *cot,
                                                                  heads, prenorm, body=body))
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
            if not prenorm:
                t["sdpa_backward_device_ms"] = sum(launch_split(sdpa_bwd(ops, heads,
                                                                         gen)).values())
            print(f"  {name}, {key}: hopper {t['hopper_ms']:.3f} ms ({th[0]:.3f}-{th[-1]:.3f}), "
                  f"device {t['device_ms']:.3f} ms ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + ")"
                  + (f"; wmma {t['wmma_ms']:.3f} ms, device {t['wmma_device_ms']:.3f} ms"
                     if "wmma_ms" in t else "")
                  + (f"; sdpa backward device {t['sdpa_backward_device_ms']:.3f} ms"
                     if "sdpa_backward_device_ms" in t else ""))
            rec[f"times_{key}"] = t
        result[name] = rec
    print(card)
    print(json.dumps(result))
    if failed:
        raise AssertionError("probes.pool_layer_bwd: " + "; ".join(failed))


if __name__ == "__main__":
    main()
