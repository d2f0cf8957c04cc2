"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py                  # the full run, on the card
    python3 chip_smoke.py --rehearse       # control flow only, tiny, on the CPU

Phases (each raises on failure; nothing is caught):

1. environment: torch, nvcc, the card's name and power limit;
2. build: the four CUDA kernels of ``gecco_tpu_torch/csrc`` with nvcc for
   sm_90a, one process per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card, in
   bf16, at the flagship shapes (ordinary and drifted operands), the pool
   also at the 8k width; each one's time beside its plain version's, its
   bound and, for pool and unpool, per-head ``scaled_dot_product_attention``
   on the unfolded q/k/v as the library yardstick (used nowhere in the port);
4. main path: the flagship (6 x 384, 64 inducers, 8 heads, bf16,
   ``attn_impl="folded_pallas"``) from the port's seeded init samples
   2048-point clouds with the 128-step Heun grid through
   ``Diffusion.sample``; every kernel's launch count must equal
   6 layers x 2 x 127 evaluations; then, from one latent on an 8-step grid,
   the kernel path against the plain path (``attn_impl="xla"``).

It prints the kernels' JSON line, then the device line, last. It imports
nothing of JAX or of gecco_tpu, and fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gecco_tpu_torch import Diffusion, GaussianReparam, LogUniformSchedule  # noqa: E402
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork  # noqa: E402
from gecco_tpu_torch.ops import kernels  # noqa: E402
from gecco_tpu_torch.ops.kernels import _build  # noqa: E402
from gecco_tpu_torch.ops.kernels import folded_attention as fa  # noqa: E402
from gecco_tpu_torch.ops.kernels import hside as hs  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(n_layers=6, feature_dim=384, num_inducers=64, num_heads=8, n_points=2048)
SCALED_8K = dict(feature_dim=768, num_inducers=64, num_heads=16, n_points=8192)
N_STEPS = 128
BATCH = 64  # the flagship protocol of bench.py
GROUPS = 32
# kernel vs plain version, both bf16: max |kernel - plain| / max |plain|.
# Both round to bf16 (relative step 2^-8 = 3.9e-3) at their own points (the
# unpool folds se into wq before rounding, its plain twin normalises x
# first) and sum in other orders, so a few bf16 steps of the largest value.
TOL_OUT = 2e-2
# channel sums: fp32 over N points, with fp32 atomics across point tiles
TOL_SUMS = 1e-2
# sample_data after an 8-step grid, kernel path vs plain (xla) path, bf16
TOL_PATH = 5e-2

SOURCES = {
    "folded_pool_ext": ("gecco_tpu_torch/csrc/pool_ext.cu",
                        "gecco_tpu/ops/pallas/folded_attention.py:1154"),
    "fused_h_side": ("gecco_tpu_torch/csrc/hside.cu", "gecco_tpu/ops/pallas/hside.py:52"),
    "folded_unpool": ("gecco_tpu_torch/csrc/unpool.cu",
                      "gecco_tpu/ops/pallas/folded_attention.py:2222"),
    "fused_mlp_residual": ("gecco_tpu_torch/csrc/mlp.cu",
                           "gecco_tpu/ops/pallas/folded_attention.py:2798"),
}


def sh(*cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps=10, warmup=2) -> float:
    """Median milliseconds of one call: CUDA events around each call on the
    card, the host clock around each synchronised call elsewhere."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def rel_err(a, ref) -> float:
    a, ref = a.float(), ref.float()
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def abs_err(a, ref) -> float:
    return float((a.float() - ref.float()).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, bytes_: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------- operands --


def head_scales(c, heads, drift, device):
    """Per-channel scale: 1, or per head 60, 1, 0.1, 0.01 repeated, so one
    head's logits are ~60x another's and the heads' maxima sit >80 apart."""
    if not drift:
        return torch.ones(c, device=device)
    pattern = torch.tensor([60.0, 1.0, 0.1, 0.01], device=device)
    return pattern.repeat(heads // 4 + 1)[:heads].repeat_interleave(c // heads)


def pool_operands(g, b, n, c, heads, i, drift, device, dt):
    d = c // heads
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    x = r(b, n, c).to(dt)
    se = torch.ones(b, c, device=device) if drift else 1.0 + 0.1 * r(b, c)
    be = torch.zeros(b, c, device=device) if drift else 0.1 * r(b, c)
    kvw = r(2 * c, c) / c**0.5
    kvw[:c] *= head_scales(c, heads, drift, device)[:, None]
    return (x, se, be, r(heads * i, d).to(dt), kvw.to(dt), (r(c, c) / c**0.5).to(dt))


def hside_operands(g, b, i, c, w, drift, device, dt):
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    h0 = r(b, i, c) * (head_scales(c, 8, True, device) if drift else 1.0)
    aff = [1.0 + 0.2 * r(b, c), 0.2 * r(b, c), 1.0 + 0.2 * r(b, c), 0.2 * r(b, c)]
    return (h0.to(dt), *aff, fa.group_indicator(c, GROUPS, device),
            (r(c, w) / c**0.5).to(dt), 0.1 * r(1, w), (r(w, c) / w**0.5).to(dt), 0.1 * r(1, c),
            (r(c, c) / c**0.5).to(dt), (r(c, c) / c**0.5).to(dt))


def unpool_operands(g, b, n, c, heads, i, drift, device, dt):
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    se = torch.ones(b, c, device=device) if drift else 1.0 + 0.1 * r(b, c)
    be = torch.zeros(b, c, device=device) if drift else 0.1 * r(b, c)
    k = r(b, i, c) * head_scales(c, heads, drift, device)
    return (r(b, n, c).to(dt), se, be, k.to(dt), r(b, i, c).to(dt),
            (r(c, c) / c**0.5).to(dt), (r(c, c) / c**0.5).to(dt))


def mlp_operands(g, b, n, c, w, drift, device, dt):
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    x = r(b, n, c) * (head_scales(c, 8, True, device) if drift else 1.0)
    return (x.to(dt), 1.0 + 0.1 * r(b, c), 0.1 * r(b, c), (r(c, w) / c**0.5).to(dt),
            0.1 * r(1, w), (r(w, c) / w**0.5).to(dt), 0.1 * r(1, c))


# ------------------------------------------------------------ yardsticks --


def sdpa_pool(ops, heads):
    """Per-head SDPA of the inducer queries over the unfolded k/v."""
    x, se, be, ind2, kvw, _ = ops
    b, n, c = x.shape
    d = c // heads
    y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
    k, v = (y @ kvw.T).chunk(2, dim=-1)
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()
    q = ind2.reshape(heads, -1, d)[None].expand(b, -1, -1, -1).contiguous()
    k, v = split(k), split(v)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def sdpa_unpool(ops, heads):
    x, se, be, k, v, wq, _ = ops
    b, n, c = x.shape
    d = c // heads
    y = (x.float() * se[:, None] + be[:, None]).to(x.dtype)
    split = lambda t: t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()
    q, kk, vv = split(y @ wq.T), split(k), split(v)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, vv)


# ---------------------------------------------------------------- phases --


def check(name, err, tol):
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max|err|/max|ref| = {err:.3e} (tol {tol:.0e}) {status}")
    if err > tol:
        raise AssertionError(f"{name}: error {err:.3e} above tolerance {tol:.0e}")


def kernel_phase(device, shapes, big, dt, reps):
    """Every kernel against its plain version; returns per-kernel records."""
    g = torch.Generator(device=device).manual_seed(1)
    b, n, c, heads, i = shapes["batch"], shapes["n_points"], shapes["feature_dim"], \
        shapes["num_heads"], shapes["num_inducers"]
    w = 2 * c
    rec = {}

    def run(name, fn, ref, ops, nouts, flops, in_out, library=None):
        errs = []
        for drift in (False, True):
            args = ops(drift)
            got, want = fn(*args), ref(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            sync(device)
            tag = "drift" if drift else "ordinary"
            for q, (a, r) in enumerate(zip(got, want)):
                is_sums = q == 1 and nouts == 2
                check(f"{name} [{tag}] {'sums' if is_sums else f'out{q}'}",
                      rel_err(a, r), TOL_SUMS if is_sums else TOL_OUT)
                if not is_sums:
                    errs.append(abs_err(a, r))
        args = ops(False)
        ms = time_ms(lambda: fn(*args), device, reps)
        plain_ms = time_ms(lambda: ref(*args), device, max(2, reps // 4))
        lib_ms = time_ms(library(args), device, reps) if library else None
        bms, by = bound(flops, nbytes(*[a for a in args if torch.is_tensor(a)],
                                      *in_out(args)))
        rec[name] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms)
        lib_txt = f"{lib_ms:.3f}" if lib_ms is not None else "n/a"
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_txt} ms, "
              f"bound {bms:.3f} ms ({by})")

    d = c // heads
    j = heads * i
    run("folded_pool_ext", lambda *a: fa.folded_pool_ext(*a, heads),
        lambda *a: fa._pool_ext_ref(*a, heads),
        lambda drift: pool_operands(g, b, n, c, heads, i, drift, device, dt), 1,
        2 * b * n * c * j + 2 * b * n * c * c + 2 * b * n * j * d + 2 * b * i * c * c,
        lambda a: [torch.empty(b, i, c, dtype=dt)],
        lambda a: sdpa_pool(a, heads))
    run("fused_h_side", hs.fused_h_side, hs._hside_ref,
        lambda drift: hside_operands(g, b, i, c, w, drift, device, dt), 3,
        4 * b * i * c * w + 4 * b * i * c * c,
        lambda a: [torch.empty(3, b, i, c, dtype=dt)])
    run("folded_unpool", lambda *a: fa.folded_unpool(*a, heads),
        lambda *a: fa._unpool_ref(*a, heads),
        lambda drift: unpool_operands(g, b, n, c, heads, i, drift, device, dt), 2,
        4 * b * n * c * j + 4 * b * j * c * d,
        lambda a: [a[0], torch.empty(b, 2, c)],
        lambda a: sdpa_unpool(a, heads))
    run("fused_mlp_residual", fa.fused_mlp_residual, fa._mlp_ref,
        lambda drift: mlp_operands(g, b, n, c, w, drift, device, dt), 2,
        4 * b * n * c * w,
        lambda a: [a[0], torch.empty(b, 2, c)])

    # the pool at the 8k width (C = 768, 16 heads, 8192 points)
    bb, nn_, cc, hh, ii = big["batch"], big["n_points"], big["feature_dim"], \
        big["num_heads"], big["num_inducers"]
    for drift in (False, True):
        args = pool_operands(g, bb, nn_, cc, hh, ii, drift, device, dt)
        err = rel_err(fa.folded_pool_ext(*args, hh), fa._pool_ext_ref(*args, hh))
        check(f"folded_pool_ext 8k width [{'drift' if drift else 'ordinary'}] out0", err, TOL_OUT)
    return rec


def build_flagship(device, generator, n_layers, dt=torch.bfloat16):
    f = FLAGSHIP
    backbone = SetTransformer(
        n_layers, f["feature_dim"], f["num_inducers"], embed_dim=1, num_heads=f["num_heads"],
        compute_dtype=dt, attn_impl="folded_pallas", device=device, generator=generator,
    )
    net = UnconditionalPointNetwork(backbone, f["feature_dim"], device=device, generator=generator)
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=N_STEPS)
    return Diffusion(net, sched, reparam=GaussianReparam([0.0] * 3, [0.35] * 3, device=device))


def main_path(device, batch, n_points, n_layers, n_steps, compare_batch):
    model = build_flagship(device, torch.Generator().manual_seed(0), n_layers)
    gen = torch.Generator(device=device).manual_seed(0)
    # warm-up: one 2-step sample (first launches, allocator)
    model.sample(gen, (batch, n_points, 3), n_solver_steps=2)
    sync(device)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.sample(gen, (batch, n_points, 3), n_solver_steps=n_steps)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()

    if tuple(out.shape) != (batch, n_points, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sample: shape {tuple(out.shape)} or non-finite values")
    evals = 2 * (n_steps - 1)
    expected = n_layers * evals
    print(f"  sampled {tuple(out.shape)} in {seconds:.3f} s: {batch / seconds:.3f} clouds/s "
          f"({evals} denoiser evals, {1e3 * seconds / evals:.3f} ms each)")
    print(f"  launches per kernel (expected {expected}): {counts}")
    if device.type == "cuda" and any(v != expected for v in counts.values()):
        raise AssertionError(f"launch counts {counts} != {expected}")

    latent = model.schedule.sample_latent(gen, (compare_batch, n_points, 3), device)
    fused = model.sample_from_latent(latent, n_solver_steps=8)
    model.network.backbone.attn_impl = "xla"
    plain = model.sample_from_latent(latent, n_solver_steps=8)
    model.network.backbone.attn_impl = "folded_pallas"
    check("8-step sample, kernel path vs plain path", rel_err(fused, plain), TOL_PATH)
    return counts, dict(batch=batch, seconds=seconds, clouds_per_s=batch / seconds)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes on the CPU (plain versions), then exit 1 without a result")
    args = ap.parse_args()

    if args.rehearse:
        device = torch.device("cpu")
        shapes = dict(batch=2, n_points=128, feature_dim=64, num_inducers=16, num_heads=4)
        big = dict(batch=1, n_points=256, feature_dim=128, num_inducers=16, num_heads=8)
        dt, reps, n_layers, batch, n_points, n_steps = torch.bfloat16, 1, 2, 2, 128, 3
    else:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        device = torch.device("cuda")
        shapes = dict(FLAGSHIP, batch=64)
        big = dict(SCALED_8K, batch=2)
        dt, reps, n_layers, batch, n_points, n_steps = (
            torch.bfloat16, 20, FLAGSHIP["n_layers"], BATCH, FLAGSHIP["n_points"], N_STEPS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== environment")
    print(f"  torch {torch.__version__}, cuda {torch.version.cuda}")
    card = "cpu rehearsal"
    if device.type == "cuda":
        print("  " + sh(_build._nvcc(), "--version").splitlines()[-1])
        card = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
        card = card.splitlines()[0]

    print("== build")
    if device.type == "cuda":
        t0 = time.perf_counter()
        reports = _build.build_all()
        print(f"  nvcc sm_90a: {len(reports)} libraries built in {time.perf_counter() - t0:.1f} s")
        for name, text in reports.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    print(f"== kernels vs plain versions ({shapes}; 8k pool {big})")
    rec = kernel_phase(device, shapes, big, dt, reps)

    print(f"== main path: flagship x{n_layers} layers, batch {batch}, {n_points} points, "
          f"{n_steps}-step Heun")
    counts, path = main_path(device, batch, n_points, n_layers, n_steps, compare_batch=8)
    print(f"  {path['clouds_per_s']:.3f} clouds/s on {card}")

    line = {"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=counts[name], **rec[name])
        for name in SOURCES
    ]}
    if args.rehearse:
        print("rehearsal finished: no result on the CPU")
        sys.exit(1)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
