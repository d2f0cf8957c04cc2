"""Two source trees of the port side by side on one card: the flagship
sampler and train step, the upsample demo model's evaluation, and each
fused function's device time, tree by tree in the order given.

    python3 gecco_tpu_torch/probes/trees.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout (``git archive`` of a commit, say):
for each, in turn, a fresh process imports that tree's ``chip_smoke.py``
and package (its kernels built from its own sources) and measures
(1) ``chip_smoke.main_path``: the flagship (6 x 384, 64 inducers, 8
heads, bf16, ``folded_pallas``) samples 64 clouds of 2048 points with the
128-step Heun grid after a 2-step warm-up, host clock to a synchronize,
and its 8-step sample against the plain path; (2) the device milliseconds
of one of the sampler's evaluations at batch 64 (``torch.profiler``, 10
evaluations after 3); (3) ``chip_smoke.train_phase``: the flagship's
train step at batch 48 (its gradient against the plain path, 3 + 20
steps, the device's busy milliseconds per step over 3 profiled steps);
(4) the upsample demo's model (``chip_smoke.DEMO``: 3 x 128, 64
inducers, 4 heads of 32) sampling 48 clouds as (1) does, each function
through the body the tree's switches pick for it, and the device
milliseconds of one of its evaluations at batch 48 (10 evaluations
after 3); (5) the demo model's train step at batch 48 as (3) measures
the flagship's (``demo_train_*``), each function through the body the
tree's switches pick for it; (6) the device milliseconds per call
(``torch.profiler``, 20 calls after 3) of the pool, h-side, unpool and
MLP forwards at batch 64 and of the three folded backwards at batch 48,
on operands drawn as ``chip_smoke.py`` draws them, of the pool, unpool
and MLP forwards and backwards at the demo's width and batch 48
(``*_demo``, each through the body the tree's switch picks), and of the pool and unpool backwards with three heads at
the flagship's width and batch 48 (``*_heads3``). It prints one JSON line
per tree and the card's name and power limit. Run by file path,
not with ``-m``, so that each tree's package is the one imported. Needs
the card.

    python3 gecco_tpu_torch/probes/trees.py --per-head PARENT CHANGE CHANGE PARENT

measures instead, tree by tree: the device milliseconds of one of the
flagship's sampler evaluations at batch 64 (as (2)) and of its train step
at batch 48 (as (3)), then the same of the per-head flagship
(``attn_impl="pallas"``: the rect attention's forward and backward
kernels, the rest cuBLAS and PyTorch), its step's gradient held as
``chip_smoke.py`` holds it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def profiled_ms(fn, calls, warmup=3) -> float:
    """Device milliseconds per call of ``fn`` (``torch.profiler``, the
    device's own events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def measure(tree: str) -> dict:
    """The measurements of one tree, in this process (its package first on
    the path)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"imported {cs.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, sample, _ = cs.main_path(dev, cs.BATCH, cs.FLAGSHIP["n_points"], cs.FLAGSHIP["n_layers"],
                                cs.N_STEPS, compare_batch=8)
    model = cs.build_flagship(dev, torch.Generator().manual_seed(0), cs.FLAGSHIP["n_layers"])
    x = model.schedule.sample_latent(torch.Generator(device=dev).manual_seed(2),
                                     (cs.BATCH, cs.FLAGSHIP["n_points"], 3), dev)
    sigma = torch.full((cs.BATCH,), 10.0, device=dev)
    with torch.no_grad():
        eval_device_ms = profiled_ms(lambda: model.denoise(sigma, x), 10)
    del model
    dd = cs.DEMO
    shape = (cs.DEMO_BATCH, dd["n_points"], dd["feature_dim"], dd["num_heads"],
             dd["num_inducers"])
    # a body's counter: the wrapper's own for "hopper", "<name>_<body>" else
    picked = lambda name, body: name if body == "hopper" else f"{name}_{body}"
    names = (picked("folded_pool_ext", cs.fa._pool_ext_body(*shape)), "fused_h_side",
             picked("folded_unpool", cs.fa._unpool_body(*shape)),
             picked("fused_mlp_residual", cs.fa._mlp_body(*shape[:3], 2 * shape[2])))
    _, demo_sample, _ = cs.main_path(
        dev, cs.DEMO_BATCH, dd["n_points"], dd["n_layers"], cs.N_STEPS, compare_batch=8,
        what="demo model's kernel path", dims=dd,
        expect=lambda evals: {k: dd["n_layers"] * evals for k in names})
    demo = cs.build_flagship(dev, torch.Generator().manual_seed(0), dd["n_layers"], dims=dd)
    xd = demo.schedule.sample_latent(torch.Generator(device=dev).manual_seed(2),
                                     (cs.DEMO_BATCH, dd["n_points"], 3), dev)
    sigma_d = torch.full((cs.DEMO_BATCH,), 10.0, device=dev)
    with torch.no_grad():
        demo_eval_device_ms = profiled_ms(lambda: demo.denoise(sigma_d, xd), 10)
    del demo
    _, train = cs.train_phase(dev, cs.FLAGSHIP["n_layers"], cs.TRAIN_BATCH,
                              cs.FLAGSHIP["n_points"], "the card", (3, 20))
    tshape = (cs.TRAIN_BATCH, *shape[1:])
    step_names = names + (
        picked("folded_pool_ext_bwd", cs.fa._pool_ext_bwd_body(*tshape)),
        picked("folded_unpool_bwd", cs.fa._unpool_bwd_body(*tshape)),
        picked("fused_mlp_residual_bwd", cs.fa._mlp_bwd_body(*tshape[:3], 2 * tshape[2])))
    _, demo_train = cs.train_phase(
        dev, dd["n_layers"], cs.TRAIN_BATCH, dd["n_points"], "the card", (3, 20), dims=dd,
        expect=lambda timed: {k: dd["n_layers"] * timed for k in step_names})
    fa, hs, dt = cs.fa, cs.hs, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    b, tb, n, c, h, i, w = 64, 48, 2048, 384, 8, 64, 768
    pool = cs.pool_operands(g, b, n, c, h, i, False, dev, dt)
    hside = cs.hside_operands(g, b, i, c, w, False, dev, dt)
    unpool = cs.unpool_operands(g, b, n, c, h, i, False, dev, dt)
    mlp = cs.mlp_operands(g, b, n, c, w, False, dev, dt)
    bpool = cs.pool_operands(g, tb, n, c, h, i, False, dev, dt)
    _, qft, macc, sacc = fa._pool_ext_launch(*bpool, h, True)
    gh = (0.1 * r(tb, i, c)).to(dt)
    bunpool = cs.unpool_operands(g, tb, n, c, h, i, False, dev, dt)
    bmlp = cs.mlp_operands(g, tb, n, c, w, False, dev, dt)
    gg, gs = (0.1 * r(tb, n, c)).to(dt), 1e-3 * r(tb, 2, c)
    db, dc, dh = cs.DEMO_BATCH, dd["feature_dim"], dd["num_heads"]
    dpool = cs.pool_operands(g, db, n, dc, dh, i, False, dev, dt)
    dunpool = cs.unpool_operands(g, db, n, dc, dh, i, False, dev, dt)
    dmlp = cs.mlp_operands(g, db, n, dc, 2 * dc, False, dev, dt)
    dmlp_b = cs.mlp_operands(g, tb, n, dc, 2 * dc, False, dev, dt)
    dgg, dgs = (0.1 * r(tb, n, dc)).to(dt), 1e-3 * r(tb, 2, dc)
    # the backwards at the demo's width and with three heads (batch 48)
    bwd_cases = {}
    for key, (cc, hh) in (("demo", (dc, dh)), ("heads3", (c, 3))):
        ops = cs.pool_operands(g, tb, n, cc, hh, i, False, dev, dt)
        stats = fa._pool_ext_launch(*ops, hh, True)[1:]
        uops = cs.unpool_operands(g, tb, n, cc, hh, i, False, dev, dt)
        cots = ((0.1 * r(tb, i, cc)).to(dt), (0.1 * r(tb, n, cc)).to(dt), 1e-3 * r(tb, 2, cc))
        bwd_cases[key] = (ops, stats, uops, cots, hh)
    runs = {
        "folded_pool_ext": lambda: fa.folded_pool_ext(*pool, h),
        "fused_h_side": lambda: hs.fused_h_side(*hside),
        "folded_unpool": lambda: fa.folded_unpool(*unpool, h),
        "fused_mlp_residual": lambda: fa.fused_mlp_residual(*mlp),
        "folded_pool_ext_bwd": lambda: fa.folded_pool_ext_bwd(*bpool, qft, macc, sacc, gh, h),
        "folded_unpool_bwd": lambda: fa.folded_unpool_bwd(*bunpool, gg, gs, h),
        "fused_mlp_residual_bwd": lambda: fa.fused_mlp_residual_bwd(*bmlp, gg, gs),
        "folded_pool_ext_demo": lambda: fa.folded_pool_ext(*dpool, dh),
        "folded_unpool_demo": lambda: fa.folded_unpool(*dunpool, dh),
        "fused_mlp_residual_demo": lambda: fa.fused_mlp_residual(*dmlp),
        "fused_mlp_residual_bwd_demo": lambda: fa.fused_mlp_residual_bwd(*dmlp_b, dgg, dgs),
        **{f"{name}_{key}": fn for key, (ops, stats, uops, cots, hh) in bwd_cases.items()
           for name, fn in (
               ("folded_pool_ext_bwd",
                lambda o=ops, s=stats, ct=cots, h_=hh: fa.folded_pool_ext_bwd(*o, *s, ct[0], h_)),
               ("folded_unpool_bwd",
                lambda o=uops, ct=cots, h_=hh: fa.folded_unpool_bwd(*o, *ct[1:], h_)))},
    }
    device_ms = {name: profiled_ms(fn, 20) for name, fn in runs.items()}
    return {"clouds_per_s": sample["clouds_per_s"], "eval_ms": sample["eval_ms"],
            "eval_device_ms": eval_device_ms, "demo_clouds_per_s": demo_sample["clouds_per_s"],
            "demo_eval_device_ms": demo_eval_device_ms,
            "train_ms_per_step": train["ms_per_step"],
            "train_device_ms_per_step": train["device_ms_per_step"],
            "demo_train_ms_per_step": demo_train["ms_per_step"],
            "demo_train_device_ms_per_step": demo_train["device_ms_per_step"],
            "device_ms": device_ms}


def measure_per_head(tree: str) -> dict:
    """The flagship's and the per-head flagship's evaluation and train
    step, device milliseconds, in this process (the tree's package first on
    the path)."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"imported {cs.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for impl, key in (("folded_pallas", ""), ("pallas", "per_head_")):
        model = cs.build_flagship(dev, torch.Generator().manual_seed(0), cs.FLAGSHIP["n_layers"],
                                  attn_impl=impl)
        x = model.schedule.sample_latent(torch.Generator(device=dev).manual_seed(2),
                                         (cs.BATCH, cs.FLAGSHIP["n_points"], 3), dev)
        sigma = torch.full((cs.BATCH,), 10.0, device=dev)
        with torch.no_grad():
            out[f"{key}eval_device_ms"] = profiled_ms(lambda: model.denoise(sigma, x), 10)
        del model
        _, train = cs.train_phase(dev, cs.FLAGSHIP["n_layers"], cs.TRAIN_BATCH,
                                  cs.FLAGSHIP["n_points"], "the card", (3, 20), attn_impl=impl)
        out[f"{key}train_device_ms_per_step"] = train["device_ms_per_step"]
        out[f"{key}train_ms_per_step"] = train["ms_per_step"]
    return out


def main():
    per_head = len(sys.argv) > 1 and sys.argv[1] == "--per-head"
    args = sys.argv[2:] if per_head else sys.argv[1:]
    if len(args) > 1 and args[0] == "--one":
        fn = measure_per_head if per_head else measure
        print(json.dumps({"tree": args[1], **fn(os.path.abspath(args[1]))}))
        return
    if not args:
        raise SystemExit(__doc__)
    for tree in args:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *(["--per-head"] if per_head else []), "--one", tree],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"probes.trees on {tree}:\n{res.stdout}\n{res.stderr}")
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
