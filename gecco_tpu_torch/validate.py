"""Train the flagship from its seeded init on the procedural mixture and
score the EMA model's samples against held-out clouds: the port's
trained-magnitude check of its kernels (counterpart of
``scripts/validate_flagship.py``).

    python3 -m gecco_tpu_torch.validate --steps 4000 --eval-every 1000 --seed 0
    python3 -m gecco_tpu_torch.validate --device cpu --steps 3 --n-layers 2 \\
        --feature-dim 64 --num-inducers 16 --num-heads 4 --n-points 64 --batch 4 \\
        --eval-every 3 --eval-clouds 4 --sampler-steps 2

The model is the flagship (6 x 384, 64 inducers, 8 heads, bf16,
``attn_impl="folded_pallas"``) unless the flags cut it; the optimizer is
its configuration's (global-norm clip 1, AdaBelief at 3e-4 after a linear
warmup, cosine decay to 2% of it) and the EMA 0.999. Every ``--eval-every``
steps, and after the last, the EMA model samples ``--eval-clouds`` clouds
with the ``--sampler-steps``-step Heun sampler; they are scored against as
many held-out clouds (numpy seed 12345) by 1-NN accuracy, MMD and COV under
the Chamfer distance. One JSON line is printed (and appended to ``--out``)
per eval and per ``--log-every`` steps. Every random draw comes from
generators seeded by ``--seed``: the weights, the data, sigma and the
noise, the samplers' latents. Two trees run on the same seed see the same
draws; fp32 atomics still make one tree's runs differ. The run stops with
exit code 1 at the first non-finite loss.

    python3 -m gecco_tpu_torch.validate --control a.jsonl b.jsonl --change c.jsonl d.jsonl

decides the gate from such runs' lines instead of training: every run's
losses finite, and at every eval from step 2000 on the mean 1-NN of the
change's runs within 0.06 of the control runs' mean. It prints one JSON line
per eval step (the means, their difference, each side's spread: the largest
less the smallest of its runs) and a last line ``{"pass": ...}``; exit code
1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gecco_tpu_torch.benchmark import batched_pairwise_distance, cov, mmd, one_nn_accuracy
from gecco_tpu_torch.data import make_clouds
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.metrics import chamfer_distance
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.reparam import GaussianReparam
from gecco_tpu_torch.train import (
    adabelief,
    chain,
    clip_by_global_norm,
    make_ema,
    make_train_step,
    warmup_cosine_decay_schedule,
)
from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["build_model", "evaluate", "main", "parser", "run", "verdict"]

HELDOUT_SEED = 12345
GATE_BAND = 0.06  # the JAX gate's noise band for 1-NN
GATE_FROM_STEP = 2000
RUNS = Path(__file__).resolve().parents[1] / "runs"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--n-points", type=int, default=2048)
    ap.add_argument("--families", type=int, default=4)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--eval-clouds", type=int, default=64)
    ap.add_argument("--sampler-steps", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=1000)
    ap.add_argument("--n-layers", type=int, default=6)
    ap.add_argument("--feature-dim", type=int, default=384)
    ap.add_argument("--num-inducers", type=int, default=64)
    ap.add_argument("--num-heads", type=int, default=8)
    ap.add_argument("--attn-impl", default="folded_pallas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--out", default=None,
                    help="JSON-lines file to append to (default runs/validate_seed<seed>.jsonl)")
    ap.add_argument("--control", nargs="+", default=None,
                    help="the control tree's runs (JSON-lines files): decide the gate, no training")
    ap.add_argument("--change", nargs="+", default=None, help="the changed tree's runs")
    return ap


def build_model(args, device) -> Diffusion:
    """The flagship (or its cut) from the seeded init."""
    gen = torch.Generator().manual_seed(args.seed)
    backbone = SetTransformer(
        args.n_layers, args.feature_dim, args.num_inducers, embed_dim=1,
        num_heads=args.num_heads, compute_dtype=torch.bfloat16, attn_impl=args.attn_impl,
        device=device, generator=gen,
    )
    net = UnconditionalPointNetwork(backbone, args.feature_dim, device=device, generator=gen)
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002,
                               n_solver_steps=args.sampler_steps)
    return Diffusion(net, sched, reparam=GaussianReparam([0.0] * 3, [0.35] * 3, device=device))


def evaluate(model: Diffusion, heldout: torch.Tensor, generator: torch.Generator,
             n_solver_steps: int) -> dict:
    """Sample as many clouds as ``heldout`` [S, N, 3] holds and score them:
    1-NN accuracy (0.5 is ideal), MMD and COV under the Chamfer distance."""
    samples = model.sample(generator, tuple(heldout.shape), n_solver_steps=n_solver_steps)
    samples = samples.float()
    if not bool(torch.isfinite(samples).all()):
        return dict(one_nn=float("nan"), mmd=float("nan"), cov=float("nan"))
    ss = batched_pairwise_distance(samples, samples, chamfer_distance)
    sd = batched_pairwise_distance(samples, heldout, chamfer_distance)
    dd = batched_pairwise_distance(heldout, heldout, chamfer_distance)
    return dict(one_nn=one_nn_accuracy(ss, sd, dd), mmd=mmd(sd), cov=cov(sd))


def run(args, emit=print) -> list[dict]:
    """Train ``args.steps`` steps with evals; ``emit`` gets each record's
    JSON line. Returns the records; raises FloatingPointError at the first
    non-finite loss (after emitting a record that names its step)."""
    device = resolve_device(args.device)
    out = Path(args.out) if args.out else RUNS / f"validate_seed{args.seed}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    records = []

    def record(rec):
        records.append(rec)
        line = json.dumps(rec)
        with out.open("a") as f:
            f.write(line + "\n")
        emit(line)

    model = build_model(args, device)
    ema = make_ema(model)
    lr = warmup_cosine_decay_schedule(0.0, args.lr, args.warmup, args.steps,
                                      end_value=0.02 * args.lr)
    opt = chain(clip_by_global_norm(1.0), adabelief(lr))
    opt_state = opt.init(list(model.parameters()))
    step = make_train_step(opt, ema_alpha=0.999)
    data_rng = np.random.default_rng(args.seed)
    draws = torch.Generator(device=device).manual_seed(args.seed + 1)
    heldout = torch.from_numpy(make_clouds(np.random.default_rng(HELDOUT_SEED), args.eval_clouds,
                                           args.n_points, args.families)).to(device)

    t0 = time.perf_counter()
    window = []
    for n in range(1, args.steps + 1):
        points = torch.from_numpy(
            make_clouds(data_rng, args.batch, args.n_points, args.families)).to(device)
        loss, opt_state = step(model, ema, opt_state, points, draws)
        value = float(loss)
        window.append(value)
        if not np.isfinite(value):
            record(dict(step=n, loss=value, wall_s=time.perf_counter() - t0,
                        error="non-finite loss"))
            raise FloatingPointError(f"non-finite loss {value} at step {n}")
        if n % args.log_every == 0 or n == args.steps:
            record(dict(step=n, loss=value, loss_mean=float(np.mean(window)),
                        wall_s=time.perf_counter() - t0))
            window = []
        if n % args.eval_every == 0 or n == args.steps:
            gen = torch.Generator(device=device).manual_seed(1_000_003 * args.seed + n)
            scores = evaluate(ema, heldout, gen, args.sampler_steps)
            record(dict(step=n, loss=value, wall_s=time.perf_counter() - t0, **scores))
    return records


def verdict(control: list[list[dict]], change: list[list[dict]], band: float = GATE_BAND,
            from_step: int = GATE_FROM_STEP) -> tuple[list[dict], bool]:
    """The gate over runs of two trees on one seed (each run its records):
    one row per eval step from ``from_step`` on, and whether every run's
    losses are finite, every run has every eval, and each row's mean 1-NN
    of ``change`` lies within ``band`` of ``control``'s."""
    runs = control + change
    finite = all("error" not in r and np.isfinite(r["loss"]) for run in runs for r in run)
    evals = [{r["step"]: r["one_nn"] for r in run if "one_nn" in r} for run in runs]
    steps = sorted(set().union(*evals))
    rows = []
    ok = finite and bool(steps)
    for step in (s for s in steps if s >= from_step):
        if not all(step in e for e in evals):
            ok = False
            continue
        a = [e[step] for e in evals[:len(control)]]
        b = [e[step] for e in evals[len(control):]]
        diff = float(np.mean(b) - np.mean(a))
        ok &= bool(abs(diff) <= band)
        rows.append(dict(step=step, control=float(np.mean(a)), change=float(np.mean(b)),
                         diff=diff, control_spread=max(a) - min(a),
                         change_spread=max(b) - min(b), band=band))
    return rows, bool(ok and rows)


def _read_runs(paths) -> list[list[dict]]:
    return [[json.loads(line) for line in Path(p).read_text().splitlines() if line.strip()]
            for p in paths]


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.control or args.change:
        if not (args.control and args.change):
            print("validate: --control and --change go together", file=sys.stderr)
            return 2
        rows, passed = verdict(_read_runs(args.control), _read_runs(args.change))
        for row in rows:
            print(json.dumps(row))
        print(json.dumps({"pass": passed}))
        return 0 if passed else 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        run(args, emit=lambda line: print(line, flush=True))
    except FloatingPointError as err:
        print(f"validate: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
