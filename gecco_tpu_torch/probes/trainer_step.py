"""Where the ``Trainer``'s step loses time against the bare train step:
the flagship config's model (6 x 384, bf16, ``folded_pallas``) at batch 48
and 2048 points on the card, 20 steps a variant, host clock (a sync after
the last step), the variants in turns (forwards, then backwards):

- ``bare``: ``make_train_step`` on one batch already on the card, one
  generator (``chip_smoke.py`` phase 8's step);
- ``+generator``: a generator made and seeded each step, as
  ``Trainer.step_generator`` does;
- ``+copy``: the batch copied from numpy each step (``types.to_device``:
  pinned memory, a non-blocking copy);
- ``trainer``: ``Trainer.fit`` over numpy batches already in memory (no
  loader thread; the checkpoint writes skipped);
- ``trainer+loader``: ``Trainer.fit`` over the config's loader (its
  prefetch thread reading a PointFlow tree of procedural clouds written to
  a temporary directory).

    python3 -m gecco_tpu_torch.probes.trainer_step     # card only, ~2 min
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gecco_tpu_torch.config import load_config
from gecco_tpu_torch.data import make_clouds
from gecco_tpu_torch.train import flagship_optimizer, make_ema, make_train_step
from gecco_tpu_torch.train import trainer as trainer_mod
from gecco_tpu_torch.types import Example, to_device

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "shapenet_airplane_unconditional.py"
STEPS, BATCH, N_POINTS, CLOUDS = 20, 48, 2048, 96


class _NoSave(trainer_mod.Trainer):
    """The Trainer without its checkpoint writes (their disk time is not
    the step's)."""

    def save(self, dirname: str, step: int):
        pass


def _bare(model, device, copy: bool, fresh_generator: bool, batches):
    opt = flagship_optimizer()
    ema, state = make_ema(model), opt.init(list(model.parameters()))
    step = make_train_step(opt, ema_alpha=0.999)
    gen = torch.Generator(device=device).manual_seed(0)
    on_card = torch.from_numpy(batches[0].points).to(device)

    def run():
        nonlocal state
        for q in range(STEPS):
            pts = to_device(batches[q % len(batches)], device).points if copy else on_card
            g = torch.Generator(device=device).manual_seed(q) if fresh_generator else gen
            _, state = step(model, ema, state, pts, g)
        torch.cuda.synchronize(device)
    return run


def _trainer(config, model, device, loader_fn, run_dir):
    def run():
        t = _NoSave(model=model, train_dataloader=loader_fn(), val_dataloader=[],
                    save_path=str(run_dir), save_every=10**9, num_steps=STEPS - 1,
                    optimizer=flagship_optimizer(config.NUM_STEPS), skip_smoke_test=True,
                    device=device)
        t.fit()
        torch.cuda.synchronize(device)
    return run


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes.trainer_step: no CUDA device")
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tempfile.mkdtemp(prefix="gecco-trainer-step-"))
    keep_root = os.environ.get("SHAPENET_PF_ROOT")
    try:
        rng = np.random.default_rng(0)
        for split in ("train", "val"):
            d = tmp / "data" / "02691156" / split
            d.mkdir(parents=True)
            for q, cloud in enumerate(make_clouds(rng, CLOUDS, N_POINTS)):
                np.save(d / f"cloud{q:04d}.npy", cloud)
        os.environ["SHAPENET_PF_ROOT"] = str(tmp / "data")
        config = load_config(str(CONFIG))
        model = config.make_model(torch.Generator().manual_seed(0)).to(device)
        batches = [Example(make_clouds(rng, BATCH, N_POINTS)) for _ in range(4)]
        variants = {
            "bare": _bare(model, device, False, False, batches),
            "+generator": _bare(model, device, False, True, batches),
            "+copy": _bare(model, device, True, False, batches),
            "trainer": _trainer(config, model, device,
                                lambda: [batches[q % len(batches)] for q in range(STEPS)],
                                tmp / "a"),
            "trainer+loader": _trainer(config, model, device, config.make_train_loader,
                                       tmp / "b"),
        }
        for run in variants.values():  # warm-up: first launches, allocator, the loader
            run()
        times = {k: [] for k in variants}
        for order in (list(variants), list(reversed(variants))):
            for k in order:
                t0 = time.perf_counter()
                variants[k]()
                times[k].append(1e3 * (time.perf_counter() - t0) / STEPS)
        card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
        print(f"ms/step over {STEPS} steps at batch {BATCH}, {N_POINTS} points, two passes in "
              f"turns, on {card.strip()}:")
        for k, v in times.items():
            print(f"  {k:15s} {' '.join(f'{x:.3f}' for x in v)}")
    finally:
        if keep_root is None:
            os.environ.pop("SHAPENET_PF_ROOT", None)
        else:
            os.environ["SHAPENET_PF_ROOT"] = keep_root
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
