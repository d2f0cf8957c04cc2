"""Batch unconditional inference CLI (counterpart of
``gecco_tpu/infer/__main__.py``):

    python -m gecco_tpu_torch.infer <config.py> [checkpoint-dir] [--sampler ode|sde]
        [--n-samples N] [--n-points N] [--batch-size B] [--n-solver-steps N]
        [--s-churn S] [--seed S] [--output samples.npz] [--device cpu]

rebuilds the model from the config, loads the checkpoint's EMA weights
(the newest checkpoint next to the config by default), samples in batches
through ``Diffusion.sample`` (``ode``) or ``sample_stochastic`` (``sde``)
on the card unless ``--device`` names another, and writes one npz.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gecco_tpu_torch.config import latest_checkpoint, load_config
from gecco_tpu_torch.utils.modules import resolve_device


def load_ema_model(make_model, checkpoint_dir: str, device=None):
    """The config's model with a checkpoint's EMA weights, on ``device``
    (the card unless another is named), in inference mode."""
    device = resolve_device(device)
    model = make_model(torch.Generator().manual_seed(0)).to(device)
    state = torch.load(os.path.join(os.path.abspath(checkpoint_dir), "ema.pt"),
                       map_location=device)
    model.load_state_dict(state)
    return model.eval()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Sample from a trained model")
    parser.add_argument("config", help="path to the training config .py")
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help="checkpoint dir (default: the newest next to the config)")
    parser.add_argument("--sampler", choices=("ode", "sde"), default="ode")
    parser.add_argument("--n-samples", type=int, default=64)
    parser.add_argument("--n-points", type=int, default=2048)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--n-solver-steps", type=int, default=None)
    parser.add_argument("--s-churn", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output", default="samples.npz")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    config = load_config(os.path.abspath(args.config))
    checkpoint = args.checkpoint or latest_checkpoint(os.path.dirname(os.path.abspath(args.config)))
    model = load_ema_model(config.make_model, checkpoint, args.device)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(args.seed)
    shape = (args.batch_size, args.n_points, 3)
    chunks = []
    remaining = args.n_samples
    while remaining > 0:
        if args.sampler == "ode":
            out = model.sample(generator, shape, n_solver_steps=args.n_solver_steps)
        else:
            out = model.sample_stochastic(generator, shape, s_churn=args.s_churn,
                                          n_solver_steps=args.n_solver_steps)
        chunks.append(out.float().cpu().numpy())
        remaining -= args.batch_size
    samples = np.concatenate(chunks, axis=0)[: args.n_samples]
    np.savez(args.output, samples=samples)
    print(f"Wrote {samples.shape} samples to {args.output}")
    return samples


if __name__ == "__main__":
    main()
