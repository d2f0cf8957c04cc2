"""Convert a reference gecco-jax EMA checkpoint (``.eqx``) into the port's
checkpoint layout (counterpart of ``scripts/convert_ref_checkpoint.py``):

    python -m gecco_tpu_torch.compat.convert_ref_checkpoint shapenet_airplane.eqx \\
        --out RUN_DIR [--device cpu]
    python -m gecco_tpu_torch.infer RUN_DIR/config.py --n-samples 64

The released weights (``https://datasets.epfl.ch/gecco-weights/``, e.g.
``shapenet_airplane.eqx``) are fetched by hand. The architecture defaults
to the flagship's (6 layers of 384 channels, 64 inducers, 8 heads,
sigma_max 165, bf16 on ``folded_pallas``); the flags override it to match
another checkpoint. The model is built with ``ref_jax_compat=True``, the
function those weights compute (each layer's second MLP on the un-normed
stream). The run directory gets ``checkpoint-step-0`` with ``model.pt`` and
``ema.pt`` (both the EMA weights: the reference ships no others; no
optimizer state) and ``meta.json`` naming the source, as the port's
``Trainer`` writes them, and a ``config.py`` whose ``make_model`` rebuilds
the architecture, so that the infer CLI samples the checkpoint next to it.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from gecco_tpu_torch.compat.eqx_io import load_flagship_from_eqx
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.reparam import GaussianReparam
from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["build_model", "convert", "write_checkpoint"]

FLAGSHIP = dict(n_layers=6, feature_dim=384, num_inducers=64, num_heads=8, sigma_max=165.0)


def build_model(n_layers=6, feature_dim=384, num_inducers=64, num_heads=8, sigma_max=165.0,
                reparam_mean=(0.0, 0.0, 0.0), reparam_std=(0.35, 0.35, 0.35), *,
                generator=None, device=None) -> Diffusion:
    """The compat flagship (or the architecture given), its weights drawn
    from ``generator``, on ``device`` (the card unless another is named)."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    backbone = SetTransformer(
        n_layers, feature_dim, num_inducers, embed_dim=1, num_heads=num_heads,
        compute_dtype=torch.bfloat16, attn_impl="folded_pallas", ref_jax_compat=True,
        device=device, generator=generator,
    )
    net = UnconditionalPointNetwork(backbone, feature_dim, device=device, generator=generator)
    sched = LogUniformSchedule(sigma_max=sigma_max, sigma_min=0.002, n_solver_steps=128)
    return Diffusion(net, sched, reparam=GaussianReparam(list(reparam_mean), list(reparam_std),
                                                          device=device))


def convert(eqx_path: str, device=None, **arch) -> Diffusion:
    """``build_model(**arch)`` with the checkpoint's weights (its reparam
    statistics among them)."""
    return load_flagship_from_eqx(build_model(device=device, **arch), eqx_path)


_CONFIG = '''"""The compat model of {source}, written by
gecco_tpu_torch.compat.convert_ref_checkpoint: sample the checkpoint next
to this file with ``python -m gecco_tpu_torch.infer <this file>``."""

from gecco_tpu_torch.compat.convert_ref_checkpoint import build_model

ARCH = {arch!r}


def make_model(generator, device="cpu"):
    return build_model(**ARCH, generator=generator, device=device)
'''


def write_checkpoint(model: Diffusion, out: str, source: str, arch: dict) -> str:
    """``out/checkpoint-step-0`` (``model.pt``, ``ema.pt``, ``meta.json``)
    and ``out/config.py``; returns the checkpoint's directory."""
    ckpt = os.path.abspath(os.path.join(out, "checkpoint-step-0"))
    os.makedirs(ckpt, exist_ok=True)
    state = model.state_dict()
    for name in ("model.pt", "ema.pt"):
        torch.save(state, os.path.join(ckpt, name))
    with open(os.path.join(ckpt, "meta.json"), "w") as f:
        json.dump({"step": 0, "source": os.path.abspath(source)}, f)
    with open(os.path.join(out, "config.py"), "w") as f:
        f.write(_CONFIG.format(source=os.path.basename(source), arch=arch))
    return ckpt


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("eqx", help="reference EMA checkpoint (.eqx)")
    p.add_argument("--out", required=True, help="output run directory")
    p.add_argument("--n-layers", type=int, default=FLAGSHIP["n_layers"])
    p.add_argument("--feature-dim", type=int, default=FLAGSHIP["feature_dim"])
    p.add_argument("--num-inducers", type=int, default=FLAGSHIP["num_inducers"])
    p.add_argument("--num-heads", type=int, default=FLAGSHIP["num_heads"])
    p.add_argument("--sigma-max", type=float, default=FLAGSHIP["sigma_max"])
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)
    arch = dict(n_layers=args.n_layers, feature_dim=args.feature_dim,
                num_inducers=args.num_inducers, num_heads=args.num_heads,
                sigma_max=args.sigma_max)
    model = convert(args.eqx, device=args.device, **arch)
    ckpt = write_checkpoint(model, args.out, args.eqx, arch)
    print(f"Converted {args.eqx} -> {ckpt}")
    return ckpt


if __name__ == "__main__":
    main()
