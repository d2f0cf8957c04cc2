"""Scaled config: the port's copy of ``configs/shapenet_scaled_8k.py``,
twice the flagship's denoiser (12 layers of 768 channels, 64 inducers, 16
heads, bf16, ``folded_pallas``, remat) on 8192-point airplane clouds at
batch 16; LogUniform sigma_max 165; ``GaussianReparam`` (0, 0.35); the
global-norm clip at 1 then AdaBelief at 3e-4; EMA 0.999; validation on 8
batches of the loss. Under a process group of more than one rank the
Trainer takes ``shard_points``, as the JAX config does on more than one
device; the default mesh puts every rank on the data axis, so the points
are split only where the caller passes ``mesh=make_mesh(data, seq)``.

    SHAPENET_PF_ROOT=/path/to/ShapeNetCore.v2.PC15k \\
        python -m gecco_tpu_torch.train gecco_tpu_torch/configs/shapenet_scaled_8k.py
"""

import os

from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.data.shapenet_pointflow import ShapeNetPointFlow
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.parallel import process_count
from gecco_tpu_torch.reparam import GaussianReparam
from gecco_tpu_torch.train import adabelief, chain, clip_by_global_norm
from gecco_tpu_torch.train import train as train_fn

DATA_ROOT = os.environ.get("SHAPENET_PF_ROOT", "/data/shapenet-pointflow")
CATEGORY = "02691156"
N_POINTS = 8192
BATCH = 16
NUM_STEPS = 1_000_000


def make_model(generator, device="cpu"):
    import torch

    backbone = SetTransformer(
        n_layers=12,
        feature_dim=768,
        num_inducers=64,
        embed_dim=1,
        num_heads=16,
        compute_dtype=torch.bfloat16,
        attn_impl="folded_pallas",
        remat=True,
        device=device,
        generator=generator,
    )
    network = UnconditionalPointNetwork(backbone, feature_dim=768, device=device,
                                        generator=generator)
    schedule = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=128)
    return Diffusion(network, schedule,
                     reparam=GaussianReparam([0.0] * 3, [0.35] * 3, device=device))


def make_train_loader():
    dataset = ShapeNetPointFlow(DATA_ROOT, CATEGORY, "train", n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, num_steps=NUM_STEPS)


def make_val_loader():
    dataset = ShapeNetPointFlow(DATA_ROOT, CATEGORY, "val", n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, fixed_sampler=True)


def train(make_model, train_loader, val_loader, save_path, **overrides):
    """The config's training run; ``overrides`` replace any of the
    ``Trainer``'s arguments."""
    kwargs = dict(
        model=make_model,
        train_dataloader=train_loader,
        val_dataloader=val_loader,
        save_path=save_path,
        save_every=10_000,
        num_steps=NUM_STEPS,
        optimizer=chain(clip_by_global_norm(1.0), adabelief(3e-4)),
        ema_alpha=0.999,
        n_validation_batches=8,
        shard_points=process_count() > 1,
    )
    kwargs.update(overrides)
    return train_fn(**kwargs)
