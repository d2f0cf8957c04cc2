"""Unconditional ShapeNet (PointFlow) airplane config: the port's copy of
``configs/shapenet_airplane_unconditional.py``. 6 layers of 384 channels,
64 inducers, 8 heads, bf16 compute through the hand-written kernels
(``attn_impl="folded_pallas"``), no remat; LogUniform sigma_max 165; the
global-norm clip at 1 then AdaBelief at a warmup-cosine learning rate to
6e-6; EMA 0.999; validation on 8 batches with ``SupervisedMetric``,
``LogpMetric(n_solver_steps=24)``, the loss and ``BenchmarkCallback``.

    SHAPENET_PF_ROOT=/path/to/ShapeNetCore.v2.PC15k \\
        python -m gecco_tpu_torch.train gecco_tpu_torch/configs/shapenet_airplane_unconditional.py

(``--device cpu`` trains on the CPU.)

The model is built on the CPU from the generator's draws and the trainer
moves it to its device (the card).
"""

import os

from gecco_tpu_torch.benchmark import BenchmarkCallback
from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.data.shapenet_pointflow import ShapeNetPointFlow
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.metrics import LogpMetric, SupervisedMetric
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.reparam import GaussianReparam
from gecco_tpu_torch.train import flagship_optimizer
from gecco_tpu_torch.train import train as train_fn

DATA_ROOT = os.environ.get("SHAPENET_PF_ROOT", "/data/shapenet-pointflow")
CATEGORY = "02691156"  # airplane
N_POINTS = 2048
BATCH = 48
NUM_STEPS = 1_000_000

# dataset statistics for GaussianReparam
REPARAM_MEAN = (0.0, 0.0, 0.0)
REPARAM_STD = (0.35, 0.35, 0.35)


def make_model(generator, device="cpu"):
    import torch

    backbone = SetTransformer(
        n_layers=6,
        feature_dim=384,
        num_inducers=64,
        embed_dim=1,
        num_heads=8,
        mlp_blowup=2,
        compute_dtype=torch.bfloat16,
        attn_impl="folded_pallas",
        remat=False,
        device=device,
        generator=generator,
    )
    network = UnconditionalPointNetwork(backbone, feature_dim=384, device=device,
                                        generator=generator)
    schedule = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=128)
    reparam = GaussianReparam(REPARAM_MEAN, REPARAM_STD, device=device)
    return Diffusion(network, schedule, reparam=reparam)


def make_train_loader():
    dataset = ShapeNetPointFlow(DATA_ROOT, CATEGORY, "train", n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, num_steps=NUM_STEPS)


def make_val_loader():
    dataset = ShapeNetPointFlow(DATA_ROOT, CATEGORY, "val", n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, fixed_sampler=True)


def train(make_model, train_loader, val_loader, save_path, **overrides):
    """The config's training run; ``overrides`` replace any of the
    ``Trainer``'s arguments (a short run on the card cuts ``num_steps``,
    ``save_every`` and ``n_validation_batches``)."""
    callbacks = []
    try:
        callbacks.append(BenchmarkCallback.from_loader(make_val_loader(), n_examples=256,
                                                       save_path=save_path,
                                                       device=overrides.get("device")))
    except Exception as e:
        print(f"benchmark callback disabled: {e}")
    kwargs = dict(
        model=make_model,
        train_dataloader=train_loader,
        val_dataloader=val_loader,
        save_path=save_path,
        save_every=10_000,
        num_steps=NUM_STEPS,
        # exact likelihood at 24 reverse-ODE steps; the absolute value moves
        # with the step count, so compare runs at equal settings
        metrics=(SupervisedMetric(), LogpMetric(n_solver_steps=24)),
        optimizer=flagship_optimizer(NUM_STEPS),
        ema_alpha=0.999,
        n_validation_batches=8,
        callbacks=callbacks,
    )
    kwargs.update(overrides)
    return train_fn(**kwargs)
