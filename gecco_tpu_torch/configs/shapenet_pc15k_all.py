"""Unconditional ShapeNet PC15k config, all 55 categories: the port's copy
of ``configs/shapenet_pc15k_all.py``. The whole PointFlow 15k dataset under
LION's global normalisation (so the identity ``Reparam``); 6 layers of 384
channels, 64 inducers, 8 heads, bf16 through the hand-written kernels
(``folded_pallas``), no remat; LogUniform sigma_max 165; the global-norm
clip at 1 then AdaBelief at 3e-4; EMA 0.999; validation on 8 batches with
``SupervisedMetric``, the loss and ``BenchmarkCallback``.

    SHAPENET_PC15K_ROOT=/path/to/ShapeNetCore.v2.PC15k \\
        python -m gecco_tpu_torch.train gecco_tpu_torch/configs/shapenet_pc15k_all.py
"""

import os

from gecco_tpu_torch.benchmark import BenchmarkCallback
from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.data.lion import LIONDataWrapper
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.metrics import SupervisedMetric
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.reparam import Reparam
from gecco_tpu_torch.train import adabelief, chain, clip_by_global_norm
from gecco_tpu_torch.train import train as train_fn

DATA_ROOT = os.environ.get("SHAPENET_PC15K_ROOT", "/data/ShapeNetCore.v2.PC15k")
N_POINTS = 2048
BATCH = 48
NUM_STEPS = 1_000_000


def make_model(generator, device="cpu"):
    import torch

    backbone = SetTransformer(
        n_layers=6,
        feature_dim=384,
        num_inducers=64,
        embed_dim=1,
        num_heads=8,
        compute_dtype=torch.bfloat16,
        attn_impl="folded_pallas",
        remat=False,
        device=device,
        generator=generator,
    )
    network = UnconditionalPointNetwork(backbone, feature_dim=384, device=device,
                                        generator=generator)
    schedule = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=128)
    # LION's global normalisation standardises the data already
    return Diffusion(network, schedule, reparam=Reparam())


def make_train_loader():
    dataset = LIONDataWrapper(DATA_ROOT, "all", "train", n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, num_steps=NUM_STEPS)


def make_val_loader():
    dataset = LIONDataWrapper(DATA_ROOT, "all", "val", n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, fixed_sampler=True)


def train(make_model, train_loader, val_loader, save_path, **overrides):
    """The config's training run; ``overrides`` replace any of the
    ``Trainer``'s arguments."""
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
        metrics=(SupervisedMetric(),),
        optimizer=chain(clip_by_global_norm(1.0), adabelief(3e-4)),
        ema_alpha=0.999,
        n_validation_batches=8,
        callbacks=callbacks,
    )
    kwargs.update(overrides)
    return train_fn(**kwargs)
