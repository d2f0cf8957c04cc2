"""Image-conditional Taskonomy config: the port's copy of
``configs/taskonomy_conditional.py``. An RGB frame to its scene's point
cloud: UVL frustum reparam, ConvNeXt-tiny's three-stage pyramid looked up
by ``RayNetwork`` through the projective gather's kernels over a 6 x 384
backbone (64 inducers, 8 heads, ``mlp_blowup=2``, bf16, ``folded_pallas``,
remat); LogUniform sigma_max 180; the global-norm clip at 1 then AdaBelief
at 3e-4; EMA 0.999; validation on 8 batches with ``SupervisedMetric``,
``LogpMetric(n_solver_steps=24)`` and the loss.

    TASKONOMY_ROOT=/path/to/taskonomy \\
        python -m gecco_tpu_torch.train gecco_tpu_torch/configs/taskonomy_conditional.py

The reader needs ``h5py`` for the scenes' clouds. ``GECCO_CONVNEXT_WEIGHTS``
names an npz of a torchvision ``convnext_tiny`` state dict to start the
extractor from (none is fetched); ``GECCO_FREEZE_CONDITIONER=1`` keeps its
weights out of training.
"""

import os

from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.data.taskonomy import Taskonomy
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.metrics import LogpMetric, SupervisedMetric
from gecco_tpu_torch.models import ConvNeXtExtractor, RayNetwork, SetTransformer
from gecco_tpu_torch.reparam import UVLReparam
from gecco_tpu_torch.train import conditional_optimizer
from gecco_tpu_torch.train import train as train_fn

DATA_ROOT = os.environ.get("TASKONOMY_ROOT", "/data/taskonomy")
N_POINTS = 2048
BATCH = 48
NUM_STEPS = 1_000_000
CTX_DIMS = (96, 192, 384)  # ConvNeXt-tiny's pyramid channels

# ImageNet-pretrained extractor weights: a torchvision convnext_tiny state
# dict saved as an npz; GECCO_FREEZE_CONDITIONER=1 also stops the
# gradients into the extractor
CONVNEXT_WEIGHTS = os.environ.get("GECCO_CONVNEXT_WEIGHTS")
FREEZE_CONDITIONER = os.environ.get("GECCO_FREEZE_CONDITIONER", "0") == "1"


def make_model(generator, device="cpu"):
    import torch

    reparam = UVLReparam(device=device)
    backbone = SetTransformer(
        n_layers=6,
        feature_dim=384,
        num_inducers=64,
        embed_dim=1,
        num_heads=8,
        mlp_blowup=2,
        compute_dtype=torch.bfloat16,
        attn_impl="folded_pallas",
        remat=True,
        device=device,
        generator=generator,
    )
    network = RayNetwork(backbone, reparam, feature_dim=384, input_ctx_dim=sum(CTX_DIMS),
                         lookup_impl="pallas", device=device, generator=generator)
    cond = ConvNeXtExtractor(size="tiny", mode="local", device=device, generator=generator)
    if CONVNEXT_WEIGHTS:
        from gecco_tpu_torch.models.convnext import load_pretrained_npz

        cond = load_pretrained_npz(cond, CONVNEXT_WEIGHTS)
    if FREEZE_CONDITIONER:
        from gecco_tpu_torch.utils import Frozen

        cond = Frozen(cond)
    schedule = LogUniformSchedule(sigma_max=180.0, sigma_min=0.002, n_solver_steps=128)
    return Diffusion(network, schedule, reparam=reparam, cond=cond)


def make_train_loader():
    dataset = Taskonomy(DATA_ROOT, split="train", n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, num_steps=NUM_STEPS)


def make_val_loader():
    dataset = Taskonomy(DATA_ROOT, split="val", n_points=N_POINTS)
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
        metrics=(SupervisedMetric(), LogpMetric(n_solver_steps=24)),
        optimizer=conditional_optimizer(),
        ema_alpha=0.999,
        n_validation_batches=8,
    )
    kwargs.update(overrides)
    return train_fn(**kwargs)
