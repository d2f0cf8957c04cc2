"""Image-conditional ShapeNet-vol config: the port's copy of
``configs/shapenet_vol_conditional.py``. Posed ShapeNet objects in the
Occupancy-Networks layout (137 x 137 renders and their cameras), the points
in camera coordinates and reparameterised into the UVL frustum;
ConvNeXt-tiny's three-stage pyramid looked up by ``RayNetwork`` through the
projective gather's kernels (``lookup_impl="pallas"``) over a 6 x 384
backbone with 64 inducers and 8 heads, bf16, ``folded_pallas``, remat;
LogUniform sigma_max 165; the global-norm clip at 1 then AdaBelief at 3e-4;
EMA 0.999; validation on 8 batches with ``SupervisedMetric``,
``LogpMetric(n_solver_steps=24)`` and the loss.

    SHAPENET_VOL_ROOT=/path/to/ShapeNet \\
        python -m gecco_tpu_torch.train gecco_tpu_torch/configs/shapenet_vol_conditional.py

``GECCO_CONVNEXT_WEIGHTS=<npz>`` loads a torchvision ``convnext_tiny``
state dict saved as an npz into the extractor (none is fetched);
``GECCO_FREEZE_CONDITIONER=1`` keeps the extractor's weights out of
training (``Frozen``). ``--device cpu`` trains on the CPU. The model is
built on the CPU from the generator's draws and the trainer moves it to
its device (the card).
"""

import os

from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.data.shapenet_vol import ShapeNetVol
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.metrics import LogpMetric, SupervisedMetric
from gecco_tpu_torch.models import ConvNeXtExtractor, RayNetwork, SetTransformer
from gecco_tpu_torch.reparam import UVLReparam
from gecco_tpu_torch.train import conditional_optimizer
from gecco_tpu_torch.train import train as train_fn

DATA_ROOT = os.environ.get("SHAPENET_VOL_ROOT", "/data/ShapeNet")
N_POINTS = 2048
BATCH = 48
NUM_STEPS = 1_000_000
CTX_DIMS = (96, 192, 384)


def make_model(generator, device="cpu"):
    import torch

    reparam = UVLReparam(device=device)
    backbone = SetTransformer(
        n_layers=6,
        feature_dim=384,
        num_inducers=64,
        embed_dim=1,
        num_heads=8,
        compute_dtype=torch.bfloat16,
        attn_impl="folded_pallas",
        remat=True,
        device=device,
        generator=generator,
    )
    network = RayNetwork(backbone, reparam, feature_dim=384, input_ctx_dim=sum(CTX_DIMS),
                         lookup_impl="pallas", device=device, generator=generator)
    cond = ConvNeXtExtractor(size="tiny", mode="local", device=device, generator=generator)
    # pretrained or frozen extractor: see taskonomy_conditional.py
    if os.environ.get("GECCO_CONVNEXT_WEIGHTS"):
        from gecco_tpu_torch.models.convnext import load_pretrained_npz

        cond = load_pretrained_npz(cond, os.environ["GECCO_CONVNEXT_WEIGHTS"])
    if os.environ.get("GECCO_FREEZE_CONDITIONER", "0") == "1":
        from gecco_tpu_torch.utils import Frozen

        cond = Frozen(cond)
    schedule = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=128)
    return Diffusion(network, schedule, reparam=reparam, cond=cond)


def make_train_loader():
    dataset = ShapeNetVol(DATA_ROOT, "train", posed=True, image_conditional=True,
                          n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, num_steps=NUM_STEPS)


def make_val_loader():
    dataset = ShapeNetVol(DATA_ROOT, "val", posed=True, image_conditional=True,
                          n_points=N_POINTS)
    return dataloader(dataset, batch_size=BATCH, fixed_sampler=True)


def train(make_model, train_loader, val_loader, save_path, **overrides):
    """The config's training run; ``overrides`` replace any of the
    ``Trainer``'s arguments (a short run on the card cuts ``num_steps``,
    ``save_every`` and ``n_validation_batches``)."""
    kwargs = dict(
        model=make_model,
        train_dataloader=train_loader,
        val_dataloader=val_loader,
        save_path=save_path,
        save_every=10_000,
        num_steps=NUM_STEPS,
        # exact likelihood through the conditional stack (the UVL ladj, the
        # VJP through the gather and the pyramid) at a 24-step reverse ODE
        metrics=(SupervisedMetric(), LogpMetric(n_solver_steps=24)),
        optimizer=conditional_optimizer(),
        ema_alpha=0.999,
        n_validation_batches=8,
    )
    kwargs.update(overrides)
    return train_fn(**kwargs)
