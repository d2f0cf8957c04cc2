"""The port's copies of the JAX package's configs (``configs/*.py``
against ``gecco_tpu_torch/configs/*.py``), and the image-conditional
config trained end to end on the CPU.

For each config: the same constants; the same model (its parameter paths
and shapes through ``gecco_tpu_torch.convert``'s naming, with the port's
model built on the ``meta`` device and the JAX one traced, so no
full-width weights are drawn; the wrapper, backbone and conditioner
settings, the schedule and the reparam's values); the same ``Trainer``
arguments, the metrics among them; and the same optimizer, as updates on
the same gradients. Then ``python -m gecco_tpu_torch.train``'s
``execute`` trains a copy of the ShapeNet-vol conditional config cut to a
tiny width (its text edited, as ``chip_smoke.py``'s rehearsal edits the
flagship's) on a tree of procedural objects: it smoke-tests the
validation, trains, validates, checkpoints and resumes at the next step.
"""

import functools
import importlib.util
import inspect
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gecco_tpu_torch.convert import ALIASES, _STACKED
from gecco_tpu_torch.train import __main__ as train_main
from gecco_tpu_torch.train import trainer as trainer_mod
from gecco_tpu_torch.utils import modules
from gecco_tpu_torch.utils.logging import JsonlWriter
from torch_parity import path_name, write_shapenet_vol_tree

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("shapenet_vol_conditional", "taskonomy_conditional", "shapenet_pc15k_all",
           "shapenet_scaled_8k")
CONSTANTS = ("DATA_ROOT", "CATEGORY", "N_POINTS", "BATCH", "NUM_STEPS", "CTX_DIMS",
             "CONVNEXT_WEIGHTS", "FREEZE_CONDITIONER")
# the JAX Trainer's knob the port's configs do not pass: XLA's buffer donation
JAX_ONLY = {"donate_buffers"}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(trainer_mod, "make_writer", JsonlWriter)


def _load(path: Path, name: str):
    """A config file as a module of its own name (``load_config`` reuses
    one module name for every config)."""
    spec = importlib.util.spec_from_file_location(name, str(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_model(cfg):
    """The JAX config's model traced once: (its leaves' {path: shape}, the
    traced model for its static fields, its reparam's values). Only the
    reparam is computed."""
    seen = {}

    def build(key):
        m = cfg.make_model(key)
        leaves, _ = jax.tree_util.tree_flatten_with_path(m)
        seen["shapes"] = {path_name(p): tuple(v.shape) for p, v in leaves}
        seen["model"] = m
        return m.reparam

    reparam = jax.jit(build)(jax.random.PRNGKey(0))
    return seen["shapes"], seen["model"], reparam


def _port_shapes(model) -> dict:
    """{JAX path: shape} of the port's parameters and buffers, the per-layer
    ones stacked as ``convert`` stacks them."""
    shapes, layers = {}, {}
    for name, p in [*model.named_parameters(), *model.named_buffers()]:
        m = _STACKED.match(name)
        if m:
            key = f"{m.group(1)}.{m.group(3)}"
            layers.setdefault(key, set()).add(int(m.group(2)))
            shapes[key] = tuple(p.shape)
        else:
            shapes[name] = tuple(p.shape)
    for key, idx in layers.items():
        assert idx == set(range(len(idx))), key
        shapes[key] = (len(idx), *shapes[key])
    return shapes


def _metric(m) -> tuple:
    """A metric's class and, for the likelihood, its step count (the JAX
    ``LogpMetric`` keeps it in its jitted function's closure)."""
    if type(m).__name__ == "LogpMetric" and hasattr(m, "_fn"):
        steps = inspect.getclosurevars(m._fn.__wrapped__).nonlocals["n_solver_steps"]
    else:
        steps = getattr(m, "n_solver_steps", None)
    return type(m).__name__, steps


def _on_cpu(cls, *args, **kw):
    return cls(*args, **{**kw, "device": "cpu"})


def _captured_train(cfg, monkeypatch, tmp_path) -> dict:
    seen = {}
    monkeypatch.setattr(cfg, "train_fn", lambda **kw: seen.update(kw))
    cfg.train(None, None, None, str(tmp_path))
    return seen


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_the_jax_one(name, monkeypatch, tmp_path):
    jcfg = _load(ROOT / "configs" / f"{name}.py", f"jax_config_{name}")
    cfg = _load(ROOT / "gecco_tpu_torch" / "configs" / f"{name}.py", f"port_config_{name}")
    for const in CONSTANTS:
        assert hasattr(cfg, const) == hasattr(jcfg, const), const
        if hasattr(jcfg, const):
            assert getattr(cfg, const) == getattr(jcfg, const), const

    jshapes, jm, jreparam = _jax_model(jcfg)
    # the port's model on the meta device, its weights not drawn; its
    # reparam (constants) on the CPU, to be read
    monkeypatch.setattr(modules, "uniform_", lambda shape, lim, generator: torch.empty(shape))
    for rp in ("GaussianReparam", "UVLReparam"):
        if hasattr(cfg, rp):
            monkeypatch.setattr(cfg, rp, functools.partial(_on_cpu, getattr(cfg, rp)))
    model = cfg.make_model(torch.Generator().manual_seed(0), device="meta")
    shapes = _port_shapes(model)
    aliases = [k for k in jshapes if any(k.startswith(d) for d in ALIASES)]
    assert {k: v for k, v in jshapes.items() if k not in aliases} == shapes
    assert sum(int(np.prod(s)) for k, s in shapes.items() if "reparam" not in k) == sum(
        p.numel() for p in model.parameters())

    net, jnet = model.network, jm.network
    assert type(net).__name__ == type(jnet).__name__
    back, jback = net.backbone, jnet.backbone
    assert (back.attn_impl, back.remat) == (jback.attn_impl, jback.remat)
    assert str(back.compute_dtype).split(".")[-1] == np.dtype(jback.compute_dtype).name
    assert back.layers[0].broadcast.pool.num_heads == jback.layers.broadcast.pool.num_heads
    assert getattr(net, "lookup_impl", None) == getattr(jnet, "lookup_impl", None)
    for field in ("sigma_max", "sigma_min", "n_solver_steps", "sigma_data", "rho"):
        assert getattr(model.schedule, field) == getattr(jm.schedule, field), field
    assert type(model.reparam).__name__ == type(jm.reparam).__name__
    for key, value in jax.tree_util.tree_flatten_with_path(jreparam)[0]:
        np.testing.assert_array_equal(getattr(model.reparam, path_name(key)).numpy(),
                                      np.asarray(value))
    if hasattr(jcfg, "CTX_DIMS"):
        assert model.cond.mode == jm.cond.mode == "local"
        assert type(model.cond).__name__ == type(jm.cond).__name__ == "ConvNeXtExtractor"

    if hasattr(cfg, "process_count"):
        # point sharding where the world has more than one rank, as the JAX
        # config shards the points over more than one device
        monkeypatch.setattr(cfg, "process_count", jax.device_count)
        assert jax.device_count() > 1
    kw, jkw = (_captured_train(c, monkeypatch, tmp_path) for c in (cfg, jcfg))
    assert set(kw) == set(jkw) - JAX_ONLY
    assert kw.get("shard_points") == jkw.get("shard_points")
    if "shard_points" in kw:
        monkeypatch.setattr(cfg, "process_count", lambda: 1)
        assert _captured_train(cfg, monkeypatch, tmp_path)["shard_points"] is False
    for k in ("save_every", "num_steps", "ema_alpha", "n_validation_batches", "save_path"):
        assert kw[k] == jkw[k], k
    assert [_metric(m) for m in kw.get("metrics", ())] == [
        _metric(m) for m in jkw.get("metrics", ())]
    assert len(kw.get("callbacks", ())) == len(jkw.get("callbacks", ()))

    # the optimizer: the same updates on the same gradients, three steps
    rng = np.random.default_rng(0)
    params = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=7).astype(np.float32)]
    opt, jopt = kw["optimizer"], jkw["optimizer"]
    state, jstate = opt.init([torch.from_numpy(p) for p in params]), jopt.init(params)
    for step in range(3):
        grads = [(rng.normal(size=p.shape) * 10 ** (step - 1)).astype(np.float32) for p in params]
        updates, state = opt.update([torch.from_numpy(g) for g in grads], state)
        jupdates, jstate = jopt.update(grads, jstate, params)
        for u, ju in zip(updates, jupdates):
            np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-10)


# the conditional config's text cut to a tiny run: 2 layers of 64
# channels, 16 inducers, 4 heads, 64 points, batch 2, 3-step samplers, a
# 2-step likelihood, 4 steps with a checkpoint and validation every 2 on one
# batch; the ConvNeXt-tiny stays, on the 137^2 renders
CUTS = (("n_layers=6", "n_layers=2"), ("feature_dim=384", "feature_dim=64"),
        ("num_inducers=64", "num_inducers=16"), ("num_heads=8", "num_heads=4"),
        ("n_solver_steps=128", "n_solver_steps=3"),
        ("LogpMetric(n_solver_steps=24)", "LogpMetric(n_solver_steps=2)"),
        ("N_POINTS = 2048", "N_POINTS = 64"), ("BATCH = 48", "BATCH = 2"),
        ("NUM_STEPS = 1_000_000", "NUM_STEPS = 4"), ("save_every=10_000", "save_every=2"),
        ("n_validation_batches=8", "n_validation_batches=1"))


def test_conditional_config_trains_validates_checkpoints_and_resumes(tmp_path, monkeypatch):
    data = write_shapenet_vol_tree(str(tmp_path / "data"))
    monkeypatch.setenv("SHAPENET_VOL_ROOT", data)
    text = (ROOT / "gecco_tpu_torch" / "configs" / "shapenet_vol_conditional.py").read_text()
    for a, b in CUTS:
        assert a in text, a
        text = text.replace(a, b)
    run = tmp_path / "run"
    run.mkdir()
    cfg = run / "config.py"
    cfg.write_text(text)

    trainer = train_main.execute(str(cfg), device="cpu")
    assert trainer.initial_step_number == 0
    # checkpoint-step-1 pruned once step 3's is written
    assert {"metadata.json", "checkpoint-step-3", "final-checkpoint-3",
            "best-checkpoints"} <= set(os.listdir(run))
    best = os.listdir(run / "best-checkpoints")
    assert any("chamfer_distance" in b for b in best) and any("logp__total" in b for b in best)
    scalars = [json.loads(line) for line in (run / "tensorboard" / "scalars.jsonl").open()]
    tags = {s["tag"] for s in scalars}
    assert {"train/loss", "val-means/loss/loss", "val-means/logp/total",
            "val-means/supervised/chamfer_distance"} <= tags
    losses = [s["value"] for s in scalars if s["tag"] == "train/loss"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert type(trainer.model.network).__name__ == "RayNetwork"
    assert trainer.model.network.lookup_impl == "pallas" and trainer.model.network.backbone.remat

    again = train_main.execute(str(cfg), device="cpu")
    assert again.initial_step_number == 4
    for a, b in zip(again.ema_model.parameters(), trainer.ema_model.parameters()):
        assert a.shape == b.shape
