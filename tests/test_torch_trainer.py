"""The port's ``Trainer``, its CLIs and ``BenchmarkCallback`` on the CPU, at
a tiny width (2 layers of 32 channels, 64 points).

A run resumed from a checkpoint takes the same steps bit for bit as one
never stopped; the trainer's steps are ``make_train_step``'s (held against
the JAX package's in ``test_torch_train.py``) fed the same batches and
draws; the NaN guard names the step and dumps the batch; the losses are
fetched in batches; the best-metric checkpoints follow the tracked metrics
over several validation loaders; ``python -m gecco_tpu_torch.train`` trains
a config and ``python -m gecco_tpu_torch.infer`` samples its EMA weights;
``BenchmarkCallback`` scores as the JAX package's does."""

import json
import os
import textwrap

import jax
import numpy as np
import pytest
import torch

from gecco_tpu import benchmark as jbench
from gecco_tpu_torch import benchmark
from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.infer import __main__ as infer_main
from gecco_tpu_torch.metrics import LogpMetric, SupervisedMetric
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.reparam import GaussianReparam
from gecco_tpu_torch.train import Trainer, flagship_optimizer, make_ema, make_train_step
from gecco_tpu_torch.train import __main__ as train_main
from gecco_tpu_torch.train import trainer as trainer_mod
from gecco_tpu_torch.types import Example, NaNError
from gecco_tpu_torch.utils.logging import JsonlWriter

N_POINTS = 64


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(2)
    # the JSONL writer: readable here, and no TensorBoard import
    monkeypatch.setattr(trainer_mod, "make_writer", JsonlWriter)


def make_model(generator, device="cpu"):
    backbone = SetTransformer(2, 32, 16, embed_dim=1, num_heads=4, compute_dtype=torch.float32,
                              attn_impl="folded_pallas", device=device, generator=generator)
    net = UnconditionalPointNetwork(backbone, 32, device=device, generator=generator)
    return Diffusion(net, LogUniformSchedule(sigma_max=20.0, n_solver_steps=3),
                     reparam=GaussianReparam([0.0] * 3, [1.0] * 3, device=device))


class Blobs:
    def __init__(self, n=12, seed=0, nan_at=None):
        rng = np.random.default_rng(seed)
        self.clouds = rng.normal(0, 1.0, (n, N_POINTS, 3)).astype(np.float32)
        if nan_at is not None:
            self.clouds[nan_at] = np.nan

    def __len__(self):
        return len(self.clouds)

    def __getitem__(self, i):
        return Example(self.clouds[i], None)


def _batches(n_steps, seed=0, nan_at=None):
    return list(dataloader(Blobs(seed=seed, nan_at=nan_at), batch_size=4, num_steps=n_steps,
                           num_workers=1))


def _val(name=None, seed=1):
    return dataloader(Blobs(n=8, seed=seed), batch_size=4, fixed_sampler=True, name=name,
                      num_workers=1)


def _trainer(save_path, train, **kw):
    args = dict(model=make_model, train_dataloader=train, val_dataloader=_val(),
                save_path=str(save_path), save_every=3, num_steps=5, metrics=(),
                optimizer=flagship_optimizer(100), n_validation_batches=1,
                skip_smoke_test=True, device="cpu", loss_sync_every=2, seed=7)
    args.update(kw)
    return Trainer(**args)


def _state(t: Trainer) -> list:
    opt = [x for x in jax.tree_util.tree_leaves(t.opt_state)]
    return ([p.detach().clone() for p in t.model.state_dict().values()]
            + [p.detach().clone() for p in t.ema_model.state_dict().values()]
            + [x.clone() if torch.is_tensor(x) else x for x in opt])


def _same_bits(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        else:
            assert x == y


def test_resumed_run_takes_the_same_steps_as_an_uninterrupted_one(tmp_path):
    batches = _batches(6)
    whole = _trainer(tmp_path / "whole", batches)
    whole.recover_from_checkpoint()
    whole.fit()
    assert sorted(os.listdir(tmp_path / "whole")) == [
        "best-checkpoints", "checkpoint-step-5", "final-checkpoint-5", "tensorboard"]
    first = _trainer(tmp_path / "cut", batches[:3], num_steps=2)
    first.recover_from_checkpoint()
    first.fit()
    resumed = _trainer(tmp_path / "cut", batches[3:])
    resumed.recover_from_checkpoint(fail_if_unavailable=True)
    assert resumed.initial_step_number == 3
    assert resumed.opt_state[1][0].count == 3  # AdaBelief's count came back
    resumed.fit()
    _same_bits(_state(resumed), _state(whole))
    with open(tmp_path / "cut" / "final-checkpoint-5" / "meta.json") as f:
        assert json.load(f) == {"step": 5}


def test_trainer_steps_are_make_train_steps_on_the_same_batches_and_draws(tmp_path):
    batches = _batches(3)
    model = make_model(torch.Generator().manual_seed(3))
    twin = make_model(torch.Generator().manual_seed(3))
    t = _trainer(tmp_path, batches, model=model, num_steps=2, save_every=100)
    t.fit()
    opt = flagship_optimizer(100)
    step = make_train_step(opt, ema_alpha=0.999)
    ema, state = make_ema(twin), opt.init(list(twin.parameters()))
    for s, batch in enumerate(batches):
        _, state = step(twin, ema, state, torch.from_numpy(batch.points), t.step_generator(s))
    for a, b in zip(t.model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(t.ema_model.parameters(), ema.parameters()):
        assert torch.equal(a, b)


def test_nan_guard_names_the_step_and_dumps_the_batch(tmp_path):
    batches = _batches(4, nan_at=5)  # clouds 4-7 are batch 1 of the first epoch
    bad = next(s for s, b in enumerate(batches) if np.isnan(b.points).any())
    t = _trainer(tmp_path, batches, save_every=100, loss_sync_every=10)
    with pytest.raises(NaNError, match=f"NaN loss at step {bad}"):
        t.fit()
    dump = np.load(tmp_path / "offending-data.npz")
    np.testing.assert_array_equal(dump["leaf_0"], batches[bad].points)
    assert os.path.isdir(tmp_path / "final-checkpoint-3")


def test_deferred_loss_sync_logs_every_step(tmp_path):
    t = _trainer(tmp_path, _batches(6), save_every=100, loss_sync_every=4)
    t.fit()
    with open(tmp_path / "tensorboard" / "scalars.jsonl") as f:
        steps = [r["step"] for r in map(json.loads, f) if r["tag"] == "train/loss"]
    assert steps == list(range(6))


def test_best_metric_checkpoints_over_several_validation_loaders(tmp_path):
    """The smoke test runs and leaves no checkpoint; each loader's tracked
    Chamfer distance and logp keep one best checkpoint each."""
    t = _trainer(tmp_path, _batches(4), save_every=2, num_steps=3, skip_smoke_test=False,
                 val_dataloader=[_val("a", 1), _val("b", 2)],
                 metrics=(SupervisedMetric(), LogpMetric(n_solver_steps=2)))
    t.fit()
    best = sorted(os.listdir(tmp_path / "best-checkpoints"))
    keys = ["a__supervised__chamfer_distance", "a__logp__total",
            "b__supervised__chamfer_distance", "b__logp__total"]
    assert sorted(b.rsplit("-step-", 1)[0] for b in best) == sorted(keys)
    for name in best:
        assert set(os.listdir(tmp_path / "best-checkpoints" / name)) == {
            "model.pt", "ema.pt", "opt.pt", "meta.json"}
    assert set(t.current_best_metric) == {k.replace("__", "/") for k in keys}
    with open(tmp_path / "tensorboard" / "scalars.jsonl") as f:
        tags = {r["tag"] for r in map(json.loads, f)}
    assert {"val-means/a/loss/loss", "val-means/b/logp/total", "train/mean_loss"} <= tags


_CONFIG = '''
import numpy as np
import torch
from test_torch_trainer import Blobs, make_model
from gecco_tpu_torch.benchmark import BenchmarkCallback
from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.train import flagship_optimizer
from gecco_tpu_torch.train import train as train_fn


def make_train_loader():
    return dataloader(Blobs(), batch_size=4, num_steps=4, num_workers=1)


def make_val_loader():
    return dataloader(Blobs(n=8, seed=1), batch_size=4, fixed_sampler=True, num_workers=1)


def train(make_model, train_loader, val_loader, save_path, device=None):
    cb = BenchmarkCallback.from_loader(make_val_loader(), n_examples=8, save_path=save_path,
                                       device=device)
    return train_fn(model=make_model, train_dataloader=train_loader,
                    val_dataloader=val_loader, save_path=save_path, save_every=2,
                    num_steps=3, optimizer=flagship_optimizer(10), n_validation_batches=1,
                    callbacks=[cb], device=device)
'''


def test_train_cli_trains_a_config_and_infer_samples_its_ema(tmp_path):
    cfg = tmp_path / "tiny_config.py"
    cfg.write_text(textwrap.dedent(_CONFIG))
    t = train_main.execute(str(cfg), device="cpu")
    assert t.initial_step_number == 0
    names = set(os.listdir(tmp_path))
    assert {"metadata.json", "checkpoint-step-3", "final-checkpoint-3",
            "benchmark-checkpoints"} <= names
    assert os.listdir(tmp_path / "benchmark-checkpoints" / "chamfer_distance")
    out = tmp_path / "samples.npz"
    samples = infer_main.main([str(cfg), "--device", "cpu", "--n-samples", "3",
                               "--batch-size", "2", "--n-points", "16", "--n-solver-steps",
                               "2", "--output", str(out)])
    assert np.load(out)["samples"].shape == (3, 16, 3) and np.isfinite(samples).all()
    sde = infer_main.main([str(cfg), str(tmp_path / "checkpoint-step-3"), "--device", "cpu",
                           "--sampler", "sde", "--n-samples", "2", "--batch-size", "2",
                           "--n-points", "16", "--n-solver-steps", "3", "--output",
                           str(tmp_path / "sde.npz")])
    assert sde.shape == (2, 16, 3) and np.isfinite(sde).all()
    ema = infer_main.load_ema_model(make_model, str(tmp_path / "final-checkpoint-3"), "cpu")
    for a, b in zip(ema.parameters(), t.ema_model.parameters()):
        assert torch.equal(a, b)
    # a second run resumes from the newest checkpoint
    again = train_main.execute(str(cfg), device="cpu")
    assert again.initial_step_number == 4


def test_benchmark_callback_matches_the_jax_one():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(10, 32, 3)).astype(np.float32)
    samples = (data + 0.3 * rng.normal(size=data.shape)).astype(np.float32)
    samples[::3] = rng.normal(size=samples[::3].shape)
    for name in ("chamfer", "chamfer_squared"):
        port = benchmark.BenchmarkCallback(data, batch_size=4, distance_fn=name, device="cpu")
        ref = jbench.BenchmarkCallback(data, batch_size=4, distance_fn=name)
        np.testing.assert_allclose(port.d_dd, ref.d_dd, rtol=1e-5, atol=1e-6)
        got, want = port.call_without_logging(samples)[0], ref.call_without_logging(samples)[0]
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for name in ("emd", "emd_exact"):
        with pytest.raises(NotImplementedError, match="A4"):
            benchmark.BenchmarkCallback(data, distance_fn=name, device="cpu")
    loader = dataloader(Blobs(n=8), batch_size=4, fixed_sampler=True, num_workers=1)
    np.testing.assert_array_equal(benchmark.extract_data(loader, 6),
                                  jbench.extract_data(loader, 6))
