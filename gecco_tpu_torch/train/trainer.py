"""The training loop (counterpart of ``gecco_tpu/train/trainer.py``'s
``Trainer`` and ``train``).

Around the port's train step (``make_train_step``: loss -> backward ->
clip + AdaBelief -> EMA, the set transformer's hand-written kernels on the
card) it keeps the JAX trainer's contract:

- checkpoints in ``checkpoint-step-N`` directories (``final-checkpoint-N``
  at the end), each three files as the JAX package keeps three trees:
  ``model.pt``, ``ema.pt`` and ``opt.pt`` (``torch.save`` of the state
  dicts and of the whole optimizer state, AdaBelief's count and the
  schedule's step among it), beside ``meta.json`` with the step; stale
  ones pruned, auto-resume from the newest;
- a validation phase every ``save_every`` steps over one or several
  validation loaders (each named), the metrics with ``LossMetric``
  appended, run on the EMA model; the best value of each tracked metric
  (Chamfer distances, ``logp/total``) kept as a checkpoint of its own; the
  callbacks (``BenchmarkCallback``) after it;
- a smoke test of the validation phase before training, against a
  ``MockWriter``;
- the losses fetched from the card in batches of ``loss_sync_every``
  steps (one ``.item()``-like sync each), so a non-finite loss is caught
  at the next fetch and ``NaNError`` names its step, the batch that made it
  dumped to ``offending-data.npz``;
- a ``torch.profiler`` window over steps 20-25 where ``profile_path`` is
  given, written there as a Chrome trace, then the run ends.

Every random draw comes from a generator seeded by ``seed`` and the step
(the train step's sigma and noise) or the validation phase (the metrics'
draws), so a run resumed from a checkpoint, fed the batches that followed
it, takes the same steps bit for bit as one never stopped. The model, the
EMA copy and the optimizer state live on ``device``: the card unless the
caller asks for the CPU. Multi-device training (the JAX trainer's
``mesh``, ``shard_points`` and ``donate_buffers``) waits for ROADMAP A10.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gecco_tpu_torch.config import CHECKPOINT_SAVE_RE, CHECKPOINT_SAVE_TEMPLATE, latest_checkpoint
from gecco_tpu_torch.metrics import LossMetric, Metric
from gecco_tpu_torch.train.optim import Transform, adabelief
from gecco_tpu_torch.train.step import make_ema, make_train_step
from gecco_tpu_torch.types import Example, NaNError, to_device, tree_leaves
from gecco_tpu_torch.utils.logging import MockWriter, make_writer
from gecco_tpu_torch.utils.modules import resolve_device

__all__ = ["Trainer", "train"]

# the draws' streams: the model's init, the train steps, the validation
_INIT, _TRAIN, _VAL = range(3)


def _seed(*words: int) -> int:
    """A 63-bit seed mixed from ``words`` (numpy's SeedSequence)."""
    return int(np.random.SeedSequence(list(words)).generate_state(2, np.uint64)[0] >> 1)


@dataclass
class Trainer:
    model: Any  # Diffusion, or callable generator -> Diffusion
    train_dataloader: Iterable[Example]
    val_dataloader: Union[Iterable[Example], List[Iterable[Example]]]
    save_path: str
    save_every: int = 100_000
    num_steps: int = 1_000_000
    metrics: Sequence[Metric] = ()
    optimizer: Transform = None
    loss_scale: float = 1.0
    ema_alpha: float = 0.999
    n_validation_batches: Optional[int] = None
    callbacks: Iterable[Callable] = ()
    seed: int = 5678
    profile_path: Optional[str] = None
    skip_smoke_test: bool = False
    keep_all_checkpoints: bool = False
    # run the model in inference mode (``nn.Module.eval``) while training,
    # the JAX trainer's flag for its stochastic layers
    train_in_inference_mode: bool = False
    # fetch train losses from the card in batches of this many steps: each
    # fetch waits for the card, so a fetch per step would keep the host from
    # running ahead. Logging and NaN detection lag by at most this many
    # steps; checkpoint and validation boundaries always fetch first.
    loss_sync_every: int = 10
    initial_step_number: int = 0
    current_best_metric: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device: Any = None

    ema_model: Any = None
    opt_state: Any = None

    def __post_init__(self):
        print(f"[trainer] run dir: {self.save_path}")
        self.device = resolve_device(self.device)
        if not hasattr(type(self.model), "loss"):
            assert callable(self.model), self.model
            self.model = self.model(torch.Generator().manual_seed(_seed(self.seed, _INIT)))
        self.model = self.model.to(self.device)
        if self.optimizer is None:
            self.optimizer = adabelief(3e-4)
        self.metrics = tuple(self.metrics) + (LossMetric(self.loss_scale),)
        os.makedirs(self._best_ckpt_dir, exist_ok=True)

    # -- draws --

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of train step ``step``'s sigma and noise."""
        return torch.Generator(device=self.device).manual_seed(_seed(self.seed, _TRAIN, step))

    def _phase_generator(self, phase_id: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(_seed(self.seed, _VAL, phase_id))

    # -- checkpointing --

    def save(self, dirname: str, step: int):
        """``model.pt``, ``ema.pt`` and ``opt.pt`` under ``dirname`` (in the
        run dir), so inference can load the EMA weights alone, and
        ``meta.json`` with the step."""
        path = os.path.abspath(os.path.join(self.save_path, dirname))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(self.model.state_dict(), os.path.join(path, "model.pt"))
        torch.save(self.ema_model.state_dict(), os.path.join(path, "ema.pt"))
        torch.save(self.opt_state, os.path.join(path, "opt.pt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"step": step}, f)

    def load(self, dirname: str):
        path = os.path.abspath(dirname)
        load = lambda name: torch.load(os.path.join(path, name), map_location=self.device,
                                       weights_only=False)
        self.model.load_state_dict(load("model.pt"))
        self.ema_model.load_state_dict(load("ema.pt"))
        self.opt_state = load("opt.pt")
        print(f"[trainer] restored checkpoint {dirname!r}")

    def _init_opt_state(self):
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(list(self.model.parameters()))
        if self.ema_model is None:
            self.ema_model = make_ema(self.model)

    def recover_from_checkpoint(self, fail_if_unavailable: bool = False):
        self._init_opt_state()
        try:
            path, start_step = latest_checkpoint(self.save_path, return_step_number=True)
        except IOError:
            if fail_if_unavailable:
                print("[trainer] no checkpoint to restore; aborting")
                raise
            print("[trainer] no checkpoint to restore; fresh start")
            return self
        self.load(path)
        self.initial_step_number = start_step + 1
        return self

    def _prune_stale_checkpoints(self, step: int):
        for name in os.listdir(self.save_path):
            m = CHECKPOINT_SAVE_RE.fullmatch(name)
            if m is not None and int(m.group(1)) < step:
                shutil.rmtree(os.path.join(self.save_path, name))

    # -- validation --

    @property
    def inference_model(self):
        return self.ema_model

    def _to_device(self, data) -> Example:
        example = data if isinstance(data, Example) else Example(*data)
        return to_device(example._replace(extras=()), self.device)

    def _run_metrics_over(self, dataloader, n_batches=None,
                          generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        eval_model = self.inference_model
        eval_model.eval()
        outputs = defaultdict(list)
        generator = self._phase_generator(0) if generator is None else generator
        for val_step, data in enumerate(dataloader):
            example = self._to_device(data)
            for metric_fn in self.metrics:
                values = metric_fn(eval_model, example.points, example.ctx, generator)
                for subname, value in values.items():
                    outputs[f"{metric_fn.name}/{subname}"].append(
                        value.detach().float().cpu().numpy().reshape(-1))
            if n_batches is not None and val_step + 1 >= n_batches:
                break
        return {k: float(np.mean(np.concatenate(v))) for k, v in outputs.items()}

    def metrics_loop(self, n_batches=None, generator=None) -> Dict[str, float]:
        if isinstance(self.val_dataloader, (list, tuple)):
            metrics = {}
            for subset in self.val_dataloader:
                assert getattr(subset, "name", None), "multi-val loaders need names"
                sub = self._run_metrics_over(subset, n_batches=n_batches, generator=generator)
                metrics.update({f"{subset.name}/{k}": v for k, v in sub.items()})
            return metrics
        return self._run_metrics_over(self.val_dataloader, n_batches=n_batches,
                                      generator=generator)

    def _phase_id(self, step: int) -> int:
        return step // self.save_every

    def validation_phase(self, step: int, logger, _smoke_test: bool = False):
        n_batches = 2 if _smoke_test else self.n_validation_batches
        # a fresh draw per validation phase, from its id (the same across
        # resumes), so the stochastic metrics do not reuse one draw forever
        phase_id = self._phase_id(step)
        metrics = self.metrics_loop(n_batches=n_batches,
                                    generator=self._phase_generator(phase_id))
        for k, v in metrics.items():
            logger.add_scalar(f"val-means/{k}", scalar_value=v, global_step=phase_id)
            self._track_best_metric(k, v, step, _smoke_test)
        for callback in self.callbacks:
            callback(model=self.inference_model, logger=logger, epoch=phase_id)

    def _track_best_metric(self, metric_key, metric_value, step, _smoke_test):
        # the reference tracks these two families
        tracked = ("chamfer_distance", "logp/total")
        if not any(t in metric_key for t in tracked):
            return
        maximize = "logp" in metric_key.lower()
        path_to_delete = path_to_create = None
        if metric_key in self.current_best_metric:
            prev_step, prev_value = self.current_best_metric[metric_key]
            better = metric_value > prev_value if maximize else metric_value < prev_value
            if better:
                path_to_delete = self._best_ckpt_path(metric_key, prev_step)
                path_to_create = self._best_ckpt_path(metric_key, step)
                self.current_best_metric[metric_key] = (step, metric_value)
        else:
            path_to_create = self._best_ckpt_path(metric_key, step)
            self.current_best_metric[metric_key] = (step, metric_value)
        if _smoke_test:
            assert path_to_delete is None
            path_to_delete = path_to_create  # create, then delete at once
            self.current_best_metric.pop(metric_key, None)
        if path_to_create is not None:
            self.save(os.path.relpath(path_to_create, self.save_path), step)
        if path_to_delete is not None and os.path.exists(path_to_delete):
            shutil.rmtree(path_to_delete)

    @property
    def _best_ckpt_dir(self) -> str:
        return os.path.join(self.save_path, "best-checkpoints")

    def _best_ckpt_path(self, metric_key: str, metric_step: int) -> str:
        key_no_slash = metric_key.replace("/", "__")
        return os.path.join(self._best_ckpt_dir, f"{key_no_slash}-step-{metric_step}")

    # -- the training loop --

    def _train_mode(self):
        self.model.train(not self.train_in_inference_mode)

    def fit(self):
        self._init_opt_state()
        step_fn = make_train_step(self.optimizer, loss_scale=self.loss_scale,
                                  ema_alpha=self.ema_alpha)

        if not (self.skip_smoke_test or self.profile_path is not None):
            print("[trainer] smoke-testing the validation phase...")
            self.validation_phase(0, MockWriter(), _smoke_test=True)
            print("[trainer] validation smoke test passed")

        loss_ema = None
        loss_avg = 0.0
        logger = make_writer(os.path.join(self.save_path, "tensorboard"))
        step = self.initial_step_number
        data = None
        profiler = None
        t_last = time.perf_counter()
        # deferred losses: (step, loss on the card, host batch), the batch
        # kept so that a non-finite loss found later still dumps its batch
        pending: list = []

        def drain_pending():
            nonlocal loss_ema, loss_avg, t_last, data
            if not pending:
                return
            values = torch.stack([lo for _, lo, _ in pending]).float().cpu().tolist()
            for (s, _, ex), value in zip(pending, values):
                if not math.isfinite(value):
                    data = ex  # the dump below takes this batch
                    pending.clear()
                    raise NaNError(f"NaN loss at step {s}")
                offset = s - self.initial_step_number
                loss_avg += (value - loss_avg) / (offset + 1)
                loss_ema = value if loss_ema is None else value * 0.1 + loss_ema * 0.9
                logger.add_scalar("train/loss", scalar_value=value, global_step=s)
                if s % 100 == 0:
                    now = time.perf_counter()
                    rate = 100 / (now - t_last) if s > 0 else 0.0
                    t_last = now
                    print(f"step {s} loss_ema {loss_ema:.4f} it/s {rate:.2f}", flush=True)
            pending.clear()

        try:
            for step_offset, data in enumerate(self.train_dataloader):
                step = self.initial_step_number + step_offset
                if self.profile_path is not None and step == 20:
                    profiler = torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA]
                           if self.device.type == "cuda" else []))
                    profiler.start()
                    profile_start = time.perf_counter()
                self._train_mode()
                example = self._to_device(data)
                loss, self.opt_state = step_fn(self.model, self.ema_model, self.opt_state,
                                               example.points, self.step_generator(step),
                                               raw_ctx=example.ctx)
                pending.append((step, loss, data))
                if step == self.initial_step_number or len(pending) >= max(
                        1, self.loss_sync_every):
                    drain_pending()

                if (step + 1) % self.save_every == 0:
                    drain_pending()
                    self.save(CHECKPOINT_SAVE_TEMPLATE.format(step), step)
                    logger.add_scalar("train/mean_loss", scalar_value=loss_avg,
                                      global_step=self._phase_id(step))
                    self.validation_phase(step=step, logger=logger)
                    if step > self.save_every and not self.keep_all_checkpoints:
                        self._prune_stale_checkpoints(step)

                if step >= self.num_steps:
                    drain_pending()
                    break

                if profiler is not None and step == 25:
                    drain_pending()
                    profiler.stop()
                    os.makedirs(self.profile_path, exist_ok=True)
                    profiler.export_chrome_trace(os.path.join(self.profile_path, "trace.json"))
                    print(f"[trainer] profiled window wall time: "
                          f"{time.perf_counter() - profile_start:.2f}s")
                    return
            drain_pending()
        except Exception as e:
            if data is not None:
                # the offending batch, for forensics
                try:
                    flat = {f"leaf_{i}": np.asarray(leaf)
                            for i, leaf in enumerate(tree_leaves(data))}
                    np.savez(os.path.join(self.save_path, "offending-data.npz"), **flat)
                except Exception:
                    pass
            raise
        finally:
            self.save(f"final-checkpoint-{step}", step)
            print("[trainer] final checkpoint written")
            logger.close()


def train(*args, recover_from_checkpoint: bool = True, **kwargs) -> Trainer:
    """Build a ``Trainer``, resume from its newest checkpoint, fit."""
    trainer = Trainer(*args, **kwargs)
    if recover_from_checkpoint:
        trainer.recover_from_checkpoint()
    trainer.fit()
    return trainer
