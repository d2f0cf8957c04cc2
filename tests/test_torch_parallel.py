"""The port's data parallelism (``gecco_tpu_torch.parallel``, the loader's
``shard_by_process``, the train step's and the ``Trainer``'s mesh) on the
CPU, with gloo.

In process: ``init_distributed`` outside a cluster, ``shard_batch``'s moves
and slices, and a world of one (no group, or a group of one) giving the
same bits as the step without a mesh and issuing no collective. Point
sharding (the mesh's ``seq`` axis, ``shard_points``) is tested in
``test_torch_seq.py``.

Two gloo ranks run as subprocesses (this file, run with ``rank port dir``
arguments) on a 1-layer fp32 flagship at C 64 with 4 inducers and 4 heads
(at C 32 the 32 GroupNorm groups hold one channel each, five gradients are
rounding noise and AdaBelief's first, sign-like step moves those weights
by a whole learning rate either way),
global batch 16, each rank loading its rows with ``shard_by_process=True``:
three ``make_train_step`` steps with the generator's draws, with dropout,
and with the JAX package's draws, then ``Trainer.fit`` for 4 steps with a
checkpoint every 2 and a run cut after 2 and resumed, and three validation
phases whose tracked metric differs between the ranks. The parent holds
them against each other, against one process over the same global batches,
and against the JAX package's ``make_train_step``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gecco_tpu_torch.data import dataloader
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.parallel import (
    Mesh,
    all_reduce_mean_,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from gecco_tpu_torch.reparam import GaussianReparam
from gecco_tpu_torch.train import (
    Trainer,
    adabelief,
    chain,
    clip_by_global_norm,
    make_ema,
    make_train_step,
    warmup_cosine_decay_schedule,
)
from gecco_tpu_torch.train import trainer as trainer_mod
from gecco_tpu_torch.types import Context3d, Example
from gecco_tpu_torch.utils.logging import JsonlWriter, MockWriter

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DIMS = dict(n_layers=1, feature_dim=64, num_inducers=4, num_heads=4)
N_POINTS, BATCH, STEPS = 128, 16, 3
SCHED = (1e-3, 3e-3, 2, 100, 1e-4)  # warmup-cosine: every parameter moves
P_DROP = 0.25


class Blobs:
    """Gaussian blobs around random centres (``tests/multihost_common.py``'s
    ``BlobDataset`` at 128 points), centres and spread at the scale of the
    model's reparam (std ~0.35, as ``test_torch_train.py``'s clouds): blobs
    of spread 0.1 around unit centres make the pool's projection so
    ill-conditioned that one process alone departs from the JAX step by
    more than that file's tolerance."""

    def __init__(self, n=64, seed=0):
        rng = np.random.default_rng(seed)
        centers = 0.35 * rng.normal(size=(n, 1, 3)).astype(np.float32)
        self.clouds = centers + 0.35 * rng.normal(size=(n, N_POINTS, 3)).astype(np.float32)

    def __len__(self):
        return len(self.clouds)

    def __getitem__(self, i):
        return Example(self.clouds[i], None)


def port_model(dropout_p=0.0):
    """``torch_parity.torch_model``'s construction at ``DIMS`` (its weights
    come from a state dict)."""
    gen = torch.Generator().manual_seed(0)
    backbone = SetTransformer(embed_dim=1, compute_dtype=torch.float32, attn_impl="folded_pallas",
                              device="cpu", generator=gen, **DIMS)
    net = UnconditionalPointNetwork(backbone, DIMS["feature_dim"], device="cpu", generator=gen)
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=4)
    model = Diffusion(net, sched, reparam=GaussianReparam([0.0] * 3, [1.0] * 3, device="cpu"))
    for m in model.modules():
        if hasattr(m, "dropout_p"):
            m.dropout_p = dropout_p
    return model


def optimizer():
    return chain(clip_by_global_norm(1.0), adabelief(warmup_cosine_decay_schedule(*SCHED)))


def loader(shard_by_process: bool, n_steps=STEPS):
    return dataloader(Blobs(), batch_size=BATCH, num_steps=n_steps, num_workers=1,
                      shard_by_process=shard_by_process)


def run_steps(init: dict, shard_by_process: bool, mesh=None, dropout_p=0.0, draws=None):
    """``STEPS`` train steps from the weights ``init``: the draws from a
    generator seeded by the step, or the given global ``draws`` (sigma,
    noise) cut to the rank's rows. Returns (losses, model, ema)."""
    model = port_model(dropout_p)
    model.load_state_dict(init)
    mesh = Mesh() if mesh is None else mesh
    opt = optimizer()
    step = make_train_step(opt, ema_alpha=0.9, mesh=mesh)
    ema, state = make_ema(model), opt.init(list(model.parameters()))
    losses = []
    for k, batch in enumerate(loader(shard_by_process)):
        ex = shard_batch(batch, mesh, "cpu", local=shard_by_process)
        if draws is None:
            loss, state = step(model, ema, state, ex.points, torch.Generator().manual_seed(7 + k))
        else:
            rows = slice(mesh.rank * ex.points.shape[0], (mesh.rank + 1) * ex.points.shape[0])
            sigma, noise = (torch.from_numpy(d[k][rows]) for d in draws)
            loss, state = step(model, ema, state, ex.points, sigma=sigma, noise=noise)
        losses.append(float(loss))
    return np.array(losses), model, ema


def _flat(model, ema) -> dict:
    out = {f"model.{k}": v.numpy() for k, v in model.state_dict().items()}
    out.update({f"ema.{k}": v.numpy() for k, v in ema.state_dict().items()})
    return out


def _fit_trainer(save_path, train, num_steps, **kw):
    return Trainer(model=lambda g: port_model(), train_dataloader=train,
                   val_dataloader=dataloader(Blobs(n=8, seed=1), batch_size=4, fixed_sampler=True,
                                             num_workers=1),
                   save_path=str(save_path), save_every=2, num_steps=num_steps,
                   optimizer=optimizer(), n_validation_batches=1, device="cpu",
                   loss_sync_every=2, seed=7, **kw)


class RankMetric:
    """A tracked metric (a ``chamfer_distance``) that gives, at each
    validation phase, the next of this rank's own ``values``."""

    name = "chamfer_distance"

    def __init__(self, values):
        self.values = iter(values)

    def __call__(self, model, points, ctx, generator):
        return {"mean": torch.tensor([next(self.values)])}


# each rank's value of the tracked metric at validation phases 1, 3 and 5:
# the same, then rank 0's better than the best and rank 1's worse, then the
# other way round (the card's sums may differ so in their last bits)
RANK_METRIC = {0: (1.0, 1.0 - 1e-7, 1.0 + 1e-7), 1: (1.0, 1.0 + 1e-7, 0.5)}


def _child(rank: str, port: str, out: str) -> None:
    """One of two ranks: every scenario, its results written under ``out``."""
    torch.set_num_threads(1)
    rank = int(rank)
    trainer_mod.make_writer = JsonlWriter  # no TensorBoard import
    assert init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank) == rank
    assert init_distributed() == rank  # a second call is a no-op
    mesh = make_mesh()
    assert (mesh.size, mesh.rank) == (2, rank)
    init = torch.load(os.path.join(out, "init.pt"))
    with np.load(os.path.join(out, "draws.npz")) as f:
        draws = (f["sigma"], f["noise"])
    for name, kw in (("gen", {}), ("dropout", dict(dropout_p=P_DROP)), ("jax", dict(draws=draws))):
        losses, model, ema = run_steps(init, True, mesh, **kw)
        np.savez(os.path.join(out, f"{name}_{rank}.npz"), losses=losses, **_flat(model, ema))

    # the Trainer: 4 steps with a checkpoint every 2, from the loader's
    # rows; then a run cut after 2 steps and resumed, from global batches
    whole = _fit_trainer(os.path.join(out, "whole"), loader(True, 4), num_steps=3)
    whole.recover_from_checkpoint()
    whole.fit()
    batches = list(loader(False, 4))
    first = _fit_trainer(os.path.join(out, "cut"), batches[:2], num_steps=1)
    first.recover_from_checkpoint()
    first.fit()
    resumed = _fit_trainer(os.path.join(out, "cut"), batches[2:], num_steps=3)
    resumed.recover_from_checkpoint(fail_if_unavailable=True)
    assert resumed.initial_step_number == 2
    resumed.fit()
    for name, t in (("whole", whole), ("resumed", resumed)):
        np.savez(os.path.join(out, f"{name}_{rank}.npz"), **_flat(t.model, t.ema_model))

    best = _fit_trainer(os.path.join(out, "best"), [], num_steps=0,
                        metrics=[RankMetric(RANK_METRIC[rank])])
    best._init_opt_state()
    for step in (1, 3, 5):
        best.validation_phase(step, MockWriter())
    with open(os.path.join(out, f"best_{rank}.json"), "w") as f:
        json.dump(best.current_best_metric, f)
    dist.destroy_process_group()
    print("RANK DONE", rank, flush=True)


# ------------------------------------------------------------ in process --


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_init_distributed_without_a_cluster_returns_0(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == 0
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.data, mesh.seq, mesh.rank, mesh.size) == (1, 1, 0, 1)
    with pytest.raises(ValueError):
        make_mesh(data=2)


def _ctx_example(b=4):
    rng = np.random.default_rng(0)
    return Example(rng.normal(size=(b, 8, 3)).astype(np.float32),
                   Context3d(rng.normal(size=(b, 5, 6, 3)).astype(np.float32),
                             rng.normal(size=(b, 3, 3)).astype(np.float32)),
                   np.arange(b))


def test_shard_batch_on_a_world_of_one_only_moves():
    ex = _ctx_example()
    out = shard_batch(ex, Mesh(), "cpu")
    for a, b in zip((out.points, out.ctx.image, out.ctx.K, out.extras),
                    (ex.points, ex.ctx.image, ex.ctx.K, ex.extras)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
    assert out.ctx.wmat == ()


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_slices_points_and_context_rows(rank):
    ex = _ctx_example()
    mesh = Mesh(data=2, rank=rank)
    out = shard_batch(ex, mesh, "cpu")
    rows = slice(2 * rank, 2 * rank + 2)
    np.testing.assert_array_equal(out.points.numpy(), ex.points[rows])
    np.testing.assert_array_equal(out.ctx.image.numpy(), ex.ctx.image[rows])
    np.testing.assert_array_equal(out.ctx.K.numpy(), ex.ctx.K[rows])
    np.testing.assert_array_equal(out.extras.numpy(), ex.extras[rows])
    # rows a loader already cut pass through
    local = shard_batch(out, mesh, "cpu", local=True)
    np.testing.assert_array_equal(local.points.numpy(), ex.points[rows])
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(Example(np.zeros((3, 4, 3), np.float32)), mesh, "cpu")


def _init_state():
    return port_model().state_dict()


def test_a_world_of_one_issues_no_collective_and_keeps_the_bits(monkeypatch, tmp_path):
    """The step without a mesh, with a mesh of one and under a gloo group of
    one: the same bits, and no collective outside the group's own set-up."""
    init = _init_state()
    ref_losses, ref_model, ref_ema = run_steps(init, False)

    def refuse(*a, **k):
        raise AssertionError("a collective on a world of one")

    for name in ("all_reduce", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    losses, model, ema = run_steps(init, False, Mesh())
    assert replicate(model, Mesh()) is model
    all_reduce_mean_([torch.ones(3)], Mesh())
    Mesh().barrier()
    monkeypatch.undo()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        for name in ("all_reduce", "broadcast"):
            monkeypatch.setattr(dist, name, refuse)
        mesh = make_mesh()
        assert mesh.size == 1
        g_losses, g_model, g_ema = run_steps(init, True, mesh)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
    for ls, m, e in ((losses, model, ema), (g_losses, g_model, g_ema)):
        np.testing.assert_array_equal(ls, ref_losses)
        for a, b in zip([*m.state_dict().values(), *e.state_dict().values()],
                        [*ref_model.state_dict().values(), *ref_ema.state_dict().values()]):
            assert torch.equal(a, b)


# -------------------------------------------------------------- two ranks --


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX reference and its draws, the initial weights, then both ranks
    run once; returns (dir, JAX losses, JAX params, JAX EMA)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gecco_tpu.train.trainer import make_train_step as jmake_train_step
    from torch_parity import jax_draws, jax_model, jax_params, torch_model

    torch.set_num_threads(2)
    out = tmp_path_factory.mktemp("ranks")
    jm = jax_model("folded_pallas", **DIMS)
    torch.save(torch_model(jm, "folded_pallas", **DIMS).state_dict(), out / "init.pt")
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adabelief(optax.warmup_cosine_decay_schedule(*SCHED)))
    jstep = jax.jit(jmake_train_step(jopt, ema_alpha=0.9, donate=False))
    jema, jstate = jax.tree.map(jnp.copy, jm), jopt.init(jm)
    sigmas, noises, jlosses = [], [], []
    for k, batch in enumerate(loader(False)):
        key = jax.random.PRNGKey(20 + k)
        sigma, noise = jax_draws(jm, batch.points, key)
        sigmas.append(sigma)
        noises.append(noise)
        jloss, jm, jema, jstate = jstep(jm, jema, jstate, jnp.asarray(batch.points), None, key)
        jlosses.append(float(jloss))
    np.savez(out / "draws.npz", sigma=np.stack(sigmas), noise=np.stack(noises))

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + HERE
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=REPO) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{text[-4000:]}"
    return out, np.array(jlosses), jax_params(jm), jax_params(jema)


def _load(out, name, rank) -> dict:
    with np.load(out / f"{name}_{rank}.npz") as f:
        return dict(f)


def _state_of(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: torch.from_numpy(v) for k, v in flat.items()
            if k.startswith(prefix + ".")}


@pytest.mark.parametrize("scenario,dropout_p", [("gen", 0.0), ("dropout", P_DROP)])
def test_two_ranks_train_the_steps_of_one_process(two_ranks, scenario, dropout_p):
    """Both ranks log the same (all-reduced) losses and keep the same
    weights; one process over the same global batches and draws takes the
    same steps within fp32 rounding (the ranks' halves of the batch means
    add in another order; the absolute 1e-6 is for weights near zero)."""
    out = two_ranks[0]
    r0, r1 = _load(out, scenario, 0), _load(out, scenario, 1)
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-6)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    losses, model, ema = run_steps(torch.load(out / "init.pt"), False, dropout_p=dropout_p)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    for k, v in _flat(model, ema).items():
        np.testing.assert_allclose(r0[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_two_ranks_match_the_jax_train_step(two_ranks):
    """Fed the JAX package's draws (each rank its rows), the two ranks take
    ``make_train_step``'s steps at ``test_torch_train.py``'s tolerance."""
    from gecco_tpu_torch.convert import to_jax_params

    out, jlosses, jparams, jema = two_ranks
    r0 = _load(out, "jax", 0)
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-5)
    for prefix, ref in (("model", jparams), ("ema", jema)):
        model = port_model()
        model.load_state_dict(_state_of(r0, prefix))
        ours = to_jax_params(model)
        for name in ref:
            np.testing.assert_allclose(ours[name], ref[name], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{prefix}.{name}")


def test_two_rank_trainer_writes_one_checkpoint_set_and_resumes(two_ranks):
    out = two_ranks[0]
    assert sorted(os.listdir(out / "whole")) == [
        "best-checkpoints", "checkpoint-step-3", "final-checkpoint-3", "tensorboard"]
    for ckpt in ("checkpoint-step-3", "final-checkpoint-3"):
        assert sorted(os.listdir(out / "whole" / ckpt)) == [
            "ema.pt", "meta.json", "model.pt", "opt.pt"]
    w0, w1 = _load(out, "whole", 0), _load(out, "whole", 1)
    c0, c1 = _load(out, "resumed", 0), _load(out, "resumed", 1)
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
        # the loader's rows and shard_batch's cut of the global batch agree,
        # and the resumed run takes the uninterrupted one's steps
        np.testing.assert_array_equal(c0[k], w0[k], err_msg=k)
        np.testing.assert_array_equal(c1[k], w0[k], err_msg=k)
    saved = torch.load(out / "whole" / "final-checkpoint-3" / "model.pt")
    for k, v in saved.items():
        np.testing.assert_array_equal(v.numpy(), w0[f"model.{k}"], err_msg=k)


def test_two_ranks_make_rank_0s_best_checkpoint_choices(two_ranks):
    """Where the ranks' values of a tracked metric fall on either side of
    the best, every rank takes rank 0's: the same best on both, one best
    checkpoint (phase 3's), and no rank left alone at ``save``'s barrier."""
    out = two_ranks[0]
    b0, b1 = (json.loads((out / f"best_{r}.json").read_text()) for r in range(2))
    assert b0 == b1
    assert b0 == {"chamfer_distance/mean": [3, float(np.float32(1.0 - 1e-7))]}
    assert os.listdir(out / "best" / "best-checkpoints") == ["chamfer_distance__mean-step-3"]


if __name__ == "__main__":
    _child(*sys.argv[1:])
