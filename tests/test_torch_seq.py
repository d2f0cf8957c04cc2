"""Point sharding in the port (the mesh's ``seq`` axis: ``make_mesh(seq>1)``,
``shard_batch(shard_points=True)``, ``make_train_step(shard_points=True)``,
``Trainer(shard_points=True)``) on the CPU, with gloo.

In process: ``make_mesh``'s layout against the JAX mesh's and its errors,
``shard_batch`` cutting the points by the seq index and the context by rows
only, the collectives and the train step on a world of one, the draws' and
the dropout masks' slices, and ``Example.discard_extras``.

Two gloo ranks (``data 1 x seq 2``) run as subprocesses of this file
(``python tests/test_torch_seq.py two RANK PORT DIR``): the adjoints of
``gather_points`` and ``sum_over_points`` (the dot-product test), then
three steps of 2-layer fp32 models at C 64 with 8 inducers on 64-point
clouds at batch 4, each rank holding 32 points of every cloud:
``folded_pallas``, ``xla``, the per-head ``pallas`` route, ``folded_pallas``
with dropout (the MLPs unfused, the masks drawn at every point), the
image-conditional model (UVL reparam, a miniature ConvNeXt, ``RayNetwork``)
with remat, and a bf16 ``folded_pallas`` model with remat; each rank's
collectives in the first step are logged. Then the ``Trainer`` on
``make_mesh(1, 2)``: 4 steps with a checkpoint every 2, and a run cut after
2 and resumed. The parent holds them against one process on the same
weights, batches and draws. Four gloo ranks (``data 2 x seq 2``) take one
step against the JAX package's ``make_train_step`` on one device.
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
from gecco_tpu_torch.data.procedural import make_clouds, make_conditional_batch
from gecco_tpu_torch.diffusion import Diffusion, LogUniformSchedule
from gecco_tpu_torch.models import (
    ConvNeXtExtractor,
    RayNetwork,
    SetTransformer,
    UnconditionalPointNetwork,
)
from gecco_tpu_torch.models import convnext as cnx
from gecco_tpu_torch.models.mlp import shard_dropout, shard_point_dropout
from gecco_tpu_torch.parallel import (
    Mesh,
    gather_points,
    init_distributed,
    make_mesh,
    point_shard,
    points_group,
    shard_batch,
    sharding_points,
    sum_over_points,
)
from gecco_tpu_torch.reparam import GaussianReparam, UVLReparam
from gecco_tpu_torch.train import (
    Trainer,
    chain,
    clip_by_global_norm,
    make_ema,
    make_train_step,
    scale_by_learning_rate,
)
from gecco_tpu_torch.train import trainer as trainer_mod
from gecco_tpu_torch.types import Context3d, Example
from gecco_tpu_torch.utils.logging import JsonlWriter

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DIMS = dict(n_layers=2, feature_dim=64, num_inducers=8, num_heads=4)
N_POINTS, BATCH, STEPS, LR = 64, 4, 3, 1e-2
# the step against the JAX package's: the clipped update's whole norm, so
# that the weights' elementwise tolerance holds the step itself
JAX_LR = 1.0
# a miniature ConvNeXt (blocks and channels per stage), its pyramid's
# first three stages 8 + 16 + 32 channels; images of 32^2
MINI = ((1, 1, 1, 1), (8, 16, 32, 64))
IMAGE = 32
CASES = {
    "folded_pallas": dict(impl="folded_pallas"),
    "xla": dict(impl="xla"),
    "pallas": dict(impl="pallas"),
    "dropout": dict(impl="folded_pallas", dropout_p=0.25),
    "conditional": dict(impl="folded_pallas", conditional=True, remat=True),
    "bf16": dict(impl="folded_pallas", dtype=torch.bfloat16, remat=True),
}
# fp32: the sums over the points add in another order; bf16: the JAX
# package's mesh test's rtol
TOL = {"bf16": 1e-3}
# Where one process's own rounding moves a gradient group by more than the
# tolerance, each group is held within the tolerance or a margin times
# that move, whichever is larger (``rounding_floors``):
# - the conditional model's fp32 gradient is that sensitive to the order of
#   its sums: one process with each cloud's halves swapped moves the second
#   layer's pool-side groups by up to ~2.6e-5 (1.2e-5 to 1.6e-4 over seeds,
#   image kinds and depths); margin 4;
# - in bf16 each rank's pool and h-side backwards run on its partial
#   cotangent, each rounded to bf16 before the ranks' sum: the groups move
#   by up to ~2e-2, as one process's bf16 gradient stands from its fp32
#   twin's (seq / that ratio at most 0.96 over the three steps); margin 2
FLOORS = {"conditional": (dict(swap_halves=True), 4.0),
          "bf16": (dict(dtype=torch.float32), 2.0)}
TRAINER_STEPS = 4


def build(case: dict) -> Diffusion:
    """A seeded model of ``case`` on the CPU, its AdaGN embed weights, its
    activations' alpha and its ConvNeXt blocks' layer scales moved off their
    init (as ``torch_parity.perturb`` does), so that every parameter
    matters."""
    cnx.CONVNEXT_CONFIGS.setdefault("mini", MINI)
    gen = torch.Generator().manual_seed(0)
    backbone = SetTransformer(embed_dim=1, compute_dtype=case.get("dtype", torch.float32),
                              attn_impl=case["impl"], remat=case.get("remat", False),
                              device="cpu", generator=gen, **DIMS)
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=4)
    c = DIMS["feature_dim"]
    if case.get("conditional"):
        reparam = UVLReparam(device="cpu")
        net = RayNetwork(backbone, reparam, c, sum(MINI[1][:3]), lookup_impl="pallas",
                         device="cpu", generator=gen)
        cond = ConvNeXtExtractor("mini", compute_dtype=torch.float32, device="cpu",
                                 generator=gen)
        model = Diffusion(net, sched, reparam=reparam, cond=cond)
    else:
        net = UnconditionalPointNetwork(backbone, c, device="cpu", generator=gen)
        model = Diffusion(net, sched, reparam=GaussianReparam([0.0] * 3, [0.35] * 3,
                                                               device="cpu"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            for suffix, scale in (("scale_linear.weight", 0.002), ("bias_linear.weight", 0.002),
                                  ("activation.alpha", 0.2), ("layer_scale", 0.3)):
                if name.endswith(suffix):
                    p.add_(scale * torch.randn(p.shape, generator=gen))
    for m in model.modules():
        if hasattr(m, "dropout_p"):
            m.dropout_p = case.get("dropout_p", 0.0)
    return model


def batches(case: dict, n: int = STEPS, seed: int = 0) -> list:
    """``n`` global batches of ``BATCH`` clouds (with their images and
    cameras for the conditional model)."""
    rng = np.random.default_rng(seed)
    if case.get("conditional"):
        out = []
        for _ in range(n):
            pts, images, K = make_conditional_batch(rng, BATCH, N_POINTS, IMAGE)
            out.append(Example(pts, Context3d(images, K)))
        return out
    return [Example(c, None) for c in make_clouds(rng, n * BATCH, N_POINTS).reshape(
        n, BATCH, N_POINTS, 3)]


def optimizer(lr=LR):
    """The global-norm clip, then SGD: the weights' moves are linear in the
    gradients, so the weights are held at the gradients' tolerance."""
    return chain(clip_by_global_norm(1.0), scale_by_learning_rate(lr))


def run_steps(case: dict, mesh: Mesh, log=None, swap_halves: bool = False) -> dict:
    """``STEPS`` train steps of ``case`` from its seeded init, the draws
    from a generator seeded by the step, each rank on its rows and points
    of the global batches. ``log``: a list that keeps the first step's
    collectives. ``swap_halves`` (one process): the same function with
    each cloud's halves of points, and of the noise, swapped, its sums
    added in another order. Returns the losses, each step's gradients and
    the weights."""
    model = build(case)
    opt = optimizer()
    step = make_train_step(opt, ema_alpha=0.9, mesh=mesh, shard_points=True)
    ema, state = make_ema(model), opt.init(list(model.parameters()))
    losses, grads = [], []
    for k, batch in enumerate(batches(case)):
        ex = shard_batch(batch, mesh, "cpu", shard_points=True)
        if log is not None and k == 0:
            log.clear()
        draws = {}
        if swap_halves:
            gen = torch.Generator().manual_seed(100 + k)
            sigma, noise = model.draw_sigma_noise(gen, ex.points)
            swap = lambda t: t.roll(N_POINTS // 2, dims=1)
            ex = ex._replace(points=swap(ex.points))
            draws = dict(sigma=sigma, noise=swap(noise))
        loss, state = step(model, ema, state, ex.points, torch.Generator().manual_seed(100 + k),
                           raw_ctx=ex.ctx, **draws)
        if log is not None and k == 0:
            first = list(log)
        losses.append(float(loss))
        grads.append({n: p.grad.detach().clone() for n, p in model.named_parameters()})
    out = dict(losses=losses, grads=grads,
               weights={n: p.detach().clone() for n, p in model.named_parameters()},
               ema={n: p.detach().clone() for n, p in ema.named_parameters()})
    if log is not None:
        out["collectives"] = first
    return out


class ValSet:
    def __init__(self, n=8, seed=1):
        self.clouds = make_clouds(np.random.default_rng(seed), n, N_POINTS)

    def __len__(self):
        return len(self.clouds)

    def __getitem__(self, i):
        return Example(self.clouds[i], None)


def fit_trainer(save_path, train, num_steps, mesh=None, shard_points=False):
    trainer = Trainer(model=lambda g: build(CASES["folded_pallas"]), train_dataloader=train,
                      val_dataloader=dataloader(ValSet(), batch_size=4, fixed_sampler=True,
                                                num_workers=1),
                      save_path=str(save_path), save_every=2, num_steps=num_steps,
                      optimizer=optimizer(), n_validation_batches=1, device="cpu",
                      loss_sync_every=2, seed=7, mesh=mesh, shard_points=shard_points)
    trainer.recover_from_checkpoint()
    trainer.fit()
    return trainer


def trainer_runs(out, mesh=None, shard_points=False) -> dict:
    """The Trainer over ``TRAINER_STEPS`` global batches in one run, and in
    a run cut after 2 steps and resumed: their weights."""
    train = batches(CASES["folded_pallas"], TRAINER_STEPS, seed=5)
    whole = fit_trainer(os.path.join(out, "whole"), train, TRAINER_STEPS - 1, mesh, shard_points)
    fit_trainer(os.path.join(out, "cut"), train[:2], 1, mesh, shard_points)
    resumed = fit_trainer(os.path.join(out, "cut"), train[2:], TRAINER_STEPS - 1, mesh,
                          shard_points)
    assert resumed.initial_step_number == 2
    return {name: {n: p.detach().clone() for n, p in t.model.named_parameters()}
            for name, t in (("whole", whole), ("resumed", resumed))}


# ------------------------------------------------------------- children --


def _record_collectives(mesh: Mesh, log: list) -> None:
    """Every all-gather, reduce-scatter and all-reduce appended to ``log``
    as (name, "seq" or "world", the input's shape)."""
    for name, arg in (("all_gather_into_tensor", 1), ("reduce_scatter_tensor", 1),
                      ("all_reduce", 0)):
        fn = getattr(dist, name)

        def recording(*a, _fn=fn, _name=name, _arg=arg, group=None, **k):
            log.append((_name, "seq" if group is mesh.seq_group else "world",
                        tuple(a[_arg].shape)))
            return _fn(*a, group=group, **k)

        setattr(dist, name, recording)


def _adjoints(mesh: Mesh) -> dict:
    """The dot-product test of the collectives' adjoints in fp64: with each
    rank's input x_r and cotangent g_r, sum_r <g_r, f(x)_r> equals
    sum_r <x_r, f^T(g)_r>, where autograd's x.grad on each rank is its part
    of f^T(g); and each rank's part is the one written out."""
    group, (s, count) = mesh.seq_group, point_shard(mesh.seq_group)
    gen = torch.Generator().manual_seed(10 + mesh.rank)
    x = torch.randn((2, 3, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn((2, 3 * count, 4), generator=gen, dtype=torch.float64)
    y = gather_points(x, group)
    (y * g).sum().backward()
    every = [torch.empty_like(x) for _ in range(count)]
    dist.all_gather(every, x.detach(), group=group)
    gs = [torch.empty_like(g) for _ in range(count)]
    dist.all_gather(gs, g, group=group)
    inner = torch.stack([(y.detach() * g).sum(), (x.detach() * x.grad).sum()])
    dist.all_reduce(inner, group=group)
    gather_err = max(float((y.detach() - torch.cat(every, dim=1)).abs().max()),
                     float((x.grad - sum(h[:, 3 * s:3 * s + 3] for h in gs)).abs().max()))
    t = torch.randn((2, 5), generator=gen, dtype=torch.float64, requires_grad=True)
    h = torch.randn((2, 5), generator=gen, dtype=torch.float64)
    z = sum_over_points(t, group)
    (z * h).sum().backward()
    ts = [torch.empty_like(t) for _ in range(count)]
    dist.all_gather(ts, t.detach(), group=group)
    hs = [torch.empty_like(h) for _ in range(count)]
    dist.all_gather(hs, h, group=group)
    inner_sum = torch.stack([(z.detach() * h).sum(), (t.detach() * t.grad).sum()])
    dist.all_reduce(inner_sum, group=group)
    sum_err = max(float((z.detach() - sum(ts)).abs().max()),
                  float((t.grad - sum(hs)).abs().max()))
    return dict(gather=[float(v) for v in inner], gather_err=gather_err,
                sum=[float(v) for v in inner_sum], sum_err=sum_err)


def _child_two(rank: int, out: str) -> None:
    mesh = make_mesh(data=1, seq=2)
    assert (mesh.data, mesh.seq, mesh.data_index, mesh.seq_index) == (1, 2, 0, rank)
    assert dist.get_process_group_ranks(mesh.seq_group) == [0, 1]
    torch.save(_adjoints(mesh), os.path.join(out, f"adjoints_{rank}.pt"))
    log = []
    _record_collectives(mesh, log)
    for name, case in CASES.items():
        torch.save(run_steps(case, mesh, log), os.path.join(out, f"{name}_{rank}.pt"))
    log.clear()
    torch.save(trainer_runs(os.path.join(out, "trainer"), mesh, True),
               os.path.join(out, f"trainer_{rank}.pt"))


def _child_four(rank: int, out: str) -> None:
    mesh = make_mesh(data=2, seq=2)
    d, s = divmod(rank, 2)
    assert (mesh.data_index, mesh.seq_index) == (d, s)
    assert dist.get_process_group_ranks(mesh.seq_group) == [2 * d, 2 * d + 1]
    with pytest.raises(ValueError, match="mesh 3x2"):
        make_mesh(data=3, seq=2)
    model = build(CASES["folded_pallas"])
    model.load_state_dict(torch.load(os.path.join(out, "init.pt")))
    with np.load(os.path.join(out, "draws.npz")) as f:
        points, sigma, noise = f["points"], f["sigma"], f["noise"]
    ex = shard_batch(Example(points, None), mesh, "cpu", shard_points=True)
    b, n = ex.points.shape[:2]
    sigma = torch.from_numpy(sigma[d * b:(d + 1) * b])
    noise = torch.from_numpy(noise[d * b:(d + 1) * b, s * n:(s + 1) * n])
    opt = optimizer(JAX_LR)
    step = make_train_step(opt, ema_alpha=0.9, mesh=mesh, shard_points=True)
    ema, state = make_ema(model), opt.init(list(model.parameters()))
    loss, state = step(model, ema, state, ex.points, sigma=sigma, noise=noise)
    torch.save(dict(loss=float(loss), state=model.state_dict(), rows=b, points=n),
               os.path.join(out, f"four_{rank}.pt"))


def _child(mode: str, rank: str, port: str, out: str) -> None:
    torch.set_num_threads(1)
    rank = int(rank)
    world = dict(two=2, four=4)[mode]
    trainer_mod.make_writer = JsonlWriter  # no TensorBoard import
    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                     rank=rank)
    try:
        (_child_two if mode == "two" else _child_four)(rank, out)
    finally:
        dist.destroy_process_group()
    print("RANK DONE", rank, flush=True)


def _spawn(mode: str, world: int, out) -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + HERE
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(port), str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{text[-4000:]}"


# ----------------------------------------------------------- comparisons --


def group_of(name: str) -> str:
    """A parameter's group: its name without the layer index (every
    layer's ``broadcast.pool.kv_proj.weight`` in one group)."""
    parts = name.split(".")
    if "layers" in parts:
        k = parts.index("layers")
        parts = parts[:k] + parts[k + 2:]
    return ".".join(parts)


def grouped_rel(a: dict, ref: dict) -> dict:
    """{group: ||a - ref|| / ||ref||}, each group's tensors flattened
    together, in fp64."""
    names = {}
    for n in ref:
        names.setdefault(group_of(n), []).append(n)
    flat = lambda d, ns: torch.cat([d[n].double().flatten() for n in ns])
    return {g: float((flat(a, ns) - flat(ref, ns)).norm() / flat(ref, ns).norm().clamp_min(1e-30))
            for g, ns in names.items()}


def assert_groups_close(a: dict, ref: dict, tol: float, what: str, floors=None) -> None:
    """Each group within ``tol`` or its ``floors`` entry, the larger."""
    floors = floors or {}
    errs = grouped_rel(a, ref)
    bad = {g: (e, floors.get(g)) for g, e in errs.items() if not e <= max(tol, floors.get(g, 0))}
    assert not bad, f"{what}: groups beyond {tol} (error, floor): {bad}"


# ------------------------------------------------------------ in process --


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("data,seq", [(2, 2), (4, 2), (1, 4), (8, 1)])
def test_mesh_lays_ranks_out_as_the_jax_mesh(data, seq):
    import jax

    from gecco_tpu.parallel.mesh import make_mesh as jmake_mesh

    devices = jax.devices()[:data * seq]
    jmesh = jmake_mesh(data, seq, devices=devices)
    place = {dev.id: (d, s) for (d, s), dev in np.ndenumerate(jmesh.devices)}
    for rank, dev in enumerate(devices):
        mesh = Mesh(data=data, seq=seq, rank=rank)
        assert (mesh.data_index, mesh.seq_index) == place[dev.id]
        assert mesh.is_main == (rank == 0)
        assert mesh.size == data * seq


def test_make_mesh_on_a_world_of_one_and_its_errors():
    mesh = make_mesh()
    assert (mesh.data, mesh.seq, mesh.rank, mesh.seq_group) == (1, 1, 0, None)
    assert make_mesh(1, 1) == mesh
    for kw, match in ((dict(seq=2), "mesh 0x2 != 1"), (dict(data=1, seq=2), "mesh 1x2 != 1"),
                      (dict(data=2), "mesh 2x1 != 1"), (dict(seq=0), "at least 1")):
        with pytest.raises(ValueError, match=match):
            make_mesh(**kw)


def _ctx_example(b=4, n=8):
    rng = np.random.default_rng(0)
    return Example(rng.normal(size=(b, n, 3)).astype(np.float32),
                   Context3d(rng.normal(size=(b, 5, 6, 3)).astype(np.float32),
                             rng.normal(size=(b, 3, 3)).astype(np.float32)),
                   np.arange(b))


@pytest.mark.parametrize("rank", range(4))
def test_shard_points_cuts_points_by_seq_and_context_by_rows(rank):
    ex = _ctx_example()
    mesh = Mesh(data=2, seq=2, rank=rank)
    d, s = divmod(rank, 2)
    rows, pts = slice(2 * d, 2 * d + 2), slice(4 * s, 4 * s + 4)
    out = shard_batch(ex, mesh, "cpu", shard_points=True)
    np.testing.assert_array_equal(out.points.numpy(), ex.points[rows, pts])
    np.testing.assert_array_equal(out.ctx.image.numpy(), ex.ctx.image[rows])
    np.testing.assert_array_equal(out.ctx.K.numpy(), ex.ctx.K[rows])
    np.testing.assert_array_equal(out.extras.numpy(), ex.extras[rows])
    # without shard_points a row's seq ranks hold the same whole rows
    whole = shard_batch(ex, mesh, "cpu")
    np.testing.assert_array_equal(whole.points.numpy(), ex.points[rows])
    # rows a loader already cut: the points are still cut
    local = Example(ex.points[rows], Context3d(ex.ctx.image[rows], ex.ctx.K[rows]))
    out = shard_batch(local, mesh, "cpu", local=True, shard_points=True)
    np.testing.assert_array_equal(out.points.numpy(), ex.points[rows, pts])
    np.testing.assert_array_equal(out.ctx.image.numpy(), ex.ctx.image[rows])
    # any other record: every leaf along its second axis too
    a, b = shard_batch((ex.points, ex.points + 1), mesh, "cpu", shard_points=True)
    np.testing.assert_array_equal(b.numpy(), ex.points[rows, pts] + 1)


def test_shard_points_raises_where_the_points_do_not_split():
    mesh = Mesh(data=1, seq=2, rank=1)
    with pytest.raises(ValueError, match="point count 7 not divisible by 2"):
        shard_batch(Example(np.zeros((2, 7, 3), np.float32)), mesh, "cpu", shard_points=True)
    with pytest.raises(ValueError, match="global batch 3 not divisible by 2"):
        shard_batch(Example(np.zeros((3, 8, 3), np.float32)), Mesh(data=2, seq=2), "cpu",
                    shard_points=True)


def test_shard_points_without_a_seq_axis_keeps_every_point():
    ex = _ctx_example()
    out = shard_batch(ex, Mesh(data=2, rank=1), "cpu", shard_points=True)
    np.testing.assert_array_equal(out.points.numpy(), ex.points[2:])
    out = shard_batch(ex, Mesh(), "cpu", shard_points=True)
    np.testing.assert_array_equal(out.points.numpy(), ex.points)


def test_collectives_without_a_group_are_the_identity(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a collective without a group")

    for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"):
        monkeypatch.setattr(dist, name, refuse)
    x = torch.randn(2, 5, 4, requires_grad=True)
    assert gather_points(x, None) is x
    assert sum_over_points(x, None) is x
    (gather_points(x, None) * 3.0).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))
    assert points_group() is None and point_shard(None) == (0, 1)
    with sharding_points(None):
        assert points_group() is None


def test_collectives_on_a_group_of_one_are_the_identity(monkeypatch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"):
            monkeypatch.setattr(dist, name, lambda *a, **k: pytest.fail("a collective"))
        x = torch.randn(2, 5, 4)
        assert gather_points(x, group) is x and sum_over_points(x, group) is x
        assert point_shard(group) == (0, 1)
        with sharding_points(group):
            assert points_group() is None
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_draws_keep_the_ranks_rows_and_points():
    """The noise drawn for a rank's rows and points is that slice of one
    process's draw at the global batch; sigma the rows'."""
    model = build(CASES["xla"])
    points = torch.zeros(BATCH, N_POINTS, 3)
    sigma, noise = model.draw_sigma_noise(torch.Generator().manual_seed(3), points)
    for d in range(2):
        for s in range(2):
            local = points[:2, :N_POINTS // 2]
            ls, ln = model.draw_sigma_noise(torch.Generator().manual_seed(3), local, (d, 2), (s, 2))
            assert torch.equal(ls, sigma[2 * d:2 * d + 2])
            assert torch.equal(ln, noise[2 * d:2 * d + 2, 32 * s:32 * s + 32])


def test_point_dropout_keeps_the_ranks_slice_of_the_global_mask():
    def draw_from(seed):
        gen = torch.Generator().manual_seed(seed)
        return lambda p, shape: torch.rand(shape, generator=gen) < p

    whole = draw_from(4)(0.5, (4, 16, 6))
    for d in range(2):
        for s in range(2):
            draw = shard_point_dropout(shard_dropout(draw_from(4), d, 2), s, 2)
            assert torch.equal(draw(0.5, (2, 8, 6)), whole[2 * d:2 * d + 2, 8 * s:8 * s + 8])
    one = draw_from(4)
    assert shard_point_dropout(one, 0, 1) is one


def test_train_step_refuses_a_seq_mesh_without_its_group():
    with pytest.raises(ValueError, match="seq group"):
        make_train_step(optimizer(), mesh=Mesh(data=1, seq=2), shard_points=True)
    # without shard_points a row's seq ranks train on whole clouds
    make_train_step(optimizer(), mesh=Mesh(data=1, seq=2))


def test_trainer_refuses_a_loader_split_on_another_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "make_writer", JsonlWriter)
    loader = dataloader(ValSet(), batch_size=4, num_steps=1, num_workers=1,
                        shard_by_process=True, mesh=Mesh(data=2, seq=2, rank=3))
    assert (loader.process_index, loader.process_count) == (1, 2)
    with pytest.raises(ValueError, match="build the loader with mesh="):
        Trainer(model=lambda g: build(CASES["xla"]), train_dataloader=loader,
                val_dataloader=[], save_path=str(tmp_path), device="cpu")


def test_discard_extras_empties_extras_and_keeps_points_and_context():
    ex = _ctx_example()
    out = ex.discard_extras()
    assert isinstance(out, Example) and out.extras == ()
    assert out.points is ex.points and out.ctx is ex.ctx


def test_a_world_of_one_with_shard_points_keeps_the_bits():
    """``shard_points`` on a world of one: the steps of the step without
    it, bit for bit."""
    case = CASES["folded_pallas"]
    ref = run_steps(case, Mesh())
    model = build(case)
    opt = optimizer()
    step = make_train_step(opt, ema_alpha=0.9)
    ema, state = make_ema(model), opt.init(list(model.parameters()))
    for k, batch in enumerate(batches(case)):
        loss, state = step(model, ema, state, torch.from_numpy(batch.points),
                           torch.Generator().manual_seed(100 + k))
        assert float(loss) == ref["losses"][k]
    for n, p in model.named_parameters():
        assert torch.equal(p, ref["weights"][n]), n


# -------------------------------------------------------------- two ranks --


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks run once; returns their directory."""
    out = tmp_path_factory.mktemp("seq")
    _spawn("two", 2, out)
    return out


def _both(out, name):
    return [torch.load(out / f"{name}_{r}.pt") for r in range(2)]


def test_collectives_adjoints_hold_on_two_ranks(two_ranks):
    for rec in _both(two_ranks, "adjoints"):
        assert rec["gather_err"] == 0.0 and rec["sum_err"] == 0.0
        for a, b in (rec["gather"], rec["sum"]):
            assert abs(a - b) <= 1e-12 * abs(a)


def rounding_floors(name: str, one: dict) -> dict:
    """{quantity: {group: margin x one process's own rounding move}} for
    the cases of ``FLOORS`` (empty for the others), the quantities each
    step's gradient (``grads0`` ...), the weights and the EMA: the move of
    the same steps with each cloud's halves swapped, or of the model's fp32
    twin."""
    if name not in FLOORS:
        return {}
    kw, margin = FLOORS[name]
    case = dict(CASES[name], **{k: v for k, v in kw.items() if k == "dtype"})
    witness = run_steps(case, Mesh(), swap_halves=kw.get("swap_halves", False))
    pairs = {f"grads{k}": (g, ref) for k, (g, ref) in enumerate(zip(witness["grads"],
                                                                    one["grads"]))}
    pairs.update({q: (witness[q], one[q]) for q in ("weights", "ema")})
    return {q: {grp: margin * e for grp, e in grouped_rel(*pair).items()}
            for q, pair in pairs.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_two_seq_ranks_train_the_steps_of_one_process(two_ranks, name):
    """On ``data 1 x seq 2`` each rank holds half of every cloud's points;
    the ranks keep the same weights, and the loss, every parameter group's
    gradient of each step and the weights after the steps are one
    process's within rounding (the sums over the points add in another
    order)."""
    r0, r1 = _both(two_ranks, name)
    assert r0["losses"] == r1["losses"]
    for n, w in r0["weights"].items():
        assert torch.equal(w, r1["weights"][n]), n
    tol = TOL.get(name, 1e-5)
    one = run_steps(CASES[name], Mesh())
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=tol)
    floors = rounding_floors(name, one)
    for k, (g, ref) in enumerate(zip(r0["grads"], one["grads"])):
        assert_groups_close(g, ref, tol, f"{name}: step {k}'s gradient", floors.get(f"grads{k}"))
    for q in ("weights", "ema"):
        assert_groups_close(r0[q], one[q], tol, f"{name}: {q}", floors.get(q))


def _expected_collectives(impl: str) -> list:
    """A step's collectives on each of two seq ranks (2 layers, batch 4, 32
    points a rank, C 64): the pools' gathers and their adjoints, the
    point-side statistics' all-reduces and theirs, and the world's gradient
    all-reduce; nothing for the h-side's norms on the inducer tokens."""
    layers, b, n, c = DIMS["n_layers"], BATCH, N_POINTS // 2, DIMS["feature_dim"]
    gathers = [("all_gather_into_tensor", "seq", (b, n, c))] * layers
    scatters = [("reduce_scatter_tensor", "seq", (2 * b, n, c))] * layers
    # the embedding's moments of the points (no gradient reaches them)
    embed = [("all_reduce", "seq", (b, 4, 3))]
    if impl == "folded_pallas":
        # each layer's unpool and MLP sums, and their adjoints
        reduced = embed + [("all_reduce", "seq", (b, 2, c))] * 4 * layers
    else:
        # each layer's two point-side norms and the output norm (the
        # embedding's moments go unused off the statistics chain)
        norms = [("all_reduce", "seq", (2, b, c))] * (2 * layers + 1)
        reduced = embed + 2 * norms
    return sorted(gathers + scatters + reduced + [("all_reduce", "world", (-1,))])


@pytest.mark.parametrize("impl", ["folded_pallas", "xla"])
def test_point_sides_statistics_are_reduced_and_the_h_sides_are_not(two_ranks, impl):
    """Each rank's collectives in a step, by kind, group and shape: a
    reduced h-side norm (its sums [2, B, C] over the inducers), a missing
    gather or a statistic left shard-local shows here, where the losses
    and gradients would not always tell."""
    for rec in _both(two_ranks, impl):
        seen = sorted((k, g, (-1,) if g == "world" else s) for k, g, s in rec["collectives"])
        assert seen == _expected_collectives(impl)


def test_seq_trainer_writes_one_checkpoint_set_resumes_and_validates_as_one_process(
        two_ranks, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "make_writer", JsonlWriter)
    out = two_ranks / "trainer"
    assert sorted(os.listdir(out / "whole")) == [
        "best-checkpoints", f"checkpoint-step-{TRAINER_STEPS - 1}",
        f"final-checkpoint-{TRAINER_STEPS - 1}", "tensorboard"]
    r0, r1 = _both(two_ranks, "trainer")
    for n, w in r0["whole"].items():
        assert torch.equal(w, r1["whole"][n]), n
        # the resumed run takes the uninterrupted one's steps
        assert torch.equal(r0["resumed"][n], w), n
    one = trainer_runs(tmp_path)
    assert_groups_close(r0["whole"], one["whole"], 1e-5, "the Trainer's weights")
    saved = torch.load(out / "whole" / f"final-checkpoint-{TRAINER_STEPS - 1}" / "model.pt")
    for n, w in r0["whole"].items():
        assert torch.equal(saved[n], w), n

    def val(root):
        lines = [json.loads(l) for l in (root / "whole" / "tensorboard" / "scalars.jsonl")
                 .read_text().splitlines()]
        return {(r["tag"], r["step"]): r["value"] for r in lines if r["tag"].startswith("val")}

    seq, ref = val(out), val(tmp_path)
    assert seq and seq.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(seq[k], ref[k], rtol=1e-5, err_msg=str(k))


# ------------------------------------------------------------- four ranks --


def test_four_ranks_on_data_2_seq_2_take_the_jax_train_step(tmp_path):
    """One step of ``data 2 x seq 2`` (each rank 2 rows of 32 points)
    against the JAX package's ``make_train_step`` on one device, on the
    same weights and draws: the loss and the weights at the JAX mesh test's
    tolerances, after a step whose update has a norm of 1."""
    import jax
    import jax.numpy as jnp
    import optax

    from gecco_tpu.train.trainer import make_train_step as jmake_train_step
    from gecco_tpu_torch.convert import to_jax_params
    from torch_parity import jax_draws, jax_model, jax_params, torch_model

    jm = jax_model("folded_pallas", **DIMS)
    init = torch_model(jm, "folded_pallas", **DIMS)
    torch.save(init.state_dict(), tmp_path / "init.pt")
    points = make_clouds(np.random.default_rng(0), BATCH, N_POINTS)
    key = jax.random.PRNGKey(21)
    sigma, noise = jax_draws(jm, points, key)
    np.savez(tmp_path / "draws.npz", points=points, sigma=sigma, noise=noise)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(JAX_LR))
    jstep = jax.jit(jmake_train_step(jopt, ema_alpha=0.9, donate=False))
    jloss, jm, _, _ = jstep(jm, jax.tree.map(jnp.copy, jm), jopt.init(jm), jnp.asarray(points),
                            None, key)
    after = jax_params(jm)

    _spawn("four", 4, tmp_path)
    recs = [torch.load(tmp_path / f"four_{r}.pt") for r in range(4)]
    assert [(r["rows"], r["points"]) for r in recs] == [(2, 32)] * 4
    for r in recs[1:]:
        assert r["loss"] == recs[0]["loss"]
        for n, w in r["state"].items():
            assert torch.equal(w, recs[0]["state"][n]), n
    np.testing.assert_allclose(recs[0]["loss"], float(jloss), rtol=1e-3)
    init.load_state_dict(recs[0]["state"])
    ours = to_jax_params(init)
    for name in after:
        np.testing.assert_allclose(ours[name], after[name], rtol=1e-3, atol=1e-5, err_msg=name)


if __name__ == "__main__":
    _child(*sys.argv[1:])
