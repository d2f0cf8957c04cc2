"""The port's training slice against the JAX package's, on the CPU.

The JAX loss draws sigma and the noise from its key; the tests rebuild the
same draws from the same key split (``Diffusion.loss``: sigma from the first
of four keys, the noise from the second) and hand them to the port's
``loss_from``, so both sides compute the loss of the same numbers. Weights
move from the JAX model to the port with ``gecco_tpu_torch.convert``, and
gradients, parameters and EMA come back with ``to_jax_params``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gecco_tpu.diffusion.schedule import LogNormalSchedule as JLogNormalSchedule
from gecco_tpu.train.trainer import make_train_step as jmake_train_step
from gecco_tpu_torch import LogNormalSchedule, LogUniformSchedule
from gecco_tpu_torch.convert import load_jax_params, to_jax_params
from gecco_tpu_torch.data import make_clouds
from gecco_tpu_torch.diffusion import low_discrepancy_uniform
from gecco_tpu_torch.ops import kernels
from gecco_tpu_torch.train import (
    adabelief,
    chain,
    clip_by_global_norm,
    flagship_optimizer,
    make_ema,
    make_train_step,
    warmup_cosine_decay_schedule,
)
from torch_parity import f32, jax_model, jax_params, t, torch_model
from torch_parity import jax_draws as _jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 256, 3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _points(seed=0):
    return (0.35 * np.random.default_rng(seed).standard_normal(SHAPE)).astype(np.float32)


def _rel(a, ref) -> float:
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


# --------------------------------------------------------------- schedule --


def test_low_discrepancy_uniform_draws_one_sample_per_stratum():
    g = torch.Generator().manual_seed(0)
    u = low_discrepancy_uniform(g, 16, minval=-2.0, maxval=6.0)
    strata = torch.floor((u + 2.0) / 8.0 * 16).long()
    assert torch.equal(strata, torch.arange(16))


def test_sigma_draws_and_loss_weight():
    g = torch.Generator().manual_seed(1)
    sched = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002)
    sigma = sched.sample_sigma(g, 64)
    assert sigma.shape == (64,) and bool((sigma >= 0.002).all() and (sigma <= 165.0).all())
    # log-uniform: one draw per stratum of log sigma
    strata = torch.floor((sigma.log() - np.log(0.002)) / np.log(165.0 / 0.002) * 64).long()
    assert torch.equal(strata, torch.arange(64))
    lognormal = LogNormalSchedule(sigma_log_mean=0.5, sigma_log_std=1.0)
    draws = lognormal.sample_sigma(g, 4096).log()
    assert abs(float(draws.mean()) - 0.5) < 0.1 and abs(float(draws.std()) - 1.0) < 0.1
    jl = JLogNormalSchedule()
    s = np.array([0.002, 0.3, 1.0, 80.0], np.float32)
    np.testing.assert_allclose(lognormal.loss_weight(t(s)).numpy(), np.asarray(jl.loss_weight(s)),
                               rtol=1e-6)


def test_make_clouds_matches_the_validation_script():
    spec = importlib.util.spec_from_file_location(
        "validate_flagship", os.path.join(REPO, "scripts", "validate_flagship.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for seed in (0, 3):
        ours = make_clouds(np.random.default_rng(seed), 6, 128)
        ref = script.make_clouds(np.random.default_rng(seed), 6, 128)
        np.testing.assert_array_equal(ours, ref)


# ------------------------------------------------------------------- loss --


@pytest.mark.parametrize(
    "attn_impl,jdtype,tdtype,loss_tol,grad_tol",
    [
        # fp32: the same function on both sides; differences of fp32
        # rounding (measured 3.6e-6 of each gradient's largest value)
        ("folded_pallas", jnp.float32, torch.float32, 1e-5, 1e-4),
        ("xla", jnp.float32, torch.float32, 1e-5, 1e-4),
        # bf16 activations through 2 layers: both frameworks round and sum
        # in other orders, forward and backward (measured 1.4e-2 on the
        # worst parameter, 1e-5 on the loss)
        ("folded_pallas", jnp.bfloat16, torch.bfloat16, 1e-3, 5e-2),
    ],
    ids=["fused-fp32", "plain-fp32", "fused-bf16"],
)
def test_loss_and_gradients_match_jax(attn_impl, jdtype, tdtype, loss_tol, grad_tol):
    jm = jax_model(attn_impl, dtype=jdtype)
    tm = torch_model(jm, attn_impl, dtype=tdtype)
    points = _points()
    key = jax.random.PRNGKey(3)
    jloss, jgrads = jax.value_and_grad(lambda m: m.loss(jnp.asarray(points), None, key))(jm)
    sigma, noise = _jax_draws(jm, points, key)
    loss = tm.loss_from(t(points), t(sigma), t(noise))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= loss_tol * abs(float(jloss))
    ref, ours = jax_params(jgrads), to_jax_params(tm, grads=True)
    assert set(ours) == set(ref)
    for name, g in ref.items():
        if np.abs(g).max() > 0:
            assert _rel(ours[name], g) < grad_tol, name
        else:  # the reparam's statistics take no gradient
            assert not np.abs(ours[name]).any(), name


def test_loss_draws_from_the_generator():
    tm = torch_model(jax_model("xla"), "xla")
    pts = t(_points(1))
    a = tm.loss(pts, torch.Generator().manual_seed(5))
    b = tm.loss(pts, torch.Generator().manual_seed(5))
    sigma, noise = tm.draw_sigma_noise(torch.Generator().manual_seed(5), pts)
    assert sigma.shape == (2,) and noise.shape == SHAPE
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(tm.loss_from(pts, sigma, noise), a, rtol=0, atol=0)


def test_sampling_records_no_graph_but_denoise_does():
    tm = torch_model(jax_model())
    latent = 165.0 * torch.randn(2, 128, 3, generator=torch.Generator().manual_seed(0))
    out = tm.sample_from_latent(latent, n_solver_steps=3)
    assert out.grad_fn is None and not out.requires_grad
    assert tm.denoise(torch.tensor([1.0, 2.0]), latent).grad_fn is not None


# -------------------------------------------------------------- optimizer --


def test_warmup_cosine_schedule_matches_optax():
    ours = warmup_cosine_decay_schedule(0.0, 3e-4, 2000, 1_000_000, end_value=6e-6)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 2000, 1_000_000, end_value=6e-6)
    for count in (0, 1, 2000, 500_000, 1_000_000):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)
    assert ours(0) == 0.0


@pytest.mark.parametrize("max_norm", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_clip_adabelief_warmup_cosine_match_optax(max_norm):
    """Five steps of clip + AdaBelief + warmup-cosine on a random parameter
    tree, against optax at fp32 tolerance."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (7,), (2, 3, 5), ()]
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    sched = (0.0, 1e-2, 2, 20, 1e-4)
    ref_opt = optax.chain(optax.clip_by_global_norm(max_norm),
                          optax.adabelief(optax.warmup_cosine_decay_schedule(*sched)))
    opt = chain(clip_by_global_norm(max_norm), adabelief(warmup_cosine_decay_schedule(*sched)))
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = ref_opt.init(jparams), opt.init(tparams)
    for step in range(5):
        grads = [np.asarray(3.0 * rng.standard_normal(s), np.float32) for s in shapes]
        jup, jstate = ref_opt.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup, tstate = opt.update([torch.from_numpy(g) for g in grads], tstate)
        for p, u in zip(tparams, tup):
            p.add_(u)
        for a, r in zip(tup, jup):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-9)
        if step == 0:  # the learning rate starts at 0: the first update is zero
            assert all(not u.any() for u in tup)
    for a, r in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)
    belief = tstate[1][0]
    for a, r in zip(belief.mu, jstate[1][0].mu):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)
    for a, r in zip(belief.nu, jstate[1][0].nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------- train step --


def test_train_step_matches_jax():
    """Three steps of the port's train step against ``make_train_step`` from
    the same weights, batches and per-step sigma and noise, with a learning
    rate large enough that every parameter moves: loss, parameters and EMA
    agree at fp32 tolerance."""
    jm = jax_model("folded_pallas")
    tm = torch_model(jm, "folded_pallas")
    sched = (1e-3, 3e-3, 2, 100, 1e-4)
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adabelief(optax.warmup_cosine_decay_schedule(*sched)))
    opt = chain(clip_by_global_norm(1.0), adabelief(warmup_cosine_decay_schedule(*sched)))
    jstep = jmake_train_step(jopt, ema_alpha=0.9, donate=False)
    step = make_train_step(opt, ema_alpha=0.9)
    jema, jstate = jax.tree.map(jnp.copy, jm), jopt.init(jm)
    ema, state = make_ema(tm), opt.init(list(tm.parameters()))
    start = jax_params(jm)
    for k in range(3):
        points = _points(10 + k)
        key = jax.random.PRNGKey(20 + k)
        sigma, noise = _jax_draws(jm, points, key)
        jloss, jm, jema, jstate = jstep(jm, jema, jstate, jnp.asarray(points), None, key)
        loss, state = step(tm, ema, state, t(points), sigma=t(sigma), noise=t(noise))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref_p, ref_e = jax_params(jm), jax_params(jema)
    ours_p, ours_e = to_jax_params(tm), to_jax_params(ema)
    moved = 0
    for name in ref_p:
        np.testing.assert_allclose(ours_p[name], ref_p[name], rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(ours_e[name], ref_e[name], rtol=1e-4, atol=1e-5, err_msg=name)
        moved += not np.array_equal(ref_p[name], start[name])
    assert moved >= len(ref_p) - 2  # all but the reparam's mean and std


def test_train_step_on_cpu_launches_no_kernel_and_keeps_ema_apart():
    tm = torch_model(jax_model("folded_pallas"), "folded_pallas")
    opt = flagship_optimizer()
    ema, state = make_ema(tm), opt.init(list(tm.parameters()))
    step = make_train_step(opt)
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        loss, state = step(tm, ema, state, t(_points(2)), g)
        assert bool(torch.isfinite(loss))
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert all(p.grad is not None for p in tm.parameters())
    assert not any(p.requires_grad for p in ema.parameters())
    # the learning rate starts at 0; the step after it moves the weights
    assert state[1][1] == 2


def test_to_jax_params_inverts_load_jax_params():
    jm = jax_model("xla")
    tm = torch_model(jm, "xla")
    ref, ours = jax_params(jm), to_jax_params(tm)
    assert set(ours) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name], f32(ref[name]))
    other = torch_model(jax_model("xla", seed=1), "xla")
    load_jax_params(other, ours)
    for a, b in zip(other.state_dict().values(), tm.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
