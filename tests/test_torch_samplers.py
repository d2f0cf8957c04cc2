"""The stochastic and inpainting samplers, ``score`` and ``temperature``
against the JAX package, on the CPU.

The JAX samplers draw their normals from key splits inside their loops;
here the draws are rebuilt from the same splits and fed to the port through
its one seam, ``normal(shape)``, in the order the JAX loop uses its keys,
as ``test_torch_upsample.py`` does for the upsampler.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.diffusion import Schedule as JSchedule
from gecco_tpu.diffusion.samplers import churn_gamma as jchurn_gamma
from gecco_tpu.diffusion.samplers import heun_sampler as jheun_sampler
from gecco_tpu.diffusion.samplers import inpaint_sampler as jinpaint_sampler
from gecco_tpu_torch import Diffusion
from gecco_tpu_torch.diffusion.samplers import heun_sampler, inpaint_sampler
from gecco_tpu_torch.diffusion.schedule import Schedule
from test_torch_upsample import S_DATA, _AnalyticNet, _optimal_denoiser
from torch_parity import f32, j, jax_model, rel_err, t, torch_model

N_STEPS = 4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _feeder(draws):
    """The port's ``normal`` seam, handing out ``draws`` in order and
    checking each one's shape."""
    it = iter(draws)

    def normal(shape):
        a = next(it)
        assert a.shape == tuple(shape), (a.shape, shape)
        return t(a)

    normal.rest = it
    return normal


def _heun_draws(key, n_transitions, gamma, shape) -> list:
    """The churn normals ``gecco_tpu``'s ``heun_sampler`` draws from
    ``key``: one split per transition where the churn rate is positive."""
    draws, rng = [], key
    for _ in range(n_transitions):
        if gamma > 0.0:
            rng, churn_key = jax.random.split(rng)
            draws.append(np.asarray(jax.random.normal(churn_key, shape, jnp.float32)))
    return draws


def _inpaint_draws(key, sigmas, known_shape, m_to_inpaint, gamma, n_substeps) -> list:
    """The normals ``gecco_tpu``'s ``inpaint_sampler`` draws from ``key``,
    in its order of use: the initial state; then per substep the known
    points' re-noising, the churn's and the re-noising's."""
    b, m, d = known_shape
    state = (b, m_to_inpaint + m, d)
    init_key, rng = jax.random.split(key)
    draws = [jax.random.normal(init_key, state)]
    for _ in range(sigmas.shape[0] - 1):
        for q in range(n_substeps):
            rng, churn_key, known_key, redo_key = jax.random.split(rng, 4)
            draws.append(jax.random.normal(known_key, known_shape))
            if gamma > 0.0:
                draws.append(jax.random.normal(churn_key, state, jnp.float32))
            if q < n_substeps - 1:
                draws.append(jax.random.normal(redo_key, state))
    return [np.asarray(a) for a in draws]


@pytest.mark.parametrize("s_churn, heun_on_last", [(0.5, False), (0.5, True), (0.0, False)])
def test_heun_sampler_matches_jax(s_churn, heun_on_last):
    """``heun_sampler`` over the 8-step extended grid, churned (and
    without churn), the last transition Euler only or Heun, on the optimal
    denoiser, fed the JAX churn draws, with the trajectory: fp32 rounding
    only (rtol 1e-5, atol 1e-6)."""
    js = JSchedule(sigma_max=20.0, sigma_min=0.002, n_solver_steps=8)
    sigmas = f32(js.extended_solver_grid())
    x0 = 20.0 * np.random.default_rng(0).standard_normal((2, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref, ref_traj = jheun_sampler(_optimal_denoiser, j(sigmas), j(x0), key, s_churn=s_churn,
                                  s_noise=0.9, heun_on_last=heun_on_last, save_trajectory=True)
    gamma = jchurn_gamma(s_churn, len(sigmas) - 1)
    normal = _feeder(_heun_draws(key, len(sigmas) - 1, gamma, x0.shape))
    ours, traj = heun_sampler(_optimal_denoiser, t(sigmas), t(x0), normal, s_churn, 0.9,
                              heun_on_last, save_trajectory=True)
    assert next(normal.rest, None) is None
    np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f32(traj), f32(ref_traj), rtol=1e-5, atol=1e-6)
    if s_churn > 0:
        with pytest.raises(ValueError):
            heun_sampler(_optimal_denoiser, t(sigmas), t(x0), s_churn=s_churn)


@pytest.mark.parametrize("s_churn, n_substeps", [(0.5, 2), (0.0, 3)])
def test_inpaint_sampler_matches_jax(s_churn, n_substeps):
    """``inpaint_sampler`` over the 6-step extended grid (the re-noising on
    the last level too, as in the JAX package), on the optimal denoiser,
    fed the JAX draws in their order of use: rtol 1e-5, atol 1e-6."""
    js = JSchedule(sigma_max=20.0, sigma_min=0.002, n_solver_steps=6)
    sigmas = f32(js.extended_solver_grid())
    known = (S_DATA * np.random.default_rng(1).standard_normal((2, 12, 3))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jinpaint_sampler(_optimal_denoiser, j(sigmas), j(known), 8, key, s_churn=s_churn,
                           s_noise=0.9, n_substeps=n_substeps)
    gamma = jchurn_gamma(s_churn, len(sigmas) - 1)
    normal = _feeder(_inpaint_draws(key, sigmas, known.shape, 8, gamma, n_substeps))
    ours = inpaint_sampler(_optimal_denoiser, t(sigmas), t(known), 8, normal, s_churn, 0.9,
                           n_substeps)
    assert next(normal.rest, None) is None
    assert ours.shape == (2, 8, 3)
    np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5, atol=1e-6)


def test_stochastic_and_inpaint_statistics():
    """For N(0, s^2) data the stochastic sampler's clouds have std s within
    5% and the inpainted points within 20% (the JAX package's
    test_sde_sampler_matches_data_std and test_inpaint_prefers_known_
    distribution), each drawing from a ``torch.Generator``."""
    model = Diffusion(_AnalyticNet(), Schedule(sigma_max=20.0, sigma_min=0.002,
                                               n_solver_steps=32))
    gen = torch.Generator().manual_seed(2)
    out = model.sample_stochastic(gen, (16, 128, 3), s_churn=0.5)
    assert out.shape == (16, 128, 3) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(float(out.std()), S_DATA, rtol=0.05)
    known = S_DATA * torch.randn((2, 64, 3), generator=gen)
    filled = model.sample_inpaint(gen, known, 32, s_churn=0.5, n_substeps=2)
    assert filled.shape == (2, 32, 3)
    np.testing.assert_allclose(float(filled.std()), S_DATA, rtol=0.2)


@functools.lru_cache(maxsize=None)
def _models(dtype: str):
    jm = jax_model(dtype=getattr(jnp, dtype), n_steps=N_STEPS)
    return jm, torch_model(jm, dtype=getattr(torch, dtype), n_steps=N_STEPS)


# fp32: both sides compute the same function, fp32 rounding only; bf16
# activations: the two frameworks round and sum in other orders, a few bf16
# steps (2^-8) of the largest value (test_torch_sample.py's limits)
DTYPES = pytest.mark.parametrize("dtype, tol", [("float32", 1e-4), ("bfloat16", 1e-2)],
                                 ids=["fp32", "bf16"])


@DTYPES
def test_sample_stochastic_matches_jax(dtype, tol):
    """The 2-layer ``folded_pallas`` flagship's ``sample_stochastic``
    (churn 0.5, the 4-step extended grid: 7 evaluations, the last
    transition Euler only) against the JAX package's (its Pallas kernels in
    interpret mode), fed its draws: the initial state, then one churn draw
    per transition."""
    jm, tm = _models(dtype)
    shape, key = (2, 128, 3), jax.random.PRNGKey(7)
    ref = jax.jit(lambda m, k: m.sample_stochastic(k, shape, s_churn=0.5))(jm, key)
    _, init_key, loop_key = jax.random.split(key, 3)
    sigmas = jm.schedule.extended_solver_grid()
    draws = [np.asarray(jax.random.normal(init_key, shape))]
    draws += _heun_draws(loop_key, N_STEPS, jchurn_gamma(0.5, N_STEPS), shape)
    normal = _feeder(draws)
    ours = tm.sample_stochastic_from(normal, shape, s_churn=0.5)
    assert next(normal.rest, None) is None and sigmas.shape == (N_STEPS + 1,)
    assert ours.shape == shape
    assert rel_err(ours, ref) < tol


@DTYPES
def test_sample_inpaint_matches_jax(dtype, tol):
    """The same model completes two 128-point clouds by 128 points (N 256
    in the network), 2 substeps, churn 0.5, over the 4-step extended grid,
    against the JAX package's ``sample_inpaint`` fed its draws."""
    jm, tm = _models(dtype)
    known = (0.3 * np.random.default_rng(4).standard_normal((2, 128, 3))).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jax.jit(lambda m, k, kn: m.sample_inpaint(k, kn, 128, s_churn=0.5, n_substeps=2))(
        jm, key, j(known))
    _, loop_key = jax.random.split(key)
    known_diff = f32(jm.reparam.data_to_diffusion(j(known), None))
    draws = _inpaint_draws(loop_key, jm.schedule.extended_solver_grid(), known_diff.shape, 128,
                           jchurn_gamma(0.5, N_STEPS), 2)
    normal = _feeder(draws)
    ours = tm.sample_inpaint_from(t(known), 128, normal, s_churn=0.5, n_substeps=2)
    assert next(normal.rest, None) is None
    assert ours.shape == (2, 128, 3)
    assert rel_err(ours, ref) < tol


@DTYPES
def test_score_and_temperature_match_jax(dtype, tol, monkeypatch):
    """``score`` at three noise levels, and ``sample(..., temperature=0.8)``
    whose latent is the JAX draw (the port's one latent seam,
    ``Schedule.sample_latent``, handed the JAX package's), scaled by the
    temperature inside ``sample``, against the JAX package's."""
    jm, tm = _models(dtype)
    rng = np.random.default_rng(5)
    x = (3.0 * rng.standard_normal((2, 128, 3))).astype(np.float32)
    score = jax.jit(lambda m, s_, x_: m.score(s_, x_))
    for sigma in (0.05, 2.0, 80.0):
        ref = score(jm, jnp.float32(sigma), j(x))
        with torch.no_grad():
            ours = tm.score(sigma, t(x))
        assert rel_err(ours, ref) < tol, sigma

    shape, key = (2, 128, 3), jax.random.PRNGKey(13)
    ref = jax.jit(lambda m, k: m.sample(k, shape, temperature=0.8))(jm, key)
    _, latent_key, _ = jax.random.split(key, 3)
    latent = jm.schedule.sample_latent(latent_key, shape)
    monkeypatch.setattr(type(tm.schedule), "sample_latent",
                        lambda self, generator, shape_, device=None: t(latent))
    ours = tm.sample(torch.Generator(), shape, temperature=0.8)
    assert rel_err(ours, ref) < tol
