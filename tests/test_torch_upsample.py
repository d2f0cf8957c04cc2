"""The stochastic transition core and ``Diffusion.upsample`` against the
JAX package, on the CPU.

The JAX upsampler draws its normals from key splits inside its loops; here
they are rebuilt from the same splits and fed to the port through its one
seam, ``Diffusion.upsample_from``'s ``normal``, in the JAX loop's order, as
``test_torch_train.py`` rebuilds the loss's draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.diffusion import Schedule as JSchedule
from gecco_tpu.diffusion.samplers import churn_gamma as jchurn_gamma
from gecco_tpu.diffusion.samplers import heun_step as jheun_step
from gecco_tpu_torch import Diffusion
from gecco_tpu_torch.diffusion.samplers import churn_gamma, heun_step
from gecco_tpu_torch.diffusion.schedule import Schedule
from torch_parity import f32, j, jax_model, rel_err, t, torch_model

S_DATA = 0.8  # the analytic data distribution's std (tests/test_samplers.py)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _optimal_denoiser(sigma, x):
    """D(x; sigma) = x s^2 / (s^2 + sigma^2), the optimal denoiser of
    N(0, s^2) data (JAX arrays or tensors)."""
    return x * S_DATA**2 / (S_DATA**2 + sigma**2)


def test_extended_grid_churn_and_heun_step_match_jax():
    """The extended grid [t_0 .. t_N], the churn rate (and its clamp at
    sqrt(2) - 1), and ``heun_step`` with churn (fed the JAX normal draw),
    without it, and Euler-only, against the JAX package at fp32 rounding
    (rtol 1e-5, atol 1e-6)."""
    js = JSchedule(sigma_max=20.0, sigma_min=0.002, n_solver_steps=8)
    ts = Schedule(sigma_max=20.0, sigma_min=0.002, n_solver_steps=8)
    np.testing.assert_allclose(f32(ts.extended_solver_grid()), f32(js.extended_solver_grid()),
                               rtol=1e-6)
    assert ts.extended_solver_grid().shape == (9,)
    assert churn_gamma(0.5, 8) == jchurn_gamma(0.5, 8)
    assert churn_gamma(10.0, 8) == jchurn_gamma(10.0, 8) == math.sqrt(2.0) - 1.0

    x = 5.0 * np.random.default_rng(0).standard_normal((2, 16, 3)).astype(np.float32)
    grid = f32(js.extended_solver_grid())
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    for gamma, second_order in ((0.3, True), (0.3, False), (0.0, True), (0.0, False)):
        ref = jheun_step(_optimal_denoiser, j(x), j(grid[2]), j(grid[3]), gamma=gamma,
                         s_noise=0.9, key=key if gamma > 0 else None, second_order=second_order)
        ours = heun_step(_optimal_denoiser, t(x), t(grid[2]), t(grid[3]), gamma, 0.9,
                         t(noise) if gamma > 0 else None, second_order)
        np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5, atol=1e-6,
                                   err_msg=f"gamma={gamma} second_order={second_order}")
    with pytest.raises(ValueError):
        heun_step(_optimal_denoiser, t(x), t(grid[2]), t(grid[3]), 0.3)


def _jax_upsample_draws(jmodel, key, data, n_new, n_substeps, s_churn) -> list:
    """The normals that ``gecco_tpu.Diffusion.upsample`` draws from ``key``,
    in its order: the initial state, then per transition the cache
    refresh's noise and per substep the churn's and the re-noising's."""
    sigmas = jmodel.schedule.extended_solver_grid()
    n_transitions = sigmas.shape[0] - 1
    gamma = jchurn_gamma(s_churn, n_transitions)
    b, m, d = data.shape
    state = (b, -(-n_new // 128) * 128, d)
    _, latent_key, rng = jax.random.split(key, 3)
    draws = [jax.random.normal(latent_key, state)]
    for step in range(n_transitions):
        rng, ctx_key = jax.random.split(rng)
        draws.append(jax.random.normal(ctx_key, (b, m, d)))
        for q in range(n_substeps):
            rng, churn_key, redo_key = jax.random.split(rng, 3)
            if gamma > 0.0:
                draws.append(jax.random.normal(churn_key, state))
            if q < n_substeps - 1 and step < n_transitions - 1:
                draws.append(jax.random.normal(redo_key, state))
    return [np.asarray(a) for a in draws]


@pytest.mark.parametrize("attn_impl", ["xla", "folded_pallas"])
def test_upsample_matches_jax(attn_impl):
    """The small flagship-structured model (fp32) upsamples two 128-point
    clouds to an unaligned 200 points (256 generated) over the 4-step
    extended grid, 2 substeps, churn 0.5, fed the JAX draws: the final
    cloud against JAX ``upsample`` (its Pallas kernels in interpret mode on
    ``folded_pallas``), within 1e-4 of the largest value: fp32 rounding
    only, carried through 4 cache refreshes and 14 cached evaluations
    (measured 1.8e-5 on both paths)."""
    jm = jax_model(attn_impl, n_steps=4)
    tm = torch_model(jm, attn_impl, n_steps=4)
    data = (0.3 * np.random.default_rng(2).standard_normal((2, 128, 3))).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = jm.upsample(key, j(data), 200, n_substeps=2, s_churn=0.5)
    draws = iter(_jax_upsample_draws(jm, key, data, 200, 2, 0.5))

    def normal(shape):
        a = next(draws)
        assert a.shape == shape
        return t(a)

    ours = tm.upsample_from(t(data), 200, normal, n_substeps=2, s_churn=0.5)
    assert next(draws, None) is None
    assert ours.shape == (2, 200, 3)
    assert rel_err(ours, ref) < 1e-4


class _AnalyticNet(torch.nn.Module):
    """The network whose preconditioned output makes ``denoise`` the
    optimal denoiser of N(0, S_DATA^2) data (tests/test_samplers.py's
    ``AnalyticNet``); it takes t = c_noise = sigma and hands back a dummy
    inducer cache."""

    def forward(self, t_, x, ctx=None, hs=None, return_h=False):
        sigma = t_[:, None, None]
        c_skip = 1.0 / (sigma**2 + 1.0)
        c_out = sigma / torch.sqrt(1.0 + sigma**2)
        x_orig = x * torch.sqrt(sigma**2 + 1.0)
        f = (x_orig * S_DATA**2 / (S_DATA**2 + sigma**2) - c_skip * x_orig) / c_out
        return (f, torch.zeros(1, x.shape[0], 1, 1)) if return_h else f


def test_upsample_statistics():
    """For N(0, s^2) data the upsampled points are N(0, s^2) too (the JAX
    package's test_upsample_statistics, rtol 0.2 on the std)."""
    model = Diffusion(_AnalyticNet(), Schedule(sigma_max=20.0, sigma_min=0.002, n_solver_steps=32))
    gen = torch.Generator().manual_seed(12)
    data = S_DATA * torch.randn((2, 64, 3), generator=gen)
    out = model.upsample(gen, data, 48, n_substeps=2)
    assert out.shape == (2, 48, 3) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(float(out.std()), S_DATA, rtol=0.2)
