"""The whole slice on the CPU: the port samples the same clouds as the JAX
package's ``Diffusion.sample`` from the same latent and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32, jax_model, rel_err, t, torch_model

SHAPE = (2, 128, 3)
N_STEPS = 4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize(
    "attn_impl,jdtype,tdtype,tol",
    [
        # fp32: both sides compute the same function; 6 evaluations through
        # 2 layers from sigma 165 leave differences of fp32 rounding only
        # (measured 1.2e-5 of the largest value)
        ("folded_pallas", jnp.float32, torch.float32, 1e-4),
        ("xla", jnp.float32, torch.float32, 1e-4),
        # bf16 activations: the two frameworks round and sum in other
        # orders; a few bf16 steps (2^-8 = 3.9e-3) of the largest value
        # (measured 2.0e-3)
        ("folded_pallas", jnp.bfloat16, torch.bfloat16, 1e-2),
    ],
    ids=["fused-fp32", "plain-fp32", "fused-bf16"],
)
def test_sample_matches_jax(attn_impl, jdtype, tdtype, tol):
    jm = jax_model(attn_impl, dtype=jdtype, n_steps=N_STEPS)
    details = jm.sample(jax.random.PRNGKey(7), SHAPE, return_details=True)
    tm = torch_model(jm, attn_impl, dtype=tdtype, n_steps=N_STEPS)
    ours = tm.sample_from_latent(t(details.latent), return_details=True)
    assert ours.trajectory_diff.shape == (N_STEPS - 1, *SHAPE)
    assert rel_err(ours.sample_data, details.sample_data) < tol
    assert rel_err(ours.trajectory_data, details.trajectory_data) < tol
    np.testing.assert_array_equal(f32(ours.latent), f32(details.latent))


def test_sample_draws_its_latent_from_the_generator():
    tm = torch_model(jax_model(n_steps=N_STEPS), n_steps=N_STEPS)
    a = tm.sample(torch.Generator().manual_seed(3), SHAPE)
    b = tm.sample(torch.Generator().manual_seed(3), SHAPE)
    assert a.shape == SHAPE and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    latent = tm.schedule.sample_latent(torch.Generator().manual_seed(3), SHAPE)
    torch.testing.assert_close(tm.sample_from_latent(latent), a, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tm.sample(torch.Generator(), (2, 128))
