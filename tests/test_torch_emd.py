"""The port's earth mover's distances (``gecco_tpu_torch.metrics``:
``scipy_emd``, ``auction_lsa``/``auction_emd``, ``sinkhorn_emd``) against
the JAX package's on the CPU, at 64-128 points on a few pairs: the
auction's columns against the JAX auction's on the same costs, its totals
against scipy's Hungarian to 1e-5 relative (as ``tests/test_metrics.py``
holds the JAX auction), the EMDs against the JAX ones in both match modes,
Sinkhorn at rtol 1e-5. The JAX side of a case runs as one ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from gecco_tpu import metrics as jmetrics
from gecco_tpu_torch import metrics


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _clouds(seed, pairs, n):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(pairs, n, 3)).astype(np.float32)
    b = (0.7 * rng.normal(size=(pairs, n, 3)) + 0.2).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n", [1, 3, 32, 128])
def test_auction_lsa_gives_the_jax_columns_and_the_hungarian_total(n):
    rng = np.random.default_rng(7 + n)
    cost = (rng.normal(size=(3, n, n)) * rng.uniform(0.1, 5, (3, 1, 1))).astype(np.float32)
    cols = metrics.auction_lsa(torch.from_numpy(cost)).numpy()
    jcols = np.asarray(jax.jit(jax.vmap(jmetrics.auction_lsa))(jnp.asarray(cost)))
    assert cols.shape == (3, n)
    np.testing.assert_array_equal(cols, jcols)
    for c, col in zip(cost, cols):
        assert sorted(col.tolist()) == list(range(n))
        rows, ref = linear_sum_assignment(c)
        np.testing.assert_allclose(c[np.arange(n), col].sum(), c[rows, ref].sum(), rtol=1e-5,
                                   atol=1e-6)
    # a pair of the batch gets the columns it gets alone
    np.testing.assert_array_equal(metrics.auction_lsa(torch.from_numpy(cost[1])).numpy(),
                                  cols[1])


def test_auction_cap_completes_greedily_as_the_jax_one():
    """One iteration a phase leaves rows unassigned: they take the free
    columns in order, so the result is still a permutation."""
    cost = np.random.default_rng(1).normal(size=(2, 48, 48)).astype(np.float32)
    kw = dict(n_phases=2, max_iters_per_phase=1)
    cols = metrics.auction_lsa(torch.from_numpy(cost), **kw).numpy()
    jcols = np.asarray(jax.jit(jax.vmap(lambda c: jmetrics.auction_lsa(c, **kw)))(cost))
    np.testing.assert_array_equal(cols, jcols)
    for col in cols:
        assert sorted(col.tolist()) == list(range(48))


@pytest.mark.parametrize("match,average", [("l1", "l1"), ("l2", "l2"), ("l2", "l1")])
def test_exact_emds_match_the_jax_ones(match, average):
    a, b = _clouds(3, 3, 96)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    auction = metrics.auction_emd(ta, tb, match=match, average=average).numpy()
    scipy = metrics.scipy_emd(ta, tb, match=match, average=average).numpy()
    jauction = np.asarray(jax.jit(jax.vmap(
        lambda x, y: jmetrics.auction_emd(x, y, match=match, average=average)))(a, b))
    jscipy = np.array([float(jmetrics.scipy_emd(jnp.asarray(x), jnp.asarray(y), match=match,
                                                average=average)) for x, y in zip(a, b)])
    assert auction.shape == scipy.shape == (3,)
    np.testing.assert_allclose(auction, jauction, rtol=1e-5)
    np.testing.assert_allclose(scipy, jscipy, rtol=1e-5)
    np.testing.assert_allclose(auction, scipy, rtol=1e-5)


def test_emds_broadcast_over_leading_axes_and_pass_gradients():
    a, b = _clouds(4, 4, 64)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b)
    grid = metrics.auction_emd(ta[:, None], tb[None])  # [4, 4], as the benchmark calls it
    assert grid.shape == (4, 4)
    np.testing.assert_allclose(grid.diagonal().detach().numpy(),
                               metrics.auction_emd(ta, tb).detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(grid.detach().numpy(),
                               metrics.scipy_emd(ta[:, None], tb[None]).detach().numpy(),
                               rtol=1e-5)
    # the gradient through the matched distances, the assignment held fixed
    metrics.auction_emd(ta, tb).sum().backward()
    ref = jax.jit(jax.grad(lambda x: jax.vmap(jmetrics.auction_emd)(x, jnp.asarray(b)).sum()))(a)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("epsilon,n_iters", [(0.01, 100), (0.1, 30)])
def test_sinkhorn_emd_matches_the_jax_one(epsilon, n_iters):
    a, b = _clouds(5, 3, 80)
    got = metrics.sinkhorn_emd(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None],
                               epsilon=epsilon, n_iters=n_iters).numpy()
    ref = np.asarray(jax.jit(lambda x, y: jmetrics.sinkhorn_emd(
        x[:, None], y[None], epsilon=epsilon, n_iters=n_iters))(a, b))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
