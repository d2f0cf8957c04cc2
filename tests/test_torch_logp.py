"""The exact likelihood (``Diffusion.evaluate_logp``), the reparams'
log-det-Jacobians and the validation metrics against the JAX package, on
the CPU.

The JAX likelihood draws its Rademacher probes from a key; the tests
rebuild them from the same split and hand them to the port's
``evaluate_logp_from``. The JAX side of a case runs as one ``jax.jit``,
its Pallas kernels (the folded attention, the projective gather) in
interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from gecco_tpu import LogUniformSchedule as JLogUniformSchedule
from gecco_tpu.diffusion import Diffusion as JDiffusion
from gecco_tpu.metrics import LogpMetric as JLogpMetric
from gecco_tpu.metrics import LossMetric as JLossMetric
from gecco_tpu.metrics import SupervisedMetric as JSupervisedMetric
from gecco_tpu.types import Context3d as JContext3d
from gecco_tpu_torch import Context3d, Diffusion, GaussianReparam, LogUniformSchedule, Reparam
from gecco_tpu_torch.data import make_conditional_batch
from gecco_tpu_torch.diffusion.schedule import Schedule
from gecco_tpu_torch.metrics import LogpMetric, LossMetric, SupervisedMetric
from gecco_tpu_torch.models import set_transformer
from test_samplers import AnalyticNet as JAnalyticNet
from test_torch_upsample import S_DATA, _AnalyticNet
from torch_parity import (
    f32,
    j,
    jax_conditional_model,
    jax_model,
    rel_err,
    t,
    torch_conditional_model,
    torch_model,
)

B, N, IMAGE = 2, 128, 64
FIELDS = ("logp", "prior_logp", "delta_reparam", "delta_jacobian", "trajectory_diff",
          "trajectory_data", "latent")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _frustum_batch(seed, b=B, n=N):
    """Points in the camera frustum, images and cameras (numpy)."""
    return make_conditional_batch(np.random.default_rng(seed), b, n, IMAGE)


# ------------------------------------------------------------- reparams --


@pytest.mark.parametrize("which", ["identity", "gaussian", "uvl"])
def test_reparam_ladj_matches_jax(which):
    """``ladj_data_to_diffusion`` and ``ladj_diffusion_to_data`` of the
    three reparams against the JAX package's (``GaussianReparam`` fitted by
    ``from_data`` on both sides; ``UVLReparam``'s per-point Jacobian by
    ``torch.func.jacrev`` against ``jax.jacrev``, each with ``slogdet``) on
    in-frustum points, at rtol 1e-5."""
    from gecco_tpu import GaussianReparam as JGaussianReparam
    from gecco_tpu import UVLReparam as JUVLReparam
    from gecco_tpu.reparam import Reparam as JReparam
    from gecco_tpu_torch import UVLReparam

    pts, _, K = _frustum_batch(3)
    jctx, tctx = JContext3d(image=None, K=j(K)), Context3d(image=None, K=t(K))
    if which == "identity":
        jr, tr = JReparam(), Reparam()
    elif which == "gaussian":
        jr, tr = JGaussianReparam.from_data(j(pts)), GaussianReparam.from_data(t(pts),
                                                                             device="cpu")
        np.testing.assert_allclose(f32(tr.std), f32(jr.std), rtol=1e-6)
    else:
        jr, tr = JUVLReparam.init(), UVLReparam(device="cpu")
    diff = f32(jr.data_to_diffusion(j(pts), jctx))
    jladj = jax.jit(lambda r, d, x, c: (r.ladj_data_to_diffusion(d, c),
                                        r.ladj_diffusion_to_data(x, c)))(jr, j(pts), j(diff), jctx)
    pairs = [(tr.ladj_data_to_diffusion(t(pts), tctx), jladj[0]),
             (tr.ladj_diffusion_to_data(t(diff), tctx), jladj[1])]
    for ours, ref in pairs:
        assert ours.shape == (B,)
        np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-5, atol=1e-6)
    if which != "identity":
        assert bool((pairs[0][0] != 0).all())


# ------------------------------------------------------ analytic Gaussian --


def test_logp_matches_analytic_gaussian():
    """For the linear (Gaussian) model the Hutchinson estimate is exact and
    the reverse ODE recovers the true log-density: within 2% of
    ``scipy.stats.norm.logpdf`` (the JAX package's
    test_logp_matches_analytic_gaussian: 128 steps, sigma_max 40)."""
    model = Diffusion(_AnalyticNet(), Schedule(sigma_max=40.0, sigma_min=0.002,
                                               n_solver_steps=128))
    gen = torch.Generator().manual_seed(5)
    x = S_DATA * torch.randn((4, 8, 3), generator=gen)
    logp = model.evaluate_logp(gen, x)
    expected = scipy.stats.norm(scale=S_DATA).logpdf(x.numpy()).sum(axis=(-2, -1))
    assert logp.shape == (4,) and logp.grad_fn is None
    np.testing.assert_allclose(f32(logp), expected, rtol=0.02)


def test_metric_keys_match_jax():
    """``LossMetric``, ``LogpMetric`` and ``SupervisedMetric`` return the
    JAX package's keys (on the analytic model), ``LogpMetric`` the
    decomposition ``evaluate_logp`` gives from the same generator seed."""
    jm = JDiffusion.init(JAnalyticNet(), JLogUniformSchedule(sigma_max=20.0, n_solver_steps=4))
    tm = Diffusion(_AnalyticNet(), LogUniformSchedule(sigma_max=20.0, n_solver_steps=4))
    x = (S_DATA * np.random.default_rng(6).standard_normal((2, 8, 3))).astype(np.float32)
    key = jax.random.PRNGKey(0)
    for jmetric, metric in ((JLossMetric(), LossMetric()),
                            (JLogpMetric(n_solver_steps=3), LogpMetric(n_solver_steps=3)),
                            (JSupervisedMetric(), SupervisedMetric())):
        ref = jmetric(jm, j(x), None, key)
        ours = metric(tm, t(x), None, torch.Generator().manual_seed(0))
        assert metric.name == jmetric.name and set(ours) == set(ref), metric.name
        assert all(bool(torch.isfinite(v).all()) for v in ours.values())
    terms = LogpMetric(n_solver_steps=3)(tm, t(x), None, torch.Generator().manual_seed(0))
    details = tm.evaluate_logp(torch.Generator().manual_seed(0), t(x), n_solver_steps=3,
                               return_details=True)
    for k, field in (("total", "logp"), ("prior", "prior_logp"), ("det-jac", "delta_jacobian"),
                     ("reparam", "delta_reparam")):
        torch.testing.assert_close(terms[k], getattr(details, field), rtol=0, atol=0)


# ----------------------------------------------------- the models, fp32 --


@functools.lru_cache(maxsize=None)
def _flagship():
    jm = jax_model(n_steps=4)
    return jm, torch_model(jm, n_steps=4)


@functools.lru_cache(maxsize=None)
def _conditional():
    jm = jax_conditional_model(n_steps=4)
    return jm, torch_conditional_model(jm, n_steps=4)


def _jax_logp(jm, key, data, jctx, steps):
    """``gecco_tpu.Diffusion.evaluate_logp``, its ``lax.scan`` body compiled
    as one program. Not under an outer ``jax.jit``: compiled whole, the
    conditional model's likelihood departs from the JAX package's own scan
    and from its unjitted run (which agree with each other and with the
    port within 1e-5) by 2.5e-3 of one example's delta_jacobian."""
    return jm.evaluate_logp(key, data, raw_ctx=jctx, n_solver_steps=steps, return_details=True)


def _rademacher(key, shape) -> np.ndarray:
    """The probes ``gecco_tpu.Diffusion.evaluate_logp`` draws from ``key``
    (the second of two keys), one set, [1, B, N, D]."""
    _, noise_key = jax.random.split(key)
    return np.asarray(jax.random.rademacher(noise_key, (1, *shape)).astype(jnp.float32))


# fp32, both sides the same function through 2 layers; 3 steps, 2
# transitions, 4 evaluations and 4 VJPs from the data to sigma 165: fp32
# rounding, summed in other orders. The trajectory and the latent relative
# to their largest value; prior_logp (a sum of squares of the latent, up to
# ~1e4) and delta_jacobian (the sum over B N D of e^T J e, integrated) to
# their largest absolute value; delta_reparam is closed-form on both sides.
TOLS = dict(logp=1e-4, prior_logp=1e-4, delta_reparam=1e-5, delta_jacobian=1e-4,
            trajectory_diff=1e-4, trajectory_data=1e-4, latent=1e-4)


@pytest.mark.parametrize("which", ["flagship", "conditional"])
def test_evaluate_logp_from_matches_jax(which):
    """``evaluate_logp_from`` fed the JAX package's Rademacher draw against
    ``gecco_tpu.Diffusion.evaluate_logp`` on the small ``folded_pallas``
    flagship (GaussianReparam) and on the small image-conditional model
    (UVLReparam, ConvNeXt pyramid, ``lookup_impl="pallas"``, whose VJP
    runs the gather's backward with the coordinate gradient), every
    ``LogpDetails`` field within ``TOLS`` of its largest value, in fp32."""
    key = jax.random.PRNGKey(17)
    if which == "flagship":
        jm, tm = _flagship()
        pts = (0.3 * np.random.default_rng(7).standard_normal((B, N, 3))).astype(np.float32)
        jctx = tctx = None
    else:
        jm, tm = _conditional()
        pts, images, K = _frustum_batch(8)
        jctx = JContext3d(image=j(images), K=j(K))
        tctx = Context3d(image=t(images), K=t(K))
    ref = _jax_logp(jm, key, j(pts), jctx, 3)
    eps = _rademacher(key, pts.shape)
    ours = tm.evaluate_logp_from(t(pts), t(eps), raw_ctx=tctx, n_solver_steps=3,
                                 return_details=True)
    for field in FIELDS:
        a, r = getattr(ours, field), getattr(ref, field)
        assert tuple(a.shape) == tuple(r.shape) and a.grad_fn is None, field
        # the states near sigma_max overflow the UVL map's exp on both sides
        finite = np.isfinite(f32(r))
        np.testing.assert_array_equal(np.isfinite(f32(a)), finite, err_msg=field)
        assert finite.all() or field == "trajectory_data", field
        err = rel_err(f32(a)[finite], f32(r)[finite])
        assert err < TOLS[field], (field, err)
    assert ours.trajectory_diff.shape == (2, B, N, 3)


def test_evaluate_logp_under_no_grad_writes_no_grad():
    """Under a caller's ``torch.no_grad()`` the likelihood still takes its
    VJPs (grad mode is on inside) and gives the same numbers as outside
    it; no parameter gets a ``.grad``; the first layer's pool is
    ``folded_pool_ext`` at every evaluation (the fused chain supplies its
    channel sums, as in the JAX package), never the resident pool."""
    _, tm = _flagship()
    pts = t((0.3 * np.random.default_rng(9).standard_normal((B, N, 3))).astype(np.float32))
    eps = torch.randint(0, 2, (1, B, N, 3), generator=torch.Generator().manual_seed(1)) * 2.0 - 1
    calls = []
    real = set_transformer.folded_pool_ext

    def spy(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the likelihood took the resident pool")

    mp = pytest.MonkeyPatch()
    mp.setattr(set_transformer, "folded_pool_ext", spy)
    mp.setattr(set_transformer, "folded_pool_layer", refuse)
    try:
        with torch.no_grad():
            inside = tm.evaluate_logp_from(pts, eps, n_solver_steps=2)
        outside = tm.evaluate_logp_from(pts, eps, n_solver_steps=2)
    finally:
        mp.undo()
    # 2 layers x 2 evaluations (one transition) x 2 calls, all under grad
    assert calls == [True] * 8
    torch.testing.assert_close(inside, outside, rtol=0, atol=0)
    assert bool(torch.isfinite(inside).all()) and inside.grad_fn is None
    assert all(p.grad is None for p in tm.parameters())
