"""The port's visualisation callbacks (``gecco_tpu_torch.vis``) against the
JAX package's (``gecco_tpu.vis``), on the CPU.

Both sides run on the same weights (the JAX model's, moved with
``gecco_tpu_torch.convert``): a 2-layer fp32 set transformer at C 32 with 4
inducers, 2-D for the toy figures and 3-D for the meshes and renders. A
recording writer keeps what each callback logs: the tags, the kinds and the
data of each figure (its scatter offsets and images) or mesh. The port's
callback is fed the JAX callback's draws through its seam (``latent``,
``normal``, ``eps``, ``noise``, which reach the samplers' ``*_from`` entry
points), rebuilt from the JAX key as ``test_torch_samplers.py`` and
``test_torch_logp.py`` rebuild them, so both plot the same samples within
those files' fp32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu import Diffusion as JDiffusion
from gecco_tpu import LogUniformSchedule as JLogUniformSchedule
from gecco_tpu import vis as jvis
from gecco_tpu.diffusion.samplers import churn_gamma as jchurn_gamma
from gecco_tpu.models import SetTransformer as JSetTransformer
from gecco_tpu.models import UnconditionalPointNetwork as JNetwork
from gecco_tpu.types import Context3d as JContext3d
from gecco_tpu.types import Example as JExample
from gecco_tpu_torch import Diffusion, LogUniformSchedule, vis
from gecco_tpu_torch.convert import load_jax_params
from gecco_tpu_torch.models import SetTransformer, UnconditionalPointNetwork
from gecco_tpu_torch.types import Context3d, Example
from gecco_tpu_torch.vis.mitsuba_render import mitsuba_available
from torch_parity import jax_params, rel_err, t

SEED = 42
N_POINTS = 16
TOL = 1e-4  # fp32 on both sides: the sampler and likelihood tests' tolerance


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _models(geom_dim, seed):
    """``tests/test_vis_and_init.py``'s tiny JAX model and the port's on its
    weights."""
    bk, nk = jax.random.split(jax.random.PRNGKey(seed))
    backbone = JSetTransformer.init(bk, n_layers=2, feature_dim=32, num_inducers=4, embed_dim=1,
                                    num_heads=4, compute_dtype=jnp.float32, skip_scale=0.1)
    net = JNetwork.init(nk, backbone, feature_dim=32, geometry_dim=geom_dim)
    jm = JDiffusion.init(net, JLogUniformSchedule(sigma_max=10.0, n_solver_steps=8))
    gen = torch.Generator().manual_seed(0)
    tb = SetTransformer(2, 32, 4, embed_dim=1, num_heads=4, compute_dtype=torch.float32,
                        skip_scale=0.1, device="cpu", generator=gen)
    tnet = UnconditionalPointNetwork(tb, 32, geometry_dim=geom_dim, device="cpu", generator=gen)
    tm = Diffusion(tnet, LogUniformSchedule(sigma_max=10.0, n_solver_steps=8))
    return jm, load_jax_params(tm, jax_params(jm))


def _figure_data(fig) -> list:
    """The arrays a figure shows: each axes' scatter offsets (3-D ones
    too) and images, in order."""
    out = []
    for ax in fig.axes:
        for c in ax.collections:
            xyz = getattr(c, "_offsets3d", None)
            out.append(np.stack([np.asarray(v, np.float64) for v in xyz], -1) if xyz is not None
                       else np.asarray(c.get_offsets(), np.float64))
        out += [np.asarray(im.get_array(), np.float64) for im in ax.images]
    return out


class Recorder:
    """A writer that keeps (kind, tag, data arrays) per call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, kind):
        def record(tag, *args, global_step=None, **kw):
            if kind == "add_figure":
                data = _figure_data(kw["figure"])
            elif kind == "add_mesh":
                data = [np.asarray(kw["vertices"], np.float64)] + (
                    [] if kw.get("colors") is None else [np.asarray(kw["colors"])])
            else:
                data = [np.asarray(kw["img_tensor"])]
            self.calls.append((kind, tag, data))

        return record


def _same_log(ours: Recorder, ref: Recorder, compare=None):
    """The same calls (kind, tag, array shapes); the arrays named by
    ``compare`` ((call, array) indices) within ``TOL`` of their largest
    value."""
    assert [(k, tg, [d.shape for d in ds]) for k, tg, ds in ours.calls] == [
        (k, tg, [d.shape for d in ds]) for k, tg, ds in ref.calls]
    for call, arr in compare or ():
        a, r = ours.calls[call][2][arr], ref.calls[call][2][arr]
        assert rel_err(a, r) < TOL, (ours.calls[call][1], arr, rel_err(a, r))


def _stochastic_draws(key, shape, n_steps) -> list:
    """The normals ``gecco_tpu``'s ``sample_stochastic`` draws from ``key``
    at churn 0.5: the initial state, then one churn draw per transition."""
    _, init_key, rng = jax.random.split(key, 3)
    draws = [np.asarray(jax.random.normal(init_key, shape))]
    if jchurn_gamma(0.5, n_steps) > 0.0:
        for _ in range(n_steps):
            rng, churn_key = jax.random.split(rng)
            draws.append(np.asarray(jax.random.normal(churn_key, shape, jnp.float32)))
    return draws


def _feeder(draws):
    it = iter(draws)

    def normal(shape):
        a = next(it)
        assert a.shape == tuple(shape), (a.shape, shape)
        return t(a)

    return normal


# ------------------------------------------------------------------ tests --


def test_trajectories_to_polylines_matches_jax():
    traj = np.random.default_rng(0).normal(size=(5, 8, 3)).astype(np.float32)
    for max_lines in (512, 3):
        ref = jvis.trajectories_to_polylines(traj, max_lines)
        for given in (traj, torch.from_numpy(traj)):
            ours = vis.trajectories_to_polylines(given, max_lines)
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
    assert vis.plot_trajectories_3d(traj) is not None


def test_sample_figures_callback_matches_jax():
    jm, tm = _models(2, 2)
    shape = (2, N_POINTS, 2)
    ref = Recorder()
    jvis.make_sample_figures_callback(n_samples=2, n_points=N_POINTS, geom_dim=2)(jm, ref, 0)
    latent = jax.jit(lambda m, k: m.sample(k, shape, return_details=True).latent)(
        jm, jax.random.PRNGKey(SEED))
    ours = Recorder()
    vis.make_sample_figures_callback(n_samples=2, n_points=N_POINTS, geom_dim=2,
                                     latent=t(latent))(tm, ours, 0)
    # the two scatter panels and the first cloud's trajectory ends
    _same_log(ours, ref, compare=[(0, 0), (0, 1), (1, 0)])
    # the generator's own draw: the same calls
    drawn = Recorder()
    vis.make_sample_figures_callback(n_samples=2, n_points=N_POINTS, geom_dim=2)(tm, drawn, 0)
    _same_log(drawn, ref)


def test_denoise_callback_matches_jax():
    jm, tm = _models(2, 3)
    data = np.random.default_rng(0).normal(size=(32, 2)).astype(np.float32)
    ref = Recorder()
    jvis.make_denoise_callback(data, n_sigmas=3)(jm, ref, 1)
    key = jax.random.PRNGKey(SEED)
    sigmas = np.geomspace(jm.schedule.sigma_min * 10, jm.schedule.sigma_max, 3)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, int(s * 1000) % 2**30), (1, 32, 2))) for s in sigmas])
    ours = Recorder()
    vis.make_denoise_callback(data, n_sigmas=3, noise=t(noise))(tm, ours, 1)
    # each panel: the ground truth, then the denoised points
    _same_log(ours, ref, compare=[(0, q) for q in range(6)])


def test_logp_callback_matches_jax():
    jm, tm = _models(2, 7)
    data = np.random.default_rng(1).normal(size=(20, 2)).astype(np.float32)
    ref = Recorder()
    jvis.make_logp_callback(data, grid_res=6)(jm, ref, 0)
    # ``evaluate_logp``'s probes: the second of two keys, one set
    _, noise_key = jax.random.split(jax.random.PRNGKey(SEED))
    eps = np.asarray(jax.random.rademacher(noise_key, (1, 36, 1, 2)).astype(jnp.float32))
    ours = Recorder()
    vis.make_logp_callback(data, grid_res=6, eps=t(eps))(tm, ours, 0)
    _same_log(ours, ref, compare=[(0, 1)])  # the heatmap
    assert np.isfinite(ours.calls[0][2][1]).all()


def test_unconditional_mesh_callback_matches_jax():
    jm, tm = _models(3, 4)
    shape = (2, N_POINTS, 3)
    ref = Recorder()
    jvis.make_unconditional_sample_callback(n_samples=2, n_points=N_POINTS)(jm, ref, 0)
    latent = jax.jit(lambda m, k: m.sample(k, shape, return_details=True).latent)(
        jm, jax.random.PRNGKey(SEED))
    ours = Recorder()
    vis.make_unconditional_sample_callback(n_samples=2, n_points=N_POINTS,
                                           latent=t(latent))(tm, ours, 0)
    _same_log(ours, ref, compare=[(0, 0)])
    np.testing.assert_array_equal(ours.calls[0][2][1], ref.calls[0][2][1])  # latent colours


@pytest.mark.parametrize("with_ctx", [False, True])
def test_pc_vis_callback_matches_jax(with_ctx):
    jm, tm = _models(3, 5)
    rng = np.random.default_rng(0)
    points = rng.normal(size=(4, N_POINTS, 3)).astype(np.float32)
    images = rng.random((4, 16, 16, 3)).astype(np.float32)
    K = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    jbatch = JExample(points, JContext3d(image=images, K=K) if with_ctx else None)
    batch = Example(points, Context3d(image=images, K=K) if with_ctx else None)
    ref, ours = Recorder(), Recorder()
    jcb = jvis.PCVisCallback(n=2, n_steps=4)
    jcb.set_batch(jbatch)
    jcb(jm, ref, 0)
    draws = _stochastic_draws(jax.random.PRNGKey(SEED), (2, N_POINTS, 3), 4)
    cb = vis.PCVisCallback(n=2, n_steps=4, normal=_feeder(draws))
    cb.set_batch(batch)
    cb(tm, ours, 0)
    mesh = len(ours.calls) - 1  # after the context images, once
    _same_log(ours, ref, compare=[(mesh, 0)])
    if with_ctx:
        assert [k for k, _, _ in ours.calls] == ["add_image"] * 2 + ["add_mesh"]
        np.testing.assert_array_equal(ours.calls[mesh][2][1], ref.calls[mesh][2][1])


def test_conditional_render_callback_matches_jax():
    jm, tm = _models(3, 6)
    rng = np.random.default_rng(0)
    points = rng.normal(size=(2, N_POINTS, 3)).astype(np.float32)
    images = rng.random((2, 16, 16, 3)).astype(np.float32)
    K = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    ref, ours = Recorder(), Recorder()
    jcb = jvis.ConditionalRenderCallback(n=2, n_steps=4)
    jcb.set_batch(JExample(points, JContext3d(image=images, K=K)))
    jcb(jm, ref, 0)
    draws = _stochastic_draws(jax.random.PRNGKey(SEED), (2, N_POINTS, 3), 4)
    cb = vis.ConditionalRenderCallback(n=2, n_steps=4, normal=_feeder(draws))
    cb.set_batch(Example(points, Context3d(image=images, K=K)))
    cb(tm, ours, 0)
    # per row: the image, the ground truth's scatter, the sample's scatter
    _same_log(ours, ref, compare=[(0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 5)])
    # no context: nothing logged, as in the JAX package
    idle = vis.ConditionalRenderCallback(n=2, n_steps=4)
    idle.set_batch(Example(points, None))
    quiet = Recorder()
    idle(tm, quiet, 0)
    assert quiet.calls == []


def test_render_cloud_backends_and_plots():
    pts = np.random.default_rng(0).normal(size=(64, 3))
    assert vis.render_cloud(pts, backend="auto") is not None
    if not mitsuba_available():
        with pytest.raises(ImportError):
            vis.render_cloud(pts, backend="mitsuba")
    fig = vis.plot_3d([pts, pts + 1.0], shared_ax=False)
    assert len(fig.axes) == 2
    traj = np.random.default_rng(1).normal(size=(4, 10, 2))
    assert len(_figure_data(vis.plot_trajectories_2d(traj, max_lines=5))[0]) == 5
