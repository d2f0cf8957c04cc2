"""The reference-checkpoint path of the port against the JAX package's, on
the CPU: the ``.eqx`` reader and writer in both directions, the
``ref_jax_compat`` model (each layer's second MLP on the un-normed stream)
on the plain and the fused path, the reference-structure arm and the
checkpoint converter. The JAX side runs its Pallas kernels in interpret
mode, the port its kernels' plain versions.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.baselines import ref_denoise as jref_denoise
from gecco_tpu.baselines import ref_sample as jref_sample
from gecco_tpu.compat import export_flagship_to_eqx_order as jexport
from gecco_tpu.compat import load_flagship_from_eqx as jload
from gecco_tpu.compat import write_eqx_arrays as jwrite
from gecco_tpu_torch.baselines import ref_denoise, ref_sample, ref_sample_from
from gecco_tpu_torch.compat import (
    export_flagship_to_eqx_order,
    load_flagship_from_eqx,
    read_eqx_arrays,
    write_eqx_arrays,
)
from gecco_tpu_torch.convert import to_jax_params
from torch_parity import f32, jax_draws, jax_model, jax_params, t, torch_model

# 2 layers, C 64, 8 inducers, 4 heads
TINY = dict(num_inducers=8)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _jax(seed=0, compat=True, attn_impl="xla", dtype=jnp.float32, **kw):
    return jax_model(attn_impl, dtype=dtype, seed=seed, ref_jax_compat=compat, **TINY, **kw)


def _port(jm, compat=True, attn_impl="xla", dtype=torch.float32, **kw):
    return torch_model(jm, attn_impl, dtype=dtype, ref_jax_compat=compat, **TINY, **kw)


def _points(shape, seed=3, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _assert_params_equal(port, ref: dict):
    ours = to_jax_params(port)
    assert set(ours) == set(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(ours[name], value, err_msg=name)


# ---------------------------------------------------------------- .eqx io --


def test_jax_eqx_loads_into_the_port(tmp_path):
    """A file the JAX package writes loads into a port model built from
    another seed: every parameter the same bits, denoise at fp32."""
    src = _jax(seed=1)
    path = str(tmp_path / "ema.eqx")
    jwrite(path, jexport(src))
    dst = load_flagship_from_eqx(_port(_jax(seed=2)), path)
    _assert_params_equal(dst, jax_params(src))
    x = _points((2, 32, 3))
    sigma = np.array([0.3, 4.0], np.float32)
    np.testing.assert_allclose(f32(dst.denoise(t(sigma), t(x))),
                               f32(src.denoise(jnp.asarray(sigma), jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_port_eqx_loads_into_jax(tmp_path):
    """The port's export loads into the JAX package: the same parameters and
    the same denoiser."""
    src = _port(_jax(seed=1))
    path = str(tmp_path / "ema.eqx")
    write_eqx_arrays(path, export_flagship_to_eqx_order(src))
    dst = jload(_jax(seed=2), path)
    _assert_params_equal(src, jax_params(dst))
    x = _points((2, 32, 3))
    np.testing.assert_allclose(f32(dst.denoise(0.7, jnp.asarray(x))), f32(src.denoise(0.7, t(x))),
                               rtol=1e-5, atol=1e-6)
    # and the export is the JAX package's own, array for array
    for a, b in zip(export_flagship_to_eqx_order(src), jexport(dst)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_eqx_scalar_blobs_are_skipped(tmp_path):
    """equinox interleaves python-scalar fields with the parameters; the
    reader drops them by dtype and keeps the 0-d float32 alphas."""
    src = _port(_jax(seed=1))
    arrays = export_flagship_to_eqx_order(src)
    path = str(tmp_path / "ema.eqx")
    with open(path, "wb") as f:
        for i, a in enumerate(arrays):
            np.save(f, np.float64(0.1))
            if i % 3 == 0:
                np.save(f, np.int64(384))
            if i % 5 == 0:
                np.save(f, np.bool_(False))
            np.save(f, a)
    assert len(read_eqx_arrays(path)) == len(arrays)
    dst = load_flagship_from_eqx(_port(_jax(seed=2)), path)
    _assert_params_equal(dst, to_jax_params(src))


@pytest.mark.parametrize("fault,match", [
    ("shape", "expected shape"),
    ("short", "exhausted"),
    ("long", "unconsumed parameters"),
    ("compat", "ref_jax_compat"),
])
def test_eqx_errors_are_loud(tmp_path, fault, match):
    """A wrong shape, a short or long file and a model without
    ``ref_jax_compat`` raise, and the model is left as it was."""
    arrays = export_flagship_to_eqx_order(_port(_jax(seed=1)))
    if fault == "shape":
        arrays[3] = arrays[3][:-1]
    elif fault == "short":
        arrays = arrays[:-1]
    elif fault == "long":
        arrays = arrays + [np.zeros(3, np.float32)]
    path = str(tmp_path / "bad.eqx")
    write_eqx_arrays(path, arrays)
    dst = _port(_jax(seed=2), compat=fault != "compat")
    before = to_jax_params(dst)
    with pytest.raises(ValueError, match=match):
        load_flagship_from_eqx(dst, path)
    _assert_params_equal(dst, before)


# ------------------------------------------------------------ compat model --


@pytest.mark.parametrize(
    "attn_impl,jdtype,tdtype,out_tol,loss_tol,grad_tol",
    [
        # fp32: the same function, fp32 roundings in other orders
        ("xla", jnp.float32, torch.float32, 1e-5, 1e-5, 1e-4),
        ("folded_pallas", jnp.float32, torch.float32, 1e-5, 1e-5, 1e-4),
        # bf16 activations through 2 layers: both round and sum in other
        # orders, forward and backward (tests/test_torch_train.py's bounds)
        ("folded_pallas", jnp.bfloat16, torch.bfloat16, 3e-2, 1e-3, 5e-2),
    ],
    ids=["plain-fp32", "fused-fp32", "fused-bf16"],
)
def test_compat_denoise_loss_and_gradients_match_jax(attn_impl, jdtype, tdtype, out_tol,
                                                     loss_tol, grad_tol):
    """The compat model: denoise, loss and every parameter's gradient
    against the JAX package's; ``mlp_norm`` gets a zero gradient in both."""
    jm = _jax(attn_impl=attn_impl, dtype=jdtype)
    tm = _port(jm, attn_impl=attn_impl, dtype=tdtype)
    points = _points((2, 128, 3), scale=0.35)
    sigma = np.array([0.05, 30.0], np.float32)
    key = jax.random.PRNGKey(3)
    ref, (jloss, jgrads) = jax.jit(lambda m, p, s: (
        m.denoise(s, p), jax.value_and_grad(lambda mm: mm.loss(p, None, key))(m)))(
        jm, jnp.asarray(points), jnp.asarray(sigma))
    out = tm.denoise(t(sigma), t(points))
    err = np.abs(f32(out) - f32(ref)).max() / np.abs(f32(ref)).max()
    assert err < out_tol, err

    draw_sigma, noise = jax_draws(jm, points, key)
    loss = tm.loss_from(t(points), t(draw_sigma), t(noise))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= loss_tol * abs(float(jloss))
    ref, ours = jax_params(jgrads), to_jax_params(tm, grads=True)
    assert set(ours) == set(ref)
    mlp_norm = [k for k in ref if ".mlp_norm." in k]
    assert len(mlp_norm) == 4
    for name in mlp_norm:
        assert not np.abs(ref[name]).any() and not np.abs(ours[name]).any(), name
    for name, g in ref.items():
        if np.abs(g).max() > 0:
            err = np.abs(ours[name] - g).max() / np.abs(g).max()
            assert err < grad_tol, (name, err)
        else:  # mlp_norm and the reparam's statistics
            assert not np.abs(ours[name]).any(), name


def test_compat_cache_and_remat_take_the_flag():
    """The compat flag through the inducer cache (``return_h``, then ``hs``
    for new points: the unpool side alone) against the JAX package, and
    through ``remat``'s recomputed layers (the loss and every gradient of
    the model without remat, which the JAX package holds above), on
    ``folded_pallas`` in fp32."""
    jm = _jax(attn_impl="folded_pallas")
    tm = _port(jm, attn_impl="folded_pallas")
    x, new = _points((2, 128, 3), seed=4), _points((2, 128, 3), seed=5)
    sigma = np.array([0.3, 12.0], np.float32)

    @jax.jit
    def jax_side(s, a, b):
        out, hs = jm.denoise(s, a, return_h=True)
        return out, hs, jm.denoise(s, b, hs=hs)

    jout, jhs, jcached = jax_side(jnp.asarray(sigma), jnp.asarray(x), jnp.asarray(new))
    with torch.no_grad():
        out, hs = tm.denoise(t(sigma), t(x), return_h=True)
        cached = tm.denoise(t(sigma), t(new), hs=hs)
    for ours, ref in ((out, jout), (hs, jhs), (cached, jcached)):
        np.testing.assert_allclose(f32(ours), f32(ref), rtol=1e-4, atol=1e-5)

    points = t(_points((2, 128, 3), scale=0.35))
    draw_sigma, noise = tm.draw_sigma_noise(torch.Generator().manual_seed(6), points)
    runs = []
    for remat in (False, True):
        tm.network.backbone.remat = remat
        tm.zero_grad(set_to_none=True)
        loss = tm.loss_from(points, draw_sigma, noise)
        loss.backward()
        runs.append((loss.detach(), to_jax_params(tm, grads=True)))
    (loss, grads), (loss_remat, grads_remat) = runs
    torch.testing.assert_close(loss_remat, loss, rtol=1e-6, atol=0)
    for name, g in grads.items():
        np.testing.assert_allclose(grads_remat[name], g, rtol=1e-5, atol=1e-7, err_msg=name)
    assert not any(np.abs(g).any() for k, g in grads_remat.items() if ".mlp_norm." in k)


@pytest.mark.parametrize("attn_impl", ["xla", "folded_pallas"])
def test_compat_flag_changes_the_function(attn_impl):
    """At the same weights the compat and the default model differ; the
    compat one is the reference arm's function."""
    jm = _jax(attn_impl=attn_impl)
    compat = _port(jm, attn_impl=attn_impl)
    default = _port(jm, compat=False, attn_impl=attn_impl)
    x = t(_points((2, 128, 3)))
    with torch.no_grad():
        a, b = compat.denoise(1.0, x), default.denoise(1.0, x)
        ref = ref_denoise(compat, 1.0, x)
    assert not np.allclose(f32(a), f32(b), rtol=1e-4)
    np.testing.assert_allclose(f32(a), f32(ref), rtol=2e-4, atol=1e-5)
    assert not np.allclose(f32(b), f32(ref), rtol=1e-4)


# ------------------------------------------------------- reference arm --


def test_ref_denoise_matches_the_compat_model_and_jax_arm():
    """``ref_denoise`` against the compat model (fp32, the JAX test's
    tolerance) and against the JAX package's arm."""
    jm = _jax()
    tm = _port(jm)
    x = _points((4, 32, 3))
    sigma = np.array([0.1, 1.0, 5.0, 160.0], np.float32)
    ours = ref_denoise(tm, t(sigma), t(x))
    np.testing.assert_allclose(f32(ours), f32(tm.denoise(t(sigma), t(x))), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(f32(ours), f32(jref_denoise(jm, jnp.asarray(sigma), jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_ref_sample_matches_jax_arm():
    """``ref_sample_from`` fed the JAX arm's per-example latents gives the
    JAX arm's samples."""
    jm = _jax(n_steps=8)
    tm = _port(jm, n_steps=8)
    key, shape = jax.random.PRNGKey(2), (2, 32, 3)
    ref = np.asarray(jref_sample(jm, key, shape, n_solver_steps=8))
    sigma_max = float(jm.schedule.solver_grid(8)[0])
    latent = np.stack([np.asarray(jax.random.normal(k, shape[1:], jnp.float32))
                       for k in jax.random.split(key, shape[0])])
    ours = ref_sample_from(tm, t(sigma_max * latent), n_solver_steps=8)
    np.testing.assert_allclose(f32(ours), ref, rtol=1e-4, atol=1e-5)
    # ref_sample draws the latents example by example from its generator
    drawn = ref_sample(tm, torch.Generator().manual_seed(4), shape, n_solver_steps=8)
    g = torch.Generator().manual_seed(4)
    latent = torch.stack([torch.randn(shape[1:], generator=g) for _ in range(shape[0])])
    torch.testing.assert_close(drawn, ref_sample_from(tm, sigma_max * latent, 8))


# ------------------------------------------------------------- converter --


def test_convert_ref_checkpoint_writes_a_checkpoint_the_infer_cli_samples(tmp_path):
    """``python -m gecco_tpu_torch.compat.convert_ref_checkpoint`` on a file
    the JAX package wrote: the run directory's EMA weights are the file's,
    and the infer CLI samples them through the written config."""
    from gecco_tpu_torch.compat import convert_ref_checkpoint as conv
    from gecco_tpu_torch.infer import __main__ as infer

    jm = jax_model("folded_pallas", dtype=jnp.bfloat16, seed=1, ref_jax_compat=True, **TINY)
    path = str(tmp_path / "ema.eqx")
    jwrite(path, jexport(jm))
    out = tmp_path / "run"
    ckpt = conv.main([path, "--out", str(out), "--n-layers", "2", "--feature-dim", "64",
                      "--num-inducers", "8", "--num-heads", "4", "--sigma-max", "165",
                      "--device", "cpu"])
    assert json.load(open(os.path.join(ckpt, "meta.json"))) == {"step": 0,
                                                               "source": os.path.abspath(path)}
    arch = dict(n_layers=2, feature_dim=64, num_inducers=8, num_heads=4)
    loaded = conv.build_model(**arch, device="cpu")
    loaded.load_state_dict(torch.load(os.path.join(ckpt, "ema.pt")))
    _assert_params_equal(loaded, jax_params(jm))
    samples = infer.main([str(out / "config.py"), "--n-samples", "2", "--n-points", "128",
                          "--batch-size", "2", "--n-solver-steps", "2", "--device", "cpu",
                          "--output", str(tmp_path / "samples.npz")])
    assert samples.shape == (2, 128, 3) and np.isfinite(samples).all()


@pytest.mark.skipif("GECCO_REF_EQX" not in os.environ,
                    reason="set GECCO_REF_EQX=/path/to/reference ema.eqx to run")
def test_convert_real_reference_checkpoint():
    """A released checkpoint (the flagship's architecture): the converted
    denoiser is finite and contracts noisy clouds."""
    from gecco_tpu_torch.compat.convert_ref_checkpoint import convert

    model = convert(os.environ["GECCO_REF_EQX"], device="cpu")
    x = 0.35 * torch.randn(2, 2048, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model.denoise(1.0, x)
    assert bool(torch.isfinite(out).all())
    assert float(out.abs().mean()) < float(x.abs().mean()) * 2


def test_chip_smoke_phase_29_runs_on_the_cpu(capsys):
    """``chip_smoke.py``'s phase 29 at a tiny width on the CPU (the kernels'
    plain versions): every step of it runs and its checks pass."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dims = dict(n_layers=2, feature_dim=64, num_inducers=16, num_heads=4, n_points=128)
    out = smoke.compat_phase(torch.device("cpu"), 2, 2, 128, 2, 3, 2, dims=dims)
    text = capsys.readouterr().out
    assert set(out) == {"compat_sample", "compat_step", "silu_sample", "silu_step"}
    for line in (".eqx round trip", "compat 8-step sample, kernel path vs plain path",
                 "fp32 evaluation of 2 clouds against ref_denoise",
                 "the same weights without ref_jax_compat",
                 "mlp_norm's 8 parameters without a gradient",
                 "SiLU flagship's 8-step sample, kernel path vs plain path"):
        assert line in text, line
