"""The port's modules against the JAX package's, on the CPU, on weights
moved with ``gecco_tpu_torch.convert``: norms, AdaGN, one fused and one
plain broadcasting layer, the set transformer and the denoiser network.
Also the import rule (no JAX, no gecco_tpu) and the CUDA default device.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.models.normalization import AdaGN as JAdaGN
from gecco_tpu.ops.norms import group_norm_stats as jgroup_norm_stats
from gecco_tpu_torch.convert import load_jax_params
from gecco_tpu_torch.models import AdaGN, SetTransformer
from gecco_tpu_torch.ops.norms import group_norm, group_norm_stats
from gecco_tpu_torch.utils import count_parameters
from torch_parity import SMALL, f32, j, jax_model, jax_params, rel_err, t, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(f32(port), f32(ref), rtol=rtol, atol=atol)


def test_group_norm_stats_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 128, 64)).astype(np.float32) * 3 + 1
    m, inv = group_norm_stats(t(x), 8)
    jm, jinv = jgroup_norm_stats(j(x), 8)
    _close(m, jm)
    _close(inv, jinv)
    from gecco_tpu.ops.norms import group_norm as jgroup_norm

    _close(group_norm(t(x), 8), jgroup_norm(j(x), 8))


def test_adagn_matches_jax():
    rng = np.random.default_rng(1)
    jnorm = JAdaGN.init(jax.random.PRNGKey(0), 64, 1)
    jnorm = jnorm.replace(
        scale_linear=jnorm.scale_linear.replace(weight=j(0.01 * rng.standard_normal((64, 1)))),
        bias_linear=jnorm.bias_linear.replace(weight=j(0.01 * rng.standard_normal((64, 1)))),
    )
    norm = AdaGN(64, 1, device="cpu")
    with torch.no_grad():
        for name, value in {"scale_linear.weight": jnorm.scale_linear.weight,
                            "scale_linear.bias": jnorm.scale_linear.bias,
                            "bias_linear.weight": jnorm.bias_linear.weight,
                            "bias_linear.bias": jnorm.bias_linear.bias}.items():
            norm.get_parameter(name).copy_(t(value))
    x = rng.standard_normal((2, 128, 64)).astype(np.float32)
    embed = np.array([[0.5], [80.0]], np.float32)
    _close(norm(t(x), t(embed)), jnorm(j(x), j(embed)))
    xf = x.astype(np.float32)
    sums = np.stack([xf.sum(1), (xf * xf).sum(1)], axis=1)
    for port, ref in zip(norm.scale_bias_from_sums(t(sums), 128, t(embed)),
                         jnorm.scale_bias_from_sums(j(sums), 128, j(embed))):
        _close(port, ref)
    for port, ref in zip(norm.effective_scale_bias(t(x), t(embed)),
                         jnorm.effective_scale_bias(j(x), j(embed))):
        _close(port, ref)


@pytest.mark.parametrize("attn_impl", ["folded_pallas", "xla"])
def test_broadcasting_layer_matches_jax(attn_impl):
    """One layer: the fused path (the four fused functions, statistics from
    channel sums) and the plain path, each against the JAX layer's same
    path; and the port's fused layer against the JAX plain layer."""
    from gecco_tpu.utils.modules import unstack_module

    jm = jax_model(attn_impl)
    tm = torch_model(jm, attn_impl)
    jlayer = unstack_module(jm.network.backbone.layers, 0)
    layer = tm.network.backbone.layers[0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 128, SMALL["feature_dim"])).astype(np.float32)
    embed = np.array([[0.3], [40.0]], np.float32)
    xf = x.astype(np.float64)
    sums = np.stack([xf.sum(1), (xf * xf).sum(1)], axis=1).astype(np.float32)
    kw = dict(in_sums=j(sums), with_sums=True) if attn_impl == "folded_pallas" else {}
    jout = jlayer(j(x), j(embed), attn_impl=attn_impl, **kw)
    out, h, out_sums = layer(t(x), t(embed), attn_impl, in_sums=t(sums))
    _close(out, jout[0])
    _close(h, jout[1])
    if attn_impl == "folded_pallas":
        np.testing.assert_allclose(f32(out_sums), f32(jout[2]), rtol=1e-4, atol=1e-3)
        plain, _ = jlayer(j(x), j(embed), attn_impl="xla")
        _close(out, plain, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("attn_impl", ["folded_pallas", "xla"])
def test_set_transformer_and_network_match_jax(attn_impl):
    jm = jax_model(attn_impl)
    tm = torch_model(jm, attn_impl)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 128, SMALL["feature_dim"])).astype(np.float32)
    embed = np.array([[0.01], [120.0]], np.float32)
    _close(tm.network.backbone(t(feats), t(embed)), jm.network.backbone(j(feats), j(embed)))
    pts = rng.standard_normal((2, 128, 3)).astype(np.float32)
    tt = np.array([0.05, 60.0], np.float32)
    _close(tm.network(t(tt), t(pts)), jm.network(j(tt), j(pts)), rtol=1e-4, atol=1e-4)


def test_embed_channel_sums_and_folded_head_match_jax():
    from gecco_tpu.models.wrappers import _embed_channel_sums as jsums
    from gecco_tpu.models.wrappers import _folded_head as jhead
    from gecco_tpu_torch.models.wrappers import _embed_channel_sums, _folded_head

    jm = jax_model()
    tm = torch_model(jm)
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((2, 128, 3)).astype(np.float32)
    _close(_embed_channel_sums(tm.network.xyz_embed, t(pts)),
           jsums(jm.network.xyz_embed, j(pts)), rtol=1e-4, atol=1e-3)
    x = rng.standard_normal((2, 128, SMALL["feature_dim"])).astype(np.float32)
    sums = np.stack([x.sum(1), (x * x).sum(1)], axis=1)
    _close(_folded_head(tm.network.output_proj, 32, t(x), t(sums)),
           jhead(jm.network.output_proj, 32, j(x), j(sums)))


def test_schedule_matches_jax():
    from gecco_tpu import LogUniformSchedule as JSchedule
    from gecco_tpu_torch import LogUniformSchedule

    js = JSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=128)
    ts = LogUniformSchedule(sigma_max=165.0, sigma_min=0.002, n_solver_steps=128)
    _close(ts.solver_grid(), js.solver_grid(), rtol=1e-6, atol=0)
    _close(ts.solver_grid(8), js.solver_grid(8), rtol=1e-6, atol=0)
    sig = np.array([0.002, 0.5, 165.0], np.float32)
    for fn in ("c_skip", "c_out", "c_in", "c_noise"):
        _close(getattr(ts, fn)(t(sig)), getattr(js, fn)(j(sig)), rtol=1e-6, atol=0)
    quarter = LogUniformSchedule(c_noise_mode="log_quarter")
    _close(quarter.c_noise(t(sig)), JSchedule(c_noise_mode="log_quarter").c_noise(j(sig)))


def test_converter_rejects_missing_unused_and_misshapen_keys():
    jm = jax_model()
    tm = torch_model(jm)
    params = jax_params(jm)
    assert count_parameters(tm) == sum(
        v.size for k, v in params.items() if not k.startswith("reparam.")
    )
    missing = {k: v for k, v in params.items() if k != "reparam.std"}
    with pytest.raises(KeyError, match="reparam.std"):
        load_jax_params(tm, missing)
    with pytest.raises(KeyError, match="not used"):
        load_jax_params(tm, {**params, "network.extra": np.zeros(3)})
    key = "network.backbone.layers.broadcast.pool.kv_proj.weight"
    bad = dict(params, **{key: params[key][:, :-1]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, bad)
    one_layer = dict(params, **{key: params[key][:1]})
    with pytest.raises(ValueError, match="no layer 1"):
        load_jax_params(tm, one_layer)


def test_modules_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SetTransformer(**SMALL, embed_dim=1)
    from gecco_tpu_torch.utils.modules import Linear

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Linear(3, 4)


def test_port_imports_neither_jax_nor_gecco_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gecco_tpu_torch\n"
        "for m in pkgutil.walk_packages(gecco_tpu_torch.__path__, 'gecco_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'gecco_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('gecco_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_fused_and_plain_paths_agree_in_bf16():
    """The port's own two paths at bf16: the fused chain (plain versions on
    the CPU) against the per-head attention path, same weights."""
    jm = jax_model()
    fused = torch_model(jm, dtype=torch.bfloat16)
    plain = torch_model(jm, "xla", dtype=torch.bfloat16)
    pts = np.random.default_rng(5).standard_normal((2, 128, 3)).astype(np.float32)
    tt = np.array([0.05, 60.0], np.float32)
    # bf16 activations through 2 layers: a few bf16 steps (2^-8) of the output
    assert rel_err(fused.network(t(tt), t(pts)), plain.network(t(tt), t(pts))) < 3e-2


def test_chip_smoke_rehearsal_runs_its_phases_on_the_cpu():
    """``chip_smoke.py --rehearse`` drives every phase at a tiny size with
    the plain versions and exits 1 without a result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 1, res.stderr
    assert "8-step sample, kernel path vs plain path" in res.stdout
    assert "train-step gradient, kernel path vs plain path" in res.stdout
    assert "rect_attention_bwd [unpool 8k width, drift] dv" in res.stdout
    assert "8-step sample, per-head kernel path vs plain path" in res.stdout
    assert "8-step sample, megakernel path vs the separate kernels' path" in res.stdout
    assert "folded_pool_layer_bwd [no pre-norm 8k width, drift] dwo" in res.stdout
    assert "folded_unpool_bwd, no residual, no pre-norm [drift] dwo" in res.stdout
    assert "BroadcastingLayer without sums" in res.stdout
    assert "kernel path vs plain path: max" in res.stdout.split("== upsample path")[-1]
    assert "folded_unpool 8k width [drift] sums" in res.stdout
    assert "scores ok" in res.stdout.split("== validation")[-1]
    assert "fp32 sums-less BroadcastingLayer, folded_pallas vs xla" in res.stdout
    assert "resumed at step 4" in res.stdout.split("== Trainer")[-1]
    assert '"ok": true' not in res.stdout
