"""The ConvNeXt's sizes, modes and weight converter, and
``GlobalConditioningNetwork``, against the JAX package's, on the CPU.

A miniature size (``"mini"``: 2, 2, 2, 1 blocks of 8, 16, 32, 64 channels)
is registered in both packages' ``CONVNEXT_CONFIGS``, as
``tests/test_conditional.py`` registers one. A torchvision-layout state
dict built from a seed goes into both packages' converters; the pyramids
agree with each other and with a plain NCHW forward of the state dict. The
global model (a two-layer 32-channel backbone with 8 inducers on
``folded_pallas``, its embed 1 + 32 channels) gets the JAX model's weights
through ``gecco_tpu_torch.convert``; its forward and its loss gradient are
held to the JAX package's, whose folded kernels run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import gecco_tpu.models.convnext as jcnx
from gecco_tpu import Diffusion as JDiffusion
from gecco_tpu import GaussianReparam as JGaussianReparam
from gecco_tpu import LogUniformSchedule as JLogUniformSchedule
from gecco_tpu.models import GlobalConditioningNetwork as JGlobalNetwork
from gecco_tpu.models import SetTransformer as JSetTransformer
from gecco_tpu.types import Context3d as JContext3d
from gecco_tpu_torch import Context3d, Diffusion, GaussianReparam, LogUniformSchedule
from gecco_tpu_torch.convert import load_jax_params, to_jax_params
from gecco_tpu_torch.models import (
    GlobalConditioningNetwork,
    LinearLift,
    SetTransformer,
    UnconditionalPointNetwork,
)
from gecco_tpu_torch.models import convnext as cnx
from torch_parity import f32, j, jax_params, perturb, rel_err, t

MINI = ((2, 2, 2, 1), (8, 16, 32, 64))
B, N, IMAGE = 2, 128, 40  # a 10^2, 5^2, 2^2 pyramid
WIDTH, INDUCERS = 32, 8


@pytest.fixture(autouse=True)
def _mini(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setitem(cnx.CONVNEXT_CONFIGS, "mini", MINI)
    monkeypatch.setitem(jcnx.CONVNEXT_CONFIGS, "mini", MINI)


def _state_dict(seed=0, depths=MINI[0], widths=MINI[1]) -> dict:
    """A torchvision ``convnext_*`` state dict (every stage, the clipped
    ones too) of random values, as torch tensors."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen) * 0.1
    pos = lambda *s: torch.rand(*s, generator=gen) + 0.5
    state = {"features.0.0.weight": rnd(widths[0], 3, 4, 4), "features.0.0.bias": rnd(widths[0]),
             "features.0.1.weight": pos(widths[0]), "features.0.1.bias": rnd(widths[0])}
    for k, (d, w) in enumerate(zip(depths, widths)):
        for q in range(d):
            p = f"features.{2 * k + 1}.{q}"
            state.update({
                f"{p}.block.0.weight": rnd(w, 1, 7, 7), f"{p}.block.0.bias": rnd(w),
                f"{p}.block.2.weight": pos(w), f"{p}.block.2.bias": rnd(w),
                f"{p}.block.3.weight": rnd(4 * w, w), f"{p}.block.3.bias": rnd(4 * w),
                f"{p}.block.5.weight": rnd(w, 4 * w), f"{p}.block.5.bias": rnd(w),
                f"{p}.layer_scale": torch.rand(w, 1, 1, generator=gen) * 0.5,
            })
        if k + 1 < len(widths):
            p = f"features.{2 * k + 2}"
            state.update({f"{p}.0.weight": pos(w), f"{p}.0.bias": rnd(w),
                          f"{p}.1.weight": rnd(widths[k + 1], w, 2, 2),
                          f"{p}.1.bias": rnd(widths[k + 1])})
    return state


def _plain_forward(state, x, n_stages, depths=MINI[0]):
    """The state dict's ConvNeXt in NCHW as torchvision computes it:
    LayerNorm over channels, GELU, layer scale of shape [C, 1, 1]."""

    def ln(y, w, b):
        return F.layer_norm(y.permute(0, 2, 3, 1), y.shape[1:2], w, b, 1e-6).permute(0, 3, 1, 2)

    x = F.conv2d(x, state["features.0.0.weight"], state["features.0.0.bias"], stride=4)
    x = ln(x, state["features.0.1.weight"], state["features.0.1.bias"])
    maps = []
    for k in range(n_stages):
        for q in range(depths[k]):
            p = f"features.{2 * k + 1}.{q}"
            y = F.conv2d(x, state[f"{p}.block.0.weight"], state[f"{p}.block.0.bias"], padding=3,
                         groups=x.shape[1])
            y = F.layer_norm(y.permute(0, 2, 3, 1), y.shape[1:2], state[f"{p}.block.2.weight"],
                             state[f"{p}.block.2.bias"], 1e-6)
            y = F.linear(F.gelu(F.linear(y, state[f"{p}.block.3.weight"],
                                         state[f"{p}.block.3.bias"])),
                         state[f"{p}.block.5.weight"], state[f"{p}.block.5.bias"])
            x = x + state[f"{p}.layer_scale"] * y.permute(0, 3, 1, 2)
        maps.append(x)
        if k + 1 < n_stages:
            p = f"features.{2 * k + 2}"
            x = F.conv2d(ln(x, state[f"{p}.0.weight"], state[f"{p}.0.bias"]),
                         state[f"{p}.1.weight"], state[f"{p}.1.bias"], stride=2)
    return maps


@pytest.mark.parametrize("n_stages", [2, 3])
def test_converter_gives_the_jax_pyramid_and_the_plain_one(n_stages):
    state = _state_dict(1)
    images = np.random.default_rng(2).uniform(size=(B, IMAGE, IMAGE, 3)).astype(np.float32)
    port = cnx.ConvNeXt("mini", n_stages, torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert len(port.stages) == n_stages and len(port.downs) == n_stages - 1
    assert [len(s) for s in port.stages] == list(MINI[0][:n_stages])
    cnx.load_torchvision_state_dict(port, state)
    jmodel = jcnx.load_torchvision_state_dict(
        jcnx.ConvNeXt.init(jax.random.PRNGKey(0), size="mini", n_stages=n_stages,
                           compute_dtype=jnp.float32), state)
    with torch.no_grad():
        maps = port(t(images))
        plain = _plain_forward(state, t(images).permute(0, 3, 1, 2), n_stages)
    jmaps = jax.jit(lambda m, x: m(x))(jmodel, j(images))
    assert len(maps) == len(jmaps) == n_stages
    for q, (a, r, p) in enumerate(zip(maps, jmaps, plain)):
        assert a.shape == r.shape == (B, IMAGE // 4 >> q, IMAGE // 4 >> q, MINI[1][q])
        np.testing.assert_allclose(f32(a), f32(r), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f32(a), f32(p.permute(0, 2, 3, 1)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_extractor_modes_and_the_npz_loader(tmp_path, mode):
    state = _state_dict(3)
    path = str(tmp_path / "convnext_mini.npz")
    np.savez(path, **{k: v.numpy() for k, v in state.items()})
    port = cnx.ConvNeXtExtractor("mini", mode, torch.float32, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    assert cnx.load_pretrained_npz(port, path) is port
    jext = jcnx.load_pretrained_npz(
        jcnx.ConvNeXtExtractor.init(jax.random.PRNGKey(1), size="mini", mode=mode,
                                    compute_dtype=jnp.float32), path)
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (B, IMAGE, IMAGE, 3), dtype=np.uint8)
    K = rng.normal(size=(B, 3, 3)).astype(np.float32)
    with torch.no_grad():
        out = port(Context3d(image=torch.from_numpy(images), K=t(K)))
    ref = jax.jit(lambda e, c: e(c))(jext, JContext3d(image=jnp.asarray(images), K=j(K)))
    assert len(out.features) == len(ref.features) == (3 if mode == "local" else 1)
    for a, r in zip(out.features, ref.features):
        np.testing.assert_allclose(f32(a), f32(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(f32(out.K), K)


def test_converter_and_extractor_reject_what_does_not_fit():
    with pytest.raises(ValueError, match="mode"):
        cnx.ConvNeXtExtractor("mini", "pooled", device="cpu")
    with pytest.raises(KeyError):
        cnx.ConvNeXt("huge", device="cpu")
    model = cnx.ConvNeXt("mini", device="cpu")
    before = model.stem_kernel.detach().clone()
    wide = _state_dict(5, widths=(8, 16, 48, 64))  # the third stage 48 wide
    with pytest.raises(ValueError, match="stages.2"):
        cnx.load_torchvision_state_dict(model, wide)
    assert torch.equal(model.stem_kernel, before)  # nothing copied
    tiny = cnx.ConvNeXt(device="cpu")
    assert [len(s) for s in tiny.stages] == [3, 3, 9] and tiny.stem_kernel.shape == (4, 4, 3, 96)
    assert LinearLift is UnconditionalPointNetwork


def _global_models(seed=0):
    """The JAX global model (mini extractor in global mode) and the port's,
    loaded with the JAX model's weights."""
    embed = 1 + MINI[1][2]
    bk, nk, ck = jax.random.split(jax.random.PRNGKey(seed), 3)
    jback = JSetTransformer.init(bk, n_layers=2, feature_dim=WIDTH, num_inducers=INDUCERS,
                                 embed_dim=embed, num_heads=4, compute_dtype=jnp.float32,
                                 attn_impl="folded_pallas")
    jnet = JGlobalNetwork.init(nk, jback, feature_dim=WIDTH)
    jcond = jcnx.ConvNeXtExtractor.init(ck, size="mini", mode="global",
                                        compute_dtype=jnp.float32)
    sched = dict(sigma_max=80.0, sigma_min=0.002, n_solver_steps=4)
    jm = perturb(JDiffusion.init(jnet, JLogUniformSchedule(**sched),
                                 reparam=JGaussianReparam.init([0.1, 0.0, -0.1], [0.4, 0.3, 0.5]),
                                 cond=jcond), seed)
    gen = torch.Generator().manual_seed(0)
    back = SetTransformer(2, WIDTH, INDUCERS, embed_dim=embed, num_heads=4,
                          compute_dtype=torch.float32, attn_impl="folded_pallas", device="cpu",
                          generator=gen)
    net = GlobalConditioningNetwork(back, WIDTH, device="cpu", generator=gen)
    cond = cnx.ConvNeXtExtractor("mini", "global", torch.float32, device="cpu", generator=gen)
    tm = Diffusion(net, LogUniformSchedule(**sched),
                   reparam=GaussianReparam([0.0] * 3, [1.0] * 3, device="cpu"), cond=cond)
    return jm, load_jax_params(tm, jax_params(jm))


def test_global_network_forward_and_loss_gradient_match_jax():
    """At fp32 on the folded path: the network's output at the JAX
    conditional tests' rtol 1e-4, the loss at 1e-5 and every gradient
    within 2e-4 of max |ref| (the conditional model's limits), from the
    sigma and noise the JAX loss draws."""
    jm, tm = _global_models()
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    images = rng.integers(0, 256, (B, IMAGE, IMAGE, 3), dtype=np.uint8)
    K = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    jctx = JContext3d(image=jnp.asarray(images), K=j(K))
    tctx = Context3d(image=torch.from_numpy(images), K=t(K))
    tt = np.array([0.05, 60.0], np.float32)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def jside(m):
        out = m.network(j(tt), j(pts), m.cond(jctx))
        loss, grads = jax.value_and_grad(lambda mm: mm.loss(j(pts), jctx, key))(m)
        sigma_key, noise_key, _, _ = jax.random.split(key, 4)
        sigma = m.schedule.sample_sigma(sigma_key, B)
        noise = jax.random.normal(noise_key, pts.shape, jnp.float32)
        return out, loss, grads, sigma, noise

    jout, jloss, jgrads, sigma, noise = jside(jm)
    assert len(jm.cond(jctx).features) == 1
    with torch.no_grad():
        out = tm.network(t(tt), t(pts), tm.cond(tctx))
    np.testing.assert_allclose(f32(out), f32(jout), rtol=1e-4, atol=1e-5)
    loss = tm.loss_from(t(pts), t(np.asarray(sigma)), t(np.asarray(noise)), tctx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref, ours = jax_params(jgrads), to_jax_params(tm, grads=True)
    assert set(ours) == set(ref)
    assert any(k.startswith("cond.backbone.stages.2.") for k in ref)
    # at 32 channels in 32 groups each GroupNorm takes out a per-channel
    # shift, so the gradients of what only shifts channels before one (the
    # xyz embed's bias, the MLPs' last biases, the h-side's second AdaGN
    # bias) are zero but for rounding on both sides (2e-8 of the largest)
    gmax = max(float(np.abs(g).max()) for g in ref.values())
    zero = sorted(k for k, g in ref.items() if 0 < np.abs(g).max() < 1e-7 * gmax)
    assert zero == ["network.backbone.layers.broadcast.mlp.layers.1.bias",
                    "network.backbone.layers.broadcast.norm_2.bias_linear.bias",
                    "network.backbone.layers.broadcast.norm_2.bias_linear.weight",
                    "network.backbone.layers.mlp.layers.1.bias", "network.xyz_embed.bias"], zero
    for name, g in ref.items():
        if name in zero:
            assert np.abs(ours[name]).max() < 1e-7 * gmax, name
        elif np.abs(g).max() > 0:
            assert rel_err(ours[name], g) < 2e-4, name
        else:
            assert not np.abs(ours[name]).any(), name
    # the port's weights carried back give the JAX model's leaves
    back = to_jax_params(tm)
    for name, v in jax_params(jm).items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)
