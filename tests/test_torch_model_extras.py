"""The rest of the model against the JAX package, on the CPU: a
non-Gaussian activation on ``folded_pallas`` (the unfused fallbacks),
dropout with the JAX package's masks fed through the port's seam,
``train_in_inference_mode``, ``AdaLN`` and ``layer_norm``, the embeddings,
``gpt_init`` and ``divergence_fn``. The JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.models.embed import LinearTimeEmbedding as JLinearTimeEmbedding
from gecco_tpu.models.gpt_init import gpt_init as jgpt_init
from gecco_tpu.models.mlp import MLP as JMLP
from gecco_tpu.models.normalization import AdaLN as JAdaLN
from gecco_tpu.ops.norms import layer_norm as jlayer_norm
from gecco_tpu.utils import module
from gecco_tpu_torch.convert import load_jax_params, to_jax_params
from gecco_tpu_torch.models import (
    MLP,
    AdaLN,
    LinearSpaceEmbedding,
    LinearTimeEmbedding,
    bernoulli_dropout,
    gpt_init,
)
from gecco_tpu_torch.ops.norms import layer_norm
from gecco_tpu_torch.train import adabelief, make_ema, make_train_step
from gecco_tpu_torch.utils.modules import Linear
from torch_parity import SMALL, f32, j, jax_draws, jax_model, jax_params, t, torch_model

P_DROP = 0.3


@module
class _JSiLU:
    """``jax.nn.silu`` as a module without leaves: the JAX package stacks
    its layers leaf-wise, so an activation must be a pytree."""

    def __call__(self, x):
        return jax.nn.silu(x)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _points(shape, seed=0, scale=0.35):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(a, ref) -> float:
    a, ref = f32(a), f32(ref)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _grads_close(tm, jgrads, tol):
    ref, ours = jax_params(jgrads), to_jax_params(tm, grads=True)
    assert set(ours) == set(ref)
    for name, g in ref.items():
        if np.abs(g).max() > 0:
            assert _rel(ours[name], g) < tol, (name, _rel(ours[name], g))
        else:
            assert not np.abs(ours[name]).any(), name


class _Masks:
    """The port's dropout seam fed the masks that the JAX package draws from
    the loss's network key: per layer the broadcast MLP's, then the
    residual MLP's, one a hidden layer (``SetTransformer``: a key per
    layer; ``BroadcastingLayer``: (bkey, mkey); ``MLP``: a key per hidden
    layer, ``jax.random.bernoulli(k, 1 - p, shape)``)."""

    def __init__(self, loss_key, n_layers, shapes):
        net_key = jax.random.split(loss_key, 4)[3]
        self.masks = []
        for layer_key in jax.random.split(net_key, n_layers):
            for k, shape in zip(jax.random.split(layer_key), shapes):
                (drop_key,) = jax.random.split(k, 1)
                self.masks.append(np.asarray(jax.random.bernoulli(drop_key, 1 - P_DROP, shape)))
        self.pos = 0

    def __call__(self, p_keep, shape):
        assert p_keep == pytest.approx(1 - P_DROP)
        mask = self.masks[self.pos]
        assert tuple(shape) == mask.shape, (shape, mask.shape)
        self.pos += 1
        return torch.from_numpy(mask)


def _with_dropout(jm):
    """The JAX model with dropout in every MLP of its set transformer."""
    backbone = jax.tree.map(lambda m: m.replace(dropout_p=P_DROP) if isinstance(m, JMLP) else m,
                            jm.network.backbone, is_leaf=lambda m: isinstance(m, JMLP))
    return jm.replace(network=jm.network.replace(backbone=backbone))


def _port_dropout(tm):
    for m in tm.modules():
        if isinstance(m, MLP):
            m.dropout_p = P_DROP
    return tm


# ----------------------------------------------------------- activation --


@pytest.mark.parametrize("attn_impl", ["folded_pallas", "xla"])
def test_silu_model_matches_jax(attn_impl):
    """A SiLU set transformer (``jax.nn.silu`` / ``torch.nn.SiLU``, the
    same function in both; GELU is not: ``jax.nn.gelu`` is tanh-approximate
    by default, ``torch.nn.functional.gelu`` exact): on
    ``folded_pallas`` the port no longer refuses it and runs the h-side and
    the residual MLP unfused, the pool resident without a gradient and
    tiled with one; denoise, loss and every gradient against the JAX
    package's, in fp32."""
    jm = jax_model(attn_impl, activation=_JSiLU())
    tm = torch_model(jm, attn_impl, activation=torch.nn.SiLU())
    assert not tm.network.backbone.chains_sums()
    points = _points((2, 128, 3))
    sigma = np.array([0.05, 30.0], np.float32)
    key = jax.random.PRNGKey(3)
    ref, (jloss, jgrads) = jax.jit(lambda m, p, s: (
        m.denoise(s, p), jax.value_and_grad(lambda mm: mm.loss(p, None, key))(m)))(
        jm, jnp.asarray(points), jnp.asarray(sigma))
    with torch.no_grad():
        out = tm.denoise(t(sigma), t(points))
    # fp32 roundings in other orders, which this model's GroupNorms amplify
    # at sigma 30 (measured 5.5e-5 here, 6.3e-5 on the plain path; the
    # Gaussian model's 3.7e-6)
    assert _rel(out, ref) < 2e-4
    draw_sigma, noise = jax_draws(jm, points, key)
    loss = tm.loss_from(t(points), t(draw_sigma), t(noise))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _grads_close(tm, jgrads, 1e-4)


def test_activation_is_each_mlps_own():
    """A module activation is copied into each MLP (each JAX MLP holds its
    own leaf), so the weight bridge moves one alpha per MLP."""
    from gecco_tpu_torch.models import GaussianActivation

    act = GaussianActivation(alpha=1.5, device="cpu")
    tm = torch_model(jax_model("xla"), "xla", activation=act)
    alphas = [m.activation.alpha for m in tm.modules() if isinstance(m, MLP)]
    assert len(alphas) == 2 * SMALL["n_layers"]
    assert len({id(a) for a in alphas}) == len(alphas) and all(a is not act.alpha for a in alphas)


# -------------------------------------------------------------- dropout --


def test_mlp_dropout_matches_jax_masks():
    """The MLP alone (two hidden layers): the JAX MLP's output under a key,
    the port's fed the masks that key draws; and without a mask source the
    port's MLP is the deterministic one."""
    jmlp = JMLP.init(jax.random.PRNGKey(0), 16, 8, 32, depth=2, activation=_JSiLU(),
                     dropout_p=P_DROP)
    mlp = MLP(16, 8, 32, depth=2, activation=torch.nn.SiLU(), dropout_p=P_DROP, device="cpu")
    with torch.no_grad():
        for q, lin in enumerate(jmlp.layers):
            mlp.layers[q].weight.copy_(t(lin.weight))
            mlp.layers[q].bias.copy_(t(lin.bias))
    x = _points((3, 16), scale=1.0)
    key = jax.random.PRNGKey(7)
    masks = [torch.from_numpy(np.asarray(jax.random.bernoulli(k, 1 - P_DROP, (3, 32))))
             for k in jax.random.split(key, 2)]
    fed = iter(masks)
    with torch.no_grad():
        out = mlp(t(x), lambda p_keep, shape: next(fed))
        plain = mlp(t(x))
    np.testing.assert_allclose(f32(out), f32(jmlp(j(x), key=key)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f32(plain), f32(jmlp(j(x))), rtol=1e-5, atol=1e-6)
    assert not np.allclose(f32(out), f32(plain))


@pytest.mark.parametrize("attn_impl,remat", [("folded_pallas", False), ("xla", False),
                                             ("folded_pallas", True)],
                         ids=["fused", "plain", "fused-remat"])
def test_dropout_loss_and_gradients_match_jax(attn_impl, remat):
    """Dropout in every MLP: the JAX loss under its key against the port's
    ``loss_from`` fed that key's sigma, noise and masks (with ``remat`` the
    recomputed layers replay their masks); then the loss and every
    gradient, in fp32."""
    jm = _with_dropout(jax_model(attn_impl, remat=remat))
    tm = _port_dropout(torch_model(jm, attn_impl, remat=remat))
    points = _points((2, 128, 3))
    key = jax.random.PRNGKey(3)
    (jloss, jgrads), jinf = jax.jit(lambda m, p: (
        jax.value_and_grad(lambda mm: mm.loss(p, None, key))(m),
        m.loss(p, None, key, train_in_inference_mode=True)))(jm, jnp.asarray(points))
    draw_sigma, noise = jax_draws(jm, points, key)
    width = 2 * SMALL["feature_dim"]
    masks = _Masks(key, SMALL["n_layers"], [(2, SMALL["num_inducers"], width), (2, 128, width)])
    loss = tm.loss_from(t(points), t(draw_sigma), t(noise), dropout=masks)
    assert masks.pos == len(masks.masks)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _grads_close(tm, jgrads, 1e-4)
    # without masks the loss is the JAX loss in inference mode
    with torch.no_grad():
        inf = tm.loss_from(t(points), t(draw_sigma), t(noise))
    assert abs(float(inf) - float(jinf)) <= 1e-5 * abs(float(jinf))
    assert abs(float(inf) - float(jloss)) > 1e-4 * abs(float(jloss))


def test_train_in_inference_mode_withholds_the_masks():
    """``loss(..., train_in_inference_mode=True)`` and the train step made
    with it draw no masks: the loss of the deterministic network at the
    generator's sigma and noise; without the flag dropout fires."""
    tm = _port_dropout(torch_model(jax_model("folded_pallas")))
    pts = t(_points((2, 128, 3), seed=1))
    gen = lambda: torch.Generator().manual_seed(5)
    sigma, noise = tm.draw_sigma_noise(gen(), pts)
    with torch.no_grad():
        plain = tm.loss_from(pts, sigma, noise)
        assert torch.equal(tm.loss(pts, gen(), train_in_inference_mode=True), plain)
        dropped = tm.loss(pts, gen())
        assert torch.equal(tm.loss(pts, gen()), dropped)
        # the masks come from the generator after sigma and the noise
        g = gen()
        tm.draw_sigma_noise(g, pts)
        again = tm.loss_from(pts, sigma, noise, dropout=bernoulli_dropout(g))
        assert torch.equal(again, dropped)
    assert not torch.equal(dropped, plain)

    for flag, want in ((True, plain), (False, dropped)):
        model = _port_dropout(torch_model(jax_model("folded_pallas")))
        opt = adabelief(0.0)
        step = make_train_step(opt, train_in_inference_mode=flag)
        loss, _ = step(model, make_ema(model), opt.init(list(model.parameters())), pts, gen())
        torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)


def test_likelihood_and_sampling_keep_dropout_off():
    """The likelihood (grad on, no JAX key) and the sampler draw no masks:
    a dropout model gives the same numbers as the model without dropout."""
    jm = jax_model("folded_pallas")
    a = torch_model(jm)
    b = _port_dropout(torch_model(jm))
    data = t(_points((1, 128, 3), seed=2))
    logps = [m.evaluate_logp(torch.Generator().manual_seed(0), data, n_solver_steps=2)
             for m in (a, b)]
    torch.testing.assert_close(logps[0], logps[1], rtol=0, atol=0)
    latent = t(_points((1, 128, 3), seed=3, scale=165.0))
    outs = [m.sample_from_latent(latent, n_solver_steps=2) for m in (a, b)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ------------------------------------------------------ norms, embeddings --


def test_adaln_and_layer_norm_match_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, 64)) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(f32(layer_norm(t(x))), f32(jlayer_norm(j(x))), rtol=1e-5,
                               atol=1e-5)
    xb = t(x, torch.bfloat16)
    assert layer_norm(xb).dtype == torch.bfloat16
    jnorm = JAdaLN.init(jax.random.PRNGKey(0), 64, 1)
    jnorm = jnorm.replace(
        scale_linear=jnorm.scale_linear.replace(weight=j(0.01 * rng.standard_normal((64, 1)))),
        bias_linear=jnorm.bias_linear.replace(weight=j(0.01 * rng.standard_normal((64, 1)))),
    )
    norm = AdaLN(64, 1, device="cpu")
    with torch.no_grad():
        for name in ("scale_linear", "bias_linear"):
            for leaf in ("weight", "bias"):
                norm.get_parameter(f"{name}.{leaf}").copy_(t(getattr(getattr(jnorm, name), leaf)))
    embed = np.array([[0.5], [80.0]], np.float32)
    np.testing.assert_allclose(f32(norm(t(x), t(embed))), f32(jnorm(j(x), j(embed))), rtol=1e-5,
                               atol=1e-5)
    # initialised to the plain layer norm
    fresh = AdaLN(64, 1, device="cpu")
    torch.testing.assert_close(fresh(t(x), t(embed)), layer_norm(t(x)))


def test_embeddings_match_jax():
    jemb = JLinearTimeEmbedding.init(jax.random.PRNGKey(0), 32)
    emb = LinearTimeEmbedding(32, device="cpu", generator=torch.Generator().manual_seed(0))
    assert 0.02 < float(emb.weights.detach().std()) < 0.2
    with torch.no_grad():
        emb.weights.copy_(t(jemb.weights))
    tt = np.array([0.1, 3.0, 160.0], np.float32)
    np.testing.assert_allclose(f32(emb(t(tt))), f32(jemb(j(tt))), rtol=1e-6)
    assert LinearSpaceEmbedding is Linear


def test_gpt_init_matches_jax():
    """On a model built with ``skip_scale=1.0``: the same parameters after
    the JAX ``gpt_init`` and the port's."""
    jm = jax_model("xla", skip_scale=1.0)
    tm = torch_model(jm, "xla", skip_scale=1.0)
    net = jm.network
    jm = jm.replace(network=net.replace(backbone=jgpt_init(net.backbone)))
    assert gpt_init(tm.network.backbone) is tm.network.backbone
    ref, ours = jax_params(jm), to_jax_params(tm)
    for name, value in ref.items():
        np.testing.assert_allclose(ours[name], value, rtol=1e-6, atol=0, err_msg=name)
    assert not any(np.abs(v).any() for k, v in ours.items() if ".mlp." in k and k.endswith("bias"))
    # and the model still loads JAX weights and runs
    load_jax_params(tm, ref)
    with torch.no_grad():
        assert bool(torch.isfinite(tm.denoise(1.0, t(_points((1, 32, 3))))).all())


def test_divergence_fn_matches_jax():
    """The JAX package's ``l1`` divergence (tests/test_parity_extras.py) in
    both: the same loss at the same draws, not the mse loss."""
    jm = jax_model("xla")
    l1 = lambda a, b: torch.abs(a - b).mean(dim=(-2, -1))
    tm = torch_model(jm, "xla")
    tm.divergence_fn = l1
    jm_l1 = jm.replace(divergence_fn=lambda a, b: jnp.abs(a - b).mean(axis=(-2, -1)))
    points = _points((2, 32, 3))
    key = jax.random.PRNGKey(2)
    sigma, noise = jax_draws(jm, points, key)
    with torch.no_grad():
        loss = tm.loss_from(t(points), t(sigma), t(noise))
    jloss = jm_l1.loss(jnp.asarray(points), None, key)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(jloss) - float(jm.loss(jnp.asarray(points), None, key))) > 1e-3
