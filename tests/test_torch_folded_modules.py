"""The module-level folded paths and the inducer cache against the JAX
package, on the CPU, on weights moved with ``gecco_tpu_torch.convert``.

``AttentionPool``, ``Unpool`` and ``Broadcast`` on ``attn_impl="folded"``
(plain folded PyTorch) and ``"folded_pallas"`` (the resident pool and the
flag-free unpool; their plain versions here, the JAX Pallas kernels in
interpret mode there); a ``BroadcastingLayer`` called without channel sums
(the resident pool where no gradient is recorded, the statistics and the
tiled pool with one); and the ``return_h``/``hs`` inducer cache of the set
transformer and the network wrapper. fp32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.models.set_transformer import AttentionPool as JPool
from gecco_tpu.models.set_transformer import Broadcast as JBroadcast
from gecco_tpu.models.set_transformer import Unpool as JUnpool
from gecco_tpu.utils.modules import unstack_module
from gecco_tpu_torch.convert import load_jax_params
from gecco_tpu_torch.models.set_transformer import AttentionPool, Broadcast, Unpool
from torch_parity import SMALL, f32, j, jax_model, jax_params, perturb, t, torch_model

B, N, C, HEADS, I = 2, 128, 64, 4, 16
# forward: the JAX package's own folded-path tolerance (test_pallas_ops.py)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _close(port, ref, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(f32(port), f32(ref), rtol=rtol, atol=atol, err_msg=what)


def _modules(name):
    """The JAX module (moved off its identity-like init) and the port's on
    its weights; the call's array arguments beside the module."""
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    if name == "pool":
        jm, tm, extra = JPool.init(key, C, HEADS, I), AttentionPool(C, HEADS, I, device="cpu"), ()
    elif name == "unpool":
        jm, tm = JUnpool.init(key, C, HEADS), Unpool(C, HEADS, device="cpu")
        extra = (rng.standard_normal((B, I, C)).astype(np.float32),)
    else:
        jm = perturb(JBroadcast.init(key, C, I, 1, num_heads=HEADS), 2)
        tm = Broadcast(C, I, 1, HEADS, device="cpu")
        extra = (np.array([[0.3], [40.0]], np.float32),)
    return jm, load_jax_params(tm, jax_params(jm)), (x, *extra)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _jax_value_and_grad(loss, module, x):
    """``loss(module, x) -> (scalar, output)``: the output and the
    gradients for the module and x, in one jitted call (one compile of the
    interpret-mode kernels instead of one per eager op)."""
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(module, x)
    return out, grads


@pytest.mark.parametrize("impl", ["folded", "folded_pallas"])
@pytest.mark.parametrize("name", ["pool", "unpool", "broadcast"])
def test_module_level_folded_paths_match_jax(name, impl):
    """Forward, and the gradients of (out^2).sum() for every parameter and
    for x, against the same JAX module on the same path; gradients at
    rtol 1e-3, atol 1e-4 (the JAX package's folded gradient test holds
    2e-3 / 2e-4 between two paths; here the path is the same)."""
    jm, tm, args = _modules(name)
    targs = [t(a).requires_grad_(q == 0) for q, a in enumerate(args)]
    out = tm(*targs, attn_impl=impl)
    (_first(out) ** 2).sum().backward()

    def loss(m, xx):
        ref = m(xx, *map(j, args[1:]), attn_impl=impl)
        return (_first(ref) ** 2).sum(), ref

    ref, (gm, gx) = _jax_value_and_grad(loss, jm, j(args[0]))
    _close(_first(out), _first(ref), what="out")
    if name == "broadcast":
        _close(out[1], ref[1], what="h")
    _close(targs[0].grad, gx, 1e-3, 1e-4, "x")
    grads = jax_params(gm)
    for pname, p in tm.named_parameters():
        _close(p.grad, grads[pname], 1e-3, 1e-4, pname)


def _layer_pair():
    jm = jax_model("folded_pallas")
    tm = torch_model(jm, "folded_pallas")
    return unstack_module(jm.network.backbone.layers, 0), tm.network.backbone.layers[0]


def test_sumsless_layer_matches_jax():
    """A fused layer called without channel sums: under ``torch.no_grad``
    the port takes the resident pool (its plain version here), as the JAX
    layer without a key does (its ``_pool_kernel``); with a gradient the
    port takes the statistics and the tiled pool, the JAX layer still the
    resident pool and its ``_pool_bwd_kernel``: the gradients of
    (out^2).sum() for every parameter and for x at rtol 1e-3, atol 1e-4."""
    jlayer, layer = _layer_pair()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 128, SMALL["feature_dim"])).astype(np.float32)
    embed = np.array([[0.3], [40.0]], np.float32)

    def loss(lyr, xx):
        ref = lyr(xx, j(embed), attn_impl="folded_pallas")
        return (ref[0] ** 2).sum(), ref

    jout, (gl, gx) = _jax_value_and_grad(loss, jlayer, j(x))
    with torch.no_grad():
        out, h, sums = layer(t(x), t(embed), "folded_pallas")
    _close(out, jout[0], what="out")
    _close(h, jout[1], what="h")
    np.testing.assert_allclose(f32(sums), f32((lambda o: np.stack(
        [o.sum(1), (o * o).sum(1)], 1))(f32(jout[0]).astype(np.float64))), rtol=1e-4, atol=1e-3)

    xt = t(x).requires_grad_(True)
    out, _, _ = layer(xt, t(embed), "folded_pallas")
    (out ** 2).sum().backward()
    _close(xt.grad, gx, 1e-3, 1e-4, "x")
    grads = jax_params(gl)
    for pname, p in layer.named_parameters():
        _close(p.grad, grads[pname], 1e-3, 1e-4, pname)


@pytest.mark.parametrize("attn_impl", ["xla", "folded_pallas"])
def test_inducer_cache_matches_jax(attn_impl):
    """``return_h=True`` gives the layers' inducer tokens [L, B, I, C], and
    the cached forward ``hs=...`` (pool side skipped; on the fused path the
    unpool k/v hoisted) on more points, against the JAX set transformer
    (as test_pallas_ops.py's cached path) and through the network wrapper."""
    jm = jax_model(attn_impl)
    tm = torch_model(jm, attn_impl)
    jst, st = jm.network.backbone, tm.network.backbone
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 128, SMALL["feature_dim"])).astype(np.float32)
    embed = np.array([[0.05], [60.0]], np.float32)
    x2 = rng.standard_normal((2, 256, SMALL["feature_dim"])).astype(np.float32)
    pts = rng.standard_normal((2, 128, 3)).astype(np.float32)
    tt = np.array([0.05, 60.0], np.float32)
    pts2 = rng.standard_normal((2, 256, 3)).astype(np.float32)

    def jax_side(st_, net):
        """Every JAX call of the test, in one jitted call."""
        out_, hs_ = st_(j(x), j(embed), return_h=True)
        y_, cache_ = net(j(tt), j(pts), return_h=True)
        return (out_, hs_, st_(j(x2), j(embed), hs=hs_), y_, cache_,
                net(j(tt), j(pts2), hs=cache_))

    jout, jhs, jcached, jy, jcache, jy2 = jax.jit(jax_side)(jst, jm.network)
    out, hs = st(t(x), t(embed), return_h=True)
    assert hs.shape == (SMALL["n_layers"], 2, SMALL["num_inducers"], SMALL["feature_dim"])
    _close(out, jout)
    _close(hs, jhs)
    _close(st(t(x2), t(embed), hs=t(f32(jhs))), jcached)

    y, cache = tm.network(t(tt), t(pts), return_h=True)
    _close(y, jy, 1e-4, 1e-4)
    _close(cache, jcache, 1e-4, 1e-4)
    _close(tm.network(t(tt), t(pts2), hs=cache), jy2, 1e-4, 1e-4)
