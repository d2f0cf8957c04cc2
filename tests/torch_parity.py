"""Helpers for the parity tests of the PyTorch port against the JAX package.

Both sides get the same weights (the JAX model's, moved with
``gecco_tpu_torch.convert``) and the same numpy inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gecco_tpu import Diffusion as JDiffusion
from gecco_tpu import GaussianReparam as JGaussianReparam
from gecco_tpu import LogUniformSchedule as JLogUniformSchedule
from gecco_tpu import UVLReparam as JUVLReparam
from gecco_tpu.models import ConvNeXtExtractor as JConvNeXtExtractor
from gecco_tpu.models import RayNetwork as JRayNetwork
from gecco_tpu.models import SetTransformer as JSetTransformer
from gecco_tpu.models import UnconditionalPointNetwork as JNetwork
from gecco_tpu.utils import Frozen as JFrozen
from gecco_tpu_torch import Diffusion, GaussianReparam, LogUniformSchedule, UVLReparam
from gecco_tpu_torch.convert import load_jax_params
from gecco_tpu_torch.models import (
    ConvNeXtExtractor,
    RayNetwork,
    SetTransformer,
    UnconditionalPointNetwork,
)
from gecco_tpu_torch.utils import Frozen

# small shapes: 2 layers, C 64, 4 heads, 16 inducers; N a multiple of 128
SMALL = dict(n_layers=2, feature_dim=64, num_inducers=16, num_heads=4)
SIGMA_MAX = 165.0
# the ConvNeXt-tiny pyramid's channels (configs/shapenet_vol_conditional.py)
CTX_DIMS = (96, 192, 384)


def path_name(path) -> str:
    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.GetAttrKey):
            parts.append(k.name)
        elif isinstance(k, jax.tree_util.SequenceKey):
            parts.append(str(k.idx))
        elif isinstance(k, jax.tree_util.DictKey):
            parts.append(str(k.key))
        else:
            raise TypeError(f"unexpected pytree key {k!r}")
    return ".".join(parts)


def jax_params(tree) -> dict:
    """{dotted path: numpy array} of a JAX module pytree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_name(p): np.asarray(v) for p, v in leaves}


def perturb(tree, seed: int):
    """Move the JAX model off its identity-like init so every parameter
    matters: AdaGN embed weights become non-zero (scaled for sigma up to
    165), each activation's alpha leaves 1 and each ConvNeXt block's layer
    scale leaves 1e-6."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        name = path_name(path)
        if name.endswith(("scale_linear.weight", "bias_linear.weight")):
            return leaf + jnp.asarray(0.002 * rng.standard_normal(leaf.shape), leaf.dtype)
        if name.endswith("activation.alpha"):
            return leaf + jnp.asarray(0.2 * rng.standard_normal(leaf.shape), leaf.dtype)
        if name.endswith("layer_scale"):
            return leaf + jnp.asarray(0.3 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(f, tree)


def jax_model(attn_impl="folded_pallas", dtype=jnp.float32, n_steps=4, seed=0, **kw):
    shape = {**SMALL, **kw}
    bk, nk = jax.random.split(jax.random.PRNGKey(seed))
    backbone = JSetTransformer.init(
        bk, embed_dim=1, compute_dtype=dtype, attn_impl=attn_impl, **shape
    )
    net = JNetwork.init(nk, backbone, feature_dim=shape["feature_dim"])
    sched = JLogUniformSchedule(sigma_max=SIGMA_MAX, sigma_min=0.002, n_solver_steps=n_steps)
    model = JDiffusion.init(net, sched, reparam=JGaussianReparam.init([0.1, -0.2, 0.05], [0.35, 0.3, 0.4]))
    return perturb(model, seed)


def torch_model(jmodel, attn_impl="folded_pallas", dtype=torch.float32, n_steps=4, **kw):
    """The port's Diffusion at the same shapes, on the CPU, loaded with the
    JAX model's weights."""
    shape = {**SMALL, **kw}
    gen = torch.Generator().manual_seed(0)
    backbone = SetTransformer(
        embed_dim=1, compute_dtype=dtype, attn_impl=attn_impl, device="cpu", generator=gen, **shape
    )
    net = UnconditionalPointNetwork(backbone, shape["feature_dim"], device="cpu", generator=gen)
    sched = LogUniformSchedule(sigma_max=SIGMA_MAX, sigma_min=0.002, n_solver_steps=n_steps)
    model = Diffusion(net, sched, reparam=GaussianReparam([0.0] * 3, [1.0] * 3, device="cpu"))
    return load_jax_params(model, jax_params(jmodel))


def jax_conditional_model(attn_impl="folded_pallas", lookup_impl="pallas", dtype=jnp.float32,
                          n_steps=4, seed=0, remat=False, frozen=False, **kw):
    """The image-conditional model of ``configs/shapenet_vol_conditional.py``
    at small backbone shapes: UVL reparam, ConvNeXt-tiny pyramid, RayNetwork."""
    shape = {**SMALL, **kw}
    bk, nk, ck = jax.random.split(jax.random.PRNGKey(seed), 3)
    reparam = JUVLReparam.init()
    backbone = JSetTransformer.init(
        bk, embed_dim=1, compute_dtype=dtype, attn_impl=attn_impl, remat=remat, **shape
    )
    net = JRayNetwork.init(nk, backbone, reparam, feature_dim=shape["feature_dim"],
                           input_ctx_dim=sum(CTX_DIMS), lookup_impl=lookup_impl)
    cond = JConvNeXtExtractor.init(ck, size="tiny", mode="local", compute_dtype=dtype)
    if frozen:
        cond = JFrozen(inner=cond)
    sched = JLogUniformSchedule(sigma_max=SIGMA_MAX, sigma_min=0.002, n_solver_steps=n_steps)
    return perturb(JDiffusion.init(net, sched, reparam=reparam, cond=cond), seed)


def torch_conditional_model(jmodel, attn_impl="folded_pallas", lookup_impl="pallas",
                            dtype=torch.float32, n_steps=4, remat=False, frozen=False, **kw):
    """The port's image-conditional model on the CPU, loaded with the JAX
    model's weights."""
    shape = {**SMALL, **kw}
    gen = torch.Generator().manual_seed(0)
    reparam = UVLReparam(device="cpu")
    backbone = SetTransformer(embed_dim=1, compute_dtype=dtype, attn_impl=attn_impl, remat=remat,
                              device="cpu", generator=gen, **shape)
    net = RayNetwork(backbone, reparam, shape["feature_dim"], sum(CTX_DIMS),
                     lookup_impl=lookup_impl, device="cpu", generator=gen)
    cond = ConvNeXtExtractor(dtype, device="cpu", generator=gen)
    if frozen:
        cond = Frozen(cond)
    sched = LogUniformSchedule(sigma_max=SIGMA_MAX, sigma_min=0.002, n_solver_steps=n_steps)
    model = Diffusion(net, sched, reparam=reparam, cond=cond)
    return load_jax_params(model, jax_params(jmodel))


def jax_draws(jmodel, points, key) -> tuple:
    """The sigma and noise that ``gecco_tpu.Diffusion.loss`` draws from
    ``key`` (sigma from the first of four keys, the noise from the second),
    as numpy arrays for the port's ``loss_from``."""
    sigma_key, noise_key, _, _ = jax.random.split(key, 4)
    sigma = jmodel.schedule.sample_sigma(sigma_key, points.shape[0])
    x = jmodel.reparam.data_to_diffusion(jnp.asarray(points), None)
    return np.asarray(sigma), np.asarray(jax.random.normal(noise_key, x.shape, x.dtype))


def t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(a, ref) -> float:
    """max |a - ref| / max |ref|."""
    a, ref = f32(a), f32(ref)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))
