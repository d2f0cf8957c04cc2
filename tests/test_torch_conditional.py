"""The port's image-conditional model against the JAX package's, on the CPU.

The model is ``configs/shapenet_vol_conditional.py``'s (UVL reparam,
ConvNeXt-tiny pyramid, ``RayNetwork`` over the set transformer) with a small
backbone (2 layers, C 64, 4 heads, 16 inducers), 64x64 images and 128
points. Both sides get the same weights (moved with
``gecco_tpu_torch.convert``) and the same numpy inputs; the JAX side runs
its projective gather (``lookup_impl="pallas"``) and its folded attention
(``attn_impl="folded_pallas"``) as Pallas kernels in interpret mode. The
JAX loss draws sigma and the noise from its key; the tests rebuild the same
draws from the same key split and hand them to the port's ``loss_from``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gecco_tpu import geometry as jgeometry
from gecco_tpu.ops import projective as jprojective
from gecco_tpu.ops.pallas.projective_gather import bilinear_lookup_pallas
from gecco_tpu.train.trainer import make_train_step as jmake_train_step
from gecco_tpu.types import Context3d as JContext3d
from gecco_tpu_torch import Context3d, geometry
from gecco_tpu_torch.convert import load_jax_params, to_jax_params
from gecco_tpu_torch.data import CAMERA_K, make_conditional_batch
from gecco_tpu_torch.ops import projective
from gecco_tpu_torch.ops.kernels import projective_gather, projective_gather_bwd
from gecco_tpu_torch.ops.kernels.projective_gather import _gather_bwd_binned_ref
from gecco_tpu_torch.train import conditional_optimizer, make_ema, make_train_step
from torch_parity import (
    GATHER_COORDS,
    f32,
    gather_coords,
    j,
    jax_conditional_model,
    jax_params,
    rel_err,
    t,
    torch_conditional_model,
)

B, N, IMAGE = 2, 128, 64
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _jax_model(**kw):
    return jax_conditional_model(**kw)


def _models(attn_impl="folded_pallas", lookup_impl="pallas", bf16=False, **kw):
    jm = _jax_model(attn_impl=attn_impl, lookup_impl=lookup_impl,
                    dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    tm = torch_conditional_model(jm, attn_impl, lookup_impl,
                                 torch.bfloat16 if bf16 else torch.float32, **kw)
    return jm, tm


def _batch(seed=0, b=B):
    """Points in the camera frustum, images and cameras -> numpy, and the
    contexts of both sides."""
    pts, images, K = make_conditional_batch(np.random.default_rng(seed), b, N, IMAGE)
    return (pts, JContext3d(image=jnp.asarray(images), K=jnp.asarray(K)),
            Context3d(image=t(images), K=t(K)))


def _jax_draws(jm, points, jctx, key):
    """The sigma and noise that ``gecco_tpu.Diffusion.loss`` draws from ``key``."""
    sigma_key, noise_key, _, _ = jax.random.split(key, 4)
    x = jm.reparam.data_to_diffusion(jnp.asarray(points), jctx)
    sigma = jm.schedule.sample_sigma(sigma_key, points.shape[0])
    return np.asarray(sigma), np.asarray(jax.random.normal(noise_key, x.shape, x.dtype))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(f32(port), f32(ref), rtol=rtol, atol=atol)


# ------------------------------------------------------ geometry, reparam --


def test_conditional_batch_lies_in_the_camera_frustum():
    pts, images, K = make_conditional_batch(np.random.default_rng(1), 3, 256, 32)
    assert pts.shape == (3, 256, 3) and images.shape == (3, 32, 32, 3) and K.shape == (3, 3, 3)
    assert pts.dtype == images.dtype == K.dtype == np.float32
    np.testing.assert_array_equal(K[2], CAMERA_K)
    assert pts[..., 2].min() > 1.4
    wh = f32(geometry.project_points(t(pts), t(K)[:, None]))
    assert wh.min() > 0.0 and wh.max() < 1.0
    again = make_conditional_batch(np.random.default_rng(1), 3, 256, 32)
    for a, b in zip(again, (pts, images, K)):
        np.testing.assert_array_equal(a, b)


def test_geometry_and_uvl_maps_match_jax():
    jm, tm = _models("xla", "xla")
    pts, jctx, tctx = _batch(2)
    Kj, Kt = jctx.K[:, None], tctx.K[:, None]
    rel = dict(rtol=1e-5, atol=1e-6)
    _close(geometry.project_points(t(pts), Kt), jgeometry.project_points(j(pts), Kj), **rel)
    depth = np.linalg.norm(pts, axis=-1)
    wh = np.asarray(jgeometry.project_points(j(pts), Kj))
    _close(geometry.unproject_points(t(wh), t(depth), Kt),
           jgeometry.unproject_points(j(wh), j(depth), Kj), **rel)
    # the dehomogenisation guard: |z| <= eps divides by 1
    flat = np.array([[[0.3, -0.2, 0.0], [0.1, 0.4, 1e-9], [0.2, 0.1, -2.0]]], np.float32)
    _close(geometry.project_points(t(flat), t(CAMERA_K)),
           jgeometry.project_points(j(flat), j(CAMERA_K)), **rel)

    rp, jrp = tm.reparam, jm.reparam
    hwd = jrp.xyz_to_hwd(j(pts), jctx.K)
    _close(rp.xyz_to_hwd(t(pts), tctx.K), hwd, **rel)
    _close(rp.hwd_to_xyz(t(hwd), tctx.K), jrp.hwd_to_xyz(hwd, jctx.K), **rel)
    uvl = jrp.hwd_to_uvl(hwd)
    _close(rp.hwd_to_uvl(t(hwd)), uvl, **rel)
    _close(rp.uvl_to_hwd(t(uvl)), jrp.uvl_to_hwd(uvl), **rel)
    diff = jrp.data_to_diffusion(j(pts), jctx)
    _close(rp.data_to_diffusion(t(pts), tctx), diff, **rel)
    _close(rp.diffusion_to_data(t(diff), tctx), jrp.diffusion_to_data(diff, jctx), **rel)
    _close(rp.diffusion_to_data(t(diff), tctx), pts, rtol=1e-4, atol=1e-5)
    _close(rp.diffusion_to_hw(t(diff), tctx.K), jrp.diffusion_to_hw(diff, jctx.K), **rel)
    assert not any(b.requires_grad for b in rp.buffers())


# ------------------------------------------------------------------ lookup --


# odd level sizes; the pyramid of the dataset's 137x137 renders (34^2, 17^2,
# 8^2) at narrow widths; one with non-square levels
PYRAMIDS = {
    "odd": ((17, 17, 8), (8, 8, 16)),
    "137-renders": ((34, 34, 8), (17, 17, 16), (8, 8, 32)),
    "non-square": ((12, 20, 6), (5, 3, 4)),
}


def _pyramid(seed, pyramid):
    """Levels [B, H, W, C] and hw01 [B, 64, 2] in [-0.1, 1.1], so that
    corners fall outside the image on every side."""
    rng = np.random.default_rng(seed)
    levels = [rng.standard_normal((B, h, w, c)).astype(np.float32) for h, w, c in PYRAMIDS[pyramid]]
    hw01 = rng.uniform(-0.1, 1.1, (B, 64, 2)).astype(np.float32)
    return levels, hw01


@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
def test_lookup_matches_both_jax_forms(pyramid):
    """Coordinates in [-0.1, 1.1] so that corners fall outside the image:
    the plain lookup and the gather wrapper against the JAX XLA form and
    its Pallas kernel (interpret mode)."""
    levels, hw01 = _pyramid(0, pyramid)
    jl = [j(lv) for lv in levels]
    refs = (jprojective.lookup_pyramid(jl, j(hw01), impl="xla"),
            jprojective.lookup_pyramid(jl, j(hw01), impl="pallas"))
    for impl in ("xla", "pallas"):
        out = projective.lookup_pyramid([t(lv) for lv in levels], t(hw01), impl=impl)
        assert out.shape == (B, 64, sum(lv.shape[-1] for lv in levels))
        for ref in refs:
            _close(out, ref)
    coords = hw01 * np.array(levels[0].shape[1:3], np.float32)
    _close(projective.bilinear_lookup(t(levels[0]), t(coords)),
           jprojective.bilinear_lookup(jl[0], j(coords)))
    with pytest.raises(ValueError):
        projective.lookup_pyramid([t(levels[0])], t(hw01), impl="cuda")


@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_lookup_gradients_match_jax(impl, pyramid):
    """Gradients in every level and the coordinates against ``jax.grad`` of
    ``bilinear_lookup_pallas`` (its backward kernel in interpret mode), at
    the JAX test's rtol/atol 1e-4."""
    levels, hw01 = _pyramid(1, pyramid)
    rng = np.random.default_rng(2)
    g = rng.standard_normal((B, 64, sum(lv.shape[-1] for lv in levels))).astype(np.float32)

    def jloss(hw, *lvs):
        outs = [bilinear_lookup_pallas(lv, hw * jnp.array(lv.shape[1:3], jnp.float32))
                for lv in lvs]
        return (jnp.concatenate(outs, -1) * j(g)).sum()

    ref = jax.grad(jloss, argnums=tuple(range(1 + len(levels))))(j(hw01), *(j(lv) for lv in levels))
    leaves = [t(hw01).requires_grad_(True)] + [t(lv).requires_grad_(True) for lv in levels]
    out = projective.lookup_pyramid(leaves[1:], leaves[0], impl=impl)
    (out * t(g)).sum().backward()
    for a, r in zip(leaves, ref):
        np.testing.assert_allclose(f32(a.grad), f32(r), rtol=1e-4, atol=1e-4)


@jax.jit
def _jax_lookup_grads(hw01, g, *levels):
    """``jax.grad`` of the gather through ``bilinear_lookup_pallas`` (its
    backward kernel in interpret mode) in every level and the coordinates,
    one jit for all coordinate sets."""
    def loss(hw, *lvs):
        outs = [bilinear_lookup_pallas(lv, hw * jnp.array(lv.shape[1:3], jnp.float32))
                for lv in lvs]
        return (jnp.concatenate(outs, -1) * g).sum()

    return jax.grad(loss, argnums=tuple(range(1 + len(levels))))(hw01, *levels)


@pytest.mark.parametrize("coords", GATHER_COORDS)
def test_gather_bwd_binned_ref_matches_jax(coords):
    """The Hopper backward's algebra in plain PyTorch
    (``_gather_bwd_binned_ref``: a stable bin by floor cell, each pixel the
    sum over its four neighbouring cells' points, the coordinate gradient
    per point) against ``jax.grad`` of ``bilinear_lookup_pallas``, in fp32,
    at the JAX test's rtol/atol 1e-4, on each coordinate set of the renders'
    pyramid. The JAX backward kernel forms its weights as products with
    one-hot masks, so a NaN coordinate puts NaN into its dF and coordinate
    gradients: on the outside set it gets the same points with NaN swapped
    for 1e9 (which,
    like NaN, has no corner in the image), and the port's NaN points are
    held to contributing nothing (dF the same as with 1e9, their
    coordinate gradient 0)."""
    levels, _ = _pyramid(3, "137-renders")
    rng = np.random.default_rng(4)
    hw01 = gather_coords(coords, rng, B, 64, levels[0].shape[1:3])
    g = rng.standard_normal((B, 64, sum(lv.shape[-1] for lv in levels))).astype(np.float32)
    jax_hw01 = np.where(np.isnan(hw01), np.float32(1e9), hw01)
    ref = _jax_lookup_grads(j(jax_hw01), j(g), *(j(lv) for lv in levels))
    tl = [t(lv) for lv in levels]
    dhw, dlevels = _gather_bwd_binned_ref(tl, t(hw01), t(g))
    for a, r in zip([dhw, *dlevels], ref):
        np.testing.assert_allclose(f32(a), f32(r), rtol=1e-4, atol=1e-4)
    if coords == "outside":
        assert np.isnan(hw01).any()
        again, dlevels_1e9 = _gather_bwd_binned_ref(tl, t(jax_hw01), t(g))
        for a, r in zip(dlevels, dlevels_1e9):
            torch.testing.assert_close(a, r, rtol=0, atol=0)
        assert (f32(dhw)[np.isnan(hw01).any(-1)] == 0).all()


# ---------------------------------------------------------------- ConvNeXt --


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_convnext_pyramid_matches_jax(uint8):
    jm, tm = _models("xla", "xla")
    rng = np.random.default_rng(4)
    if uint8:
        images = rng.integers(0, 256, (B, IMAGE, IMAGE, 3), dtype=np.uint8)
        jimg, timg = jnp.asarray(images), torch.from_numpy(images)
    else:
        images = rng.uniform(size=(B, IMAGE, IMAGE, 3)).astype(np.float32)
        jimg, timg = j(images), t(images)
    K = np.broadcast_to(CAMERA_K, (B, 3, 3)).copy()
    ref = jm.cond(JContext3d(image=jimg, K=j(K)))
    ours = tm.cond(Context3d(image=timg, K=t(K)))
    assert len(ours.features) == 3
    for a, r in zip(ours.features, ref.features):
        assert a.shape == r.shape and a.is_contiguous()
        np.testing.assert_allclose(f32(a), f32(r), rtol=1e-4, atol=1e-4)
    assert ours.K is not None and ours.wmat == ()


# ------------------------------------------------------------- RayNetwork --


@pytest.mark.parametrize(
    "attn_impl,bf16,tol",
    [
        # fp32: the same function on both sides (measured 1.3e-6)
        ("folded_pallas", False, 1e-4),
        ("xla", False, 1e-4),
        # bf16 pyramid and activations: the JAX kernel rounds its one-hot
        # weights to bf16 before its product, the port's plain version each
        # corner's product; both frameworks round and sum in other orders
        # through the ConvNeXt and 2 layers (a few bf16 steps, 2^-8)
        ("folded_pallas", True, 3e-2),
    ],
    ids=["fused-fp32", "plain-fp32", "fused-bf16"],
)
def test_ray_network_matches_jax(attn_impl, bf16, tol):
    lookup_impl = "pallas" if attn_impl == "folded_pallas" else "xla"
    jm, tm = _models(attn_impl, lookup_impl, bf16)
    pts, jctx, tctx = _batch(5)
    x = np.asarray(jm.reparam.data_to_diffusion(j(pts), jctx))
    tt = np.array([0.05, 60.0], np.float32)
    ref = jm.network(j(tt), j(x), jm.cond(jctx))
    ours = tm.network(t(tt), t(x), tm.cond(tctx))
    assert ours.dtype == torch.float32 and ours.shape == (B, N, 3)
    assert rel_err(ours, ref) < tol


# ------------------------------------------------------- loss, train step --


def test_conditional_loss_and_gradients_match_jax():
    """Loss and the gradient of every parameter, ConvNeXt included, from
    the sigma and noise that JAX draws; the reparam's statistics (both of
    the JAX pytree's paths) take none."""
    jm, tm = _models()
    pts, jctx, tctx = _batch(6)
    key = jax.random.PRNGKey(3)
    jloss, jgrads = jax.value_and_grad(lambda m: m.loss(j(pts), jctx, key))(jm)
    sigma, noise = _jax_draws(jm, pts, jctx, key)
    loss = tm.loss_from(t(pts), t(sigma), t(noise), tctx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref, ours = jax_params(jgrads), to_jax_params(tm, grads=True)
    assert set(ours) == set(ref)
    assert any(k.startswith("cond.backbone.stages.2.") for k in ref)
    for name, g in ref.items():
        if np.abs(g).max() > 0:
            # fp32 on both sides (measured 3.7e-5 at worst)
            assert rel_err(ours[name], g) < 2e-4, name
        else:
            assert "reparam" in name and not np.abs(ours[name]).any(), name


def test_conditional_train_step_matches_jax():
    """One step of the port's train step with ``conditional_optimizer()``
    (clip 1, AdaBelief at a constant 3e-4) against ``make_train_step`` with
    the same optax chain, from the same weights, batch, sigma and noise:
    loss, parameters and EMA at fp32 tolerance."""
    jm, tm = _models()
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adabelief(learning_rate=3e-4))
    opt = conditional_optimizer()
    jstep = jmake_train_step(jopt, ema_alpha=0.999, donate=False)
    step = make_train_step(opt, ema_alpha=0.999)
    jema, jstate = jax.tree.map(jnp.copy, jm), jopt.init(jm)
    ema, state = make_ema(tm), opt.init(list(tm.parameters()))
    start = jax_params(jm)
    pts, jctx, tctx = _batch(7)
    key = jax.random.PRNGKey(21)
    sigma, noise = _jax_draws(jm, pts, jctx, key)
    jloss, jm, jema, jstate = jstep(jm, jema, jstate, j(pts), jctx, key)
    loss, state = step(tm, ema, state, t(pts), sigma=t(sigma), noise=t(noise), raw_ctx=tctx)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref_p, ref_e = jax_params(jm), jax_params(jema)
    ours_p, ours_e = to_jax_params(tm), to_jax_params(ema)
    # AdaBelief's first update is about lr * g / sqrt(0.81 g^2 + 1e-13): for
    # a gradient near 3e-7, where the two frameworks' fp32 sums differ most
    # relative to it, the update moves by a fraction of lr (measured 1.7e-5,
    # 0.06 lr, on one element of the ConvNeXt stem)
    moved = 0
    for name in ref_p:
        np.testing.assert_allclose(ours_p[name], ref_p[name], rtol=1e-4, atol=5e-5, err_msg=name)
        np.testing.assert_allclose(ours_e[name], ref_e[name], rtol=1e-4, atol=5e-8, err_msg=name)
        moved += not np.array_equal(ref_p[name], start[name])
    # all but the reparam's mean and std, under both paths
    assert moved == len(ref_p) - 4


def test_remat_gives_the_same_gradients():
    """``remat=True`` recomputes each layer in the backward: the same loss
    and gradients as without it, from the same weights and draws."""
    _, plain = _models()
    _, remat = _models(remat=True)
    assert remat.network.backbone.remat and not plain.network.backbone.remat
    pts, _, tctx = _batch(8)
    sigma, noise = plain.draw_sigma_noise(torch.Generator().manual_seed(0), t(pts))
    for m in (plain, remat):
        m.loss_from(t(pts), sigma, noise, tctx).backward()
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=1e-6, atol=1e-9, msg=name)


def test_frozen_conditioner_stays_unchanged_through_a_step():
    """``Frozen`` (``GECCO_FREEZE_CONDITIONER``): the ConvNeXt's parameters
    take no gradient and stay as they were through a train step, as in the
    JAX package's stop-gradient, while the network moves."""
    _, tm = _models(frozen=True)
    pts, _, tctx = _batch(9)
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    opt = conditional_optimizer()
    state = opt.init(list(tm.parameters()))
    step = make_train_step(opt)
    loss, state = step(tm, make_ema(tm), state, t(pts), torch.Generator().manual_seed(1),
                       raw_ctx=tctx)
    assert bool(torch.isfinite(loss))
    after = tm.state_dict()
    cond_keys = [k for k in before if k.startswith("cond.inner.backbone.")]
    assert cond_keys and all(torch.equal(before[k], after[k]) for k in cond_keys)
    assert not torch.equal(before["network.xyz_embed.weight"], after["network.xyz_embed.weight"])


# ---------------------------------------------------------------- sampler --


@pytest.mark.parametrize("n", [1, 2])
def test_conditional_sample_matches_jax(n):
    """A sample from the JAX sampler's latent, in diffusion space; ``n=2``
    draws two samples per image from one run of the conditioner."""
    jm, tm = _models()
    _, jctx, tctx = _batch(10)
    shape = (B * n, N, 3)
    details = jm.sample(jax.random.PRNGKey(7), shape, raw_ctx=jctx, return_details=True, n=n)
    ours = tm.sample_from_latent(t(details.latent), raw_ctx=tctx, return_details=True, n=n)
    # fp32: 6 evaluations through 2 layers from sigma 165 (measured 1e-5)
    assert rel_err(ours.sample_diff, details.sample_diff) < 1e-4
    assert rel_err(ours.sample_data, details.sample_data) < 1e-3
    assert ours.sample_data.shape == shape and ours.sample_data.grad_fn is None


def test_sample_runs_the_conditioner_once():
    """``sample`` runs the conditioner once per call, takes a precomputed
    ``ctx`` instead, and refuses both."""
    _, tm = _models()
    _, _, tctx = _batch(11)
    calls = []
    tm.cond.register_forward_hook(lambda *a: calls.append(1))
    latent = 165.0 * torch.randn(B * 2, N, 3, generator=torch.Generator().manual_seed(0))
    a = tm.sample_from_latent(latent, raw_ctx=tctx, n_solver_steps=3, n=2)
    assert len(calls) == 1
    b = tm.sample_from_latent(latent, ctx=tm.cond(tctx), n_solver_steps=3, n=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = tm.sample(torch.Generator().manual_seed(1), (B, N, 3), raw_ctx=tctx, n_solver_steps=2,
                    return_details=True)
    assert len(calls) == 3
    assert out.sample_diff.shape == (B, N, 3) and bool(torch.isfinite(out.sample_diff).all())
    with pytest.raises(ValueError):
        tm.sample_from_latent(latent, raw_ctx=tctx, ctx=tm.cond(tctx))


# --------------------------------------------------------- weight bridge --


@pytest.mark.parametrize("frozen", [False, True], ids=["trained", "frozen"])
def test_conditional_weights_round_trip(frozen):
    """JAX -> port -> JAX is exact: the stacked ConvNeXt stages, the HWIO
    convolution kernels and both of the reparam's paths. A duplicate leaf
    that differs from the one it duplicates is refused."""
    jm, tm = _models(frozen=frozen)
    ref, ours = jax_params(jm), to_jax_params(tm)
    assert set(ours) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name], f32(ref[name]), err_msg=name)
    prefix = "cond.inner.backbone" if frozen else "cond.backbone"
    assert ours[f"{prefix}.stages.2.dw_kernel"].shape == (9, 7, 7, 1, 384)
    assert ours[f"{prefix}.stem_kernel"].shape == (4, 4, 3, 96)
    assert ours[f"{prefix}.downs.1.kernel"].shape == (2, 2, 192, 384)
    assert "network.reparam.uvl_std" in ours and "reparam.uvl_std" in ours
    assert sum(k.endswith("uvl_std") for k, _ in tm.named_buffers()) == 1
    bad = dict(ref, **{"network.reparam.uvl_std": ref["network.reparam.uvl_std"] + 1.0})
    with pytest.raises(ValueError, match="duplicates"):
        load_jax_params(tm, bad)
    other = torch_conditional_model(_jax_model(seed=1, frozen=frozen), frozen=frozen)
    load_jax_params(other, ours)
    for (name, a), b in zip(other.state_dict().items(), tm.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_gather_counters_stay_zero_on_cpu_tensors():
    _, tm = _models()
    pts, _, tctx = _batch(12)
    projective_gather.launches = projective_gather_bwd.launches = 0
    tm.loss(t(pts), torch.Generator().manual_seed(0), tctx).backward()
    assert projective_gather.launches == 0 and projective_gather_bwd.launches == 0
