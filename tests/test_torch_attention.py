"""The per-head attention path (``attn_impl="pallas"``) and the unpool + MLP
megakernel switch of the port against the JAX package, on the CPU.

On CPU tensors ``rect_attention(impl="pallas")`` runs its plain version
(``_rect_attention_ref``, backward by autograd through it); it is held
against the JAX ``rect_attention(impl="pallas")``, whose forward and
backward Pallas kernels run in interpret mode, on the pool's and the
unpool's shapes with ordinary and drifted logits. Then the whole per-head
set transformer, its loss and gradients and a sample, and the
flagship-structured sampler with ``GECCO_UNPOOL_MLP_MEGAKERNEL=1`` on both
sides. The Hopper kernels run only on the card, where ``chip_smoke.py``
holds each against its plain version.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gecco_tpu.ops.attention import rect_attention as jrect_attention
from gecco_tpu.ops.pallas import folded_attention as jfa
from gecco_tpu.ops.pallas.induced_attention import _forward_impl, rect_attention_pallas
from gecco_tpu_torch.convert import to_jax_params
from gecco_tpu_torch.models import set_transformer as tst
from gecco_tpu_torch.ops.attention import rect_attention
from gecco_tpu_torch.ops.kernels import induced_attention as tia
from torch_parity import f32, j, jax_draws, jax_model, jax_params, rel_err, t, torch_model

REPO = Path(__file__).resolve().parents[1]
B, HEADS, D, I, N = 2, 4, 16, 16, 256
# per-head logit scales of the drift case: head 0's logits ~60x head 1's,
# reaching the hundreds
DRIFT = np.array([60.0, 1.0, 0.1, 0.01], np.float32)
# (queries, keys): the pool (I inducers against N points) and the unpool
SHAPES = {"pool": (I, N), "unpool": (N, I)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jm():
    """The small JAX model of the parity tests on the per-head path
    (4-step schedule), built once: the module tests take its weights."""
    return jax_model("pallas", n_steps=4)


def _with_impl(jmodel, attn_impl):
    backbone = jmodel.network.backbone.replace(attn_impl=attn_impl)
    return jmodel.replace(network=jmodel.network.replace(backbone=backbone))


def _qkv(seed, direction, drift):
    """q [B, H, M, D] (the pool's inducers [H, I, D], broadcast over the
    batch as ``AttentionPool`` does), k/v [B, H, N, D]; with ``drift`` each
    head's keys are scaled by DRIFT."""
    rng = np.random.default_rng(seed)
    m, n = SHAPES[direction]
    q = rng.standard_normal((HEADS, m, D) if direction == "pool" else (B, HEADS, m, D))
    k = rng.standard_normal((B, HEADS, n, D))
    if drift:
        k = k * DRIFT[None, :, None, None]
    v = rng.standard_normal((B, HEADS, n, D))
    return tuple(a.astype(np.float32) for a in (q, k, v))


def _bcast_torch(q):
    return q[None].expand(B, -1, -1, -1) if q.ndim == 3 else q


def _bcast_jax(q):
    return jnp.broadcast_to(q[None], (B, *q.shape)) if q.ndim == 3 else q


def _atol(ref, drift, atol):
    """With drifted logits (in the hundreds) fp32 rounding of a logit moves
    a result by ~1e-5 of its largest value: the absolute tolerance then
    scales with max |ref| (2e-5 of it), as in the fused kernels' drift
    tests."""
    return max(atol, 2e-5 * float(np.abs(np.asarray(ref, np.float32)).max())) if drift else atol


@pytest.mark.parametrize("drift", [False, True], ids=["ordinary", "drift"])
@pytest.mark.parametrize("direction", ["pool", "unpool"])
def test_rect_attention_matches_jax(direction, drift):
    """o in fp32 at the JAX tests' tolerance (rtol 1e-4, atol 1e-5), lse
    against ``_forward_impl``'s (fp32, rtol 1e-5), and o in bf16 within a
    bf16 step (2^-8) of the largest value: both round p to bf16 before the
    value product, and sum in other orders."""
    q, k, v = _qkv(0, direction, drift)
    tq, tk, tv = _bcast_torch(torch.from_numpy(q)), torch.from_numpy(k), torch.from_numpy(v)
    jq, jk, jv = _bcast_jax(jnp.asarray(q)), jnp.asarray(k), jnp.asarray(v)
    port = rect_attention(tq, tk, tv, impl="pallas")
    ref = jrect_attention(jq, jk, jv, impl="pallas")
    np.testing.assert_allclose(f32(port), f32(ref), rtol=1e-4, atol=_atol(ref, drift, 1e-5))
    _, lse = tia.rect_attention_fwd(tq, tk, tv)
    _, jlse = _forward_impl(jq, jk, jv)
    np.testing.assert_allclose(f32(lse), f32(jlse), rtol=1e-5, atol=1e-5)
    bf = rect_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), impl="pallas")
    jbf = jrect_attention(*(a.astype(jnp.bfloat16) for a in (jq, jk, jv)), impl="pallas")
    assert bf.dtype == torch.bfloat16
    assert rel_err(bf, jbf) < 2 ** -8


@pytest.mark.parametrize("drift", [False, True], ids=["ordinary", "drift"])
@pytest.mark.parametrize("direction", ["pool", "unpool"])
def test_rect_attention_gradients_match_jax(direction, drift):
    """dq, dk, dv through the port's autograd Function (autograd of the
    plain version on the CPU) against ``jax.vjp`` through
    ``rect_attention_pallas`` (its backward kernel in interpret mode); the
    pool's dq reaches the [H, I, D] inducers through the batch broadcast.
    fp32, rtol 1e-4 and atol 1e-5 (scaled with max |ref| under drift)."""
    q, k, v = _qkv(1, direction, drift)
    m, _ = SHAPES[direction]
    g = np.random.default_rng(2).standard_normal((B, HEADS, m, D)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = rect_attention(_bcast_torch(leaves[0]), leaves[1], leaves[2], impl="pallas")
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a, b, c: jrect_attention(_bcast_jax(a), b, c, impl="pallas"),
                     *map(jnp.asarray, (q, k, v)))
    for name, a, r in zip(("dq", "dk", "dv"), leaves, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(f32(a.grad), f32(r), rtol=1e-4, atol=_atol(r, drift, 1e-5),
                                   err_msg=name)


def test_rect_attention_impls_agree_and_bwd_wrapper_is_autograd_of_the_plain_version():
    """On CPU tensors ``impl="pallas"`` is the plain function of
    ``impl="xla"``, and ``rect_attention_bwd`` (what the CUDA backward
    replaces) is autograd through the plain forward, exactly."""
    q, k, v = (_bcast_torch(torch.from_numpy(a)) for a in _qkv(3, "pool", False))
    torch.testing.assert_close(rect_attention(q, k, v, impl="pallas"), rect_attention(q, k, v),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        rect_attention(q, k, v, impl="folded")
    o, lse = tia.rect_attention_fwd(q, k, v)
    g = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    got = tia.rect_attention_bwd(q, k, v, o, lse, g)
    leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
    tia._rect_attention_ref(*leaves)[0].backward(g)
    for a, r in zip(got, leaves):
        torch.testing.assert_close(a, r.grad, rtol=0, atol=0)


# ------------------------------------------------------- per-head model --


def test_per_head_network_matches_jax(jm):
    """The denoiser network on ``SetTransformer(attn_impl="pallas")``,
    fp32, at the module tests' tolerance; the port's per-head backbone
    gives the plain path's output from the same weights."""
    tm = torch_model(jm, "pallas")
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((2, 128, 3)).astype(np.float32)
    tt = np.array([0.05, 60.0], np.float32)
    np.testing.assert_allclose(f32(tm.network(t(tt), t(pts))), f32(jm.network(j(tt), j(pts))),
                               rtol=1e-4, atol=1e-4)
    feats = t(rng.standard_normal((2, 128, 64)))
    embed = t(np.array([[0.01], [120.0]]))
    out = tm.network.backbone(feats, embed)
    tm.network.backbone.attn_impl = "xla"
    np.testing.assert_allclose(f32(tm.network.backbone(feats, embed)), f32(out),
                               rtol=1e-6, atol=1e-6)


def test_per_head_loss_and_gradients_match_jax(jm):
    """The loss at the JAX loss's own sigma and noise, and every gradient,
    through the per-head attention's backward on both sides; fp32, the
    train tests' tolerances (loss 1e-5, each gradient 1e-4 of its largest
    value)."""
    tm = torch_model(jm, "pallas")
    points = (0.35 * np.random.default_rng(5).standard_normal((2, 256, 3))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jloss, jgrads = jax.value_and_grad(lambda m: m.loss(jnp.asarray(points), None, key))(jm)
    sigma, noise = jax_draws(jm, points, key)
    loss = tm.loss_from(t(points), t(sigma), t(noise))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref, ours = jax_params(jgrads), to_jax_params(tm, grads=True)
    assert set(ours) == set(ref)
    for name, g in ref.items():
        if np.abs(g).max() > 0:
            assert np.abs(ours[name] - g).max() < 1e-4 * np.abs(g).max(), name
        else:  # the reparam's statistics take no gradient
            assert not np.abs(ours[name]).any(), name


def test_per_head_sample_matches_jax(jm):
    """A 4-step Heun sample from one latent, per-head path on both sides,
    fp32 (tolerance of the sampler tests: 1e-4 of the largest value)."""
    details = jm.sample(jax.random.PRNGKey(7), (2, 128, 3), return_details=True)
    tm = torch_model(jm, "pallas", n_steps=4)
    ours = tm.sample_from_latent(t(details.latent))
    assert rel_err(ours, details.sample_data) < 1e-4


# ----------------------------------------------------------- megakernel --


def test_megakernel_switch_samples_as_jax_and_only_without_grad(jm, monkeypatch):
    """``GECCO_UNPOOL_MLP_MEGAKERNEL=1`` on both sides (read when the JAX
    package traces and when the port's layer is called, so the JAX sampler
    is traced afresh): the fused flagship-structured model's 4-step sample
    from one latent agrees at fp32 (1e-4), both sides having taken the
    megakernel. A spy on the port's layer shows the megakernel route under
    ``torch.no_grad`` (sampling) and the separate unpool and MLP with grad
    on (the loss)."""
    monkeypatch.setenv("GECCO_UNPOOL_MLP_MEGAKERNEL", "1")
    calls = {"jax": 0, "mega": 0, "unpool": 0}

    def spy(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jfa, "fused_unpool_mlp", spy(jfa.fused_unpool_mlp, "jax"))
    monkeypatch.setattr(tst, "fused_unpool_mlp", spy(tst.fused_unpool_mlp, "mega"))
    monkeypatch.setattr(tst, "folded_unpool", spy(tst.folded_unpool, "unpool"))
    jax.clear_caches()
    fused = _with_impl(jm, "folded_pallas")
    details = fused.sample(jax.random.PRNGKey(8), (2, 128, 3), return_details=True)
    assert calls["jax"] > 0
    tm = torch_model(fused, "folded_pallas", n_steps=4)
    ours = tm.sample_from_latent(t(details.latent))
    assert rel_err(ours, details.sample_data) < 1e-4
    # 2 layers x 6 evaluations, all through the megakernel
    assert calls["mega"] == 12 and calls["unpool"] == 0
    calls.update(mega=0, unpool=0)
    pts = t(0.35 * np.random.default_rng(9).standard_normal((2, 128, 3)))
    tm.loss(pts, torch.Generator().manual_seed(0)).backward()
    assert calls["mega"] == 0 and calls["unpool"] == 2
    assert all(p.grad is not None for p in tm.parameters())


def test_rect_bwd_witness_matches_the_jax_kernel_in_bf16():
    """``chip_smoke.py``'s ``rect_bwd_tpu_algebra``, the witness that the
    per-head path's gradients are held against on the card, is the JAX
    kernel's own algebra: on bf16 operands of the unpool's shape with
    drifted logits, fed the JAX forward's o and lse, its dq, dk and dv
    agree with ``jax.vjp`` of ``rect_attention_pallas`` (``_bwd_kernel`` in
    interpret mode) within 1e-3 of max |ref|, while autograd of the plain
    version departs by more than that limit in dq and dk (delta from the
    bf16 o)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    q, k, v = (a.astype(np.float32) for a in _qkv(7, "unpool", True))
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))

    @jax.jit
    def jax_side(q, k, v, g):
        o, lse = _forward_impl(q, k, v)
        return o, lse, jax.vjp(rect_attention_pallas, q, k, v)[1](g)

    o, lse, ref = jax_side(jq, jk, jv, jg)
    bf = torch.bfloat16
    tq, tk, tv, tg = (torch.from_numpy(a).to(bf) for a in (q, k, v, g))
    witness = chip_smoke.rect_bwd_tpu_algebra(
        tq, tk, tv, torch.from_numpy(np.array(o, np.float32)).to(bf),
        torch.from_numpy(np.array(lse, np.float32)), tg)
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    tia._rect_attention_ref(*leaves)[0].backward(tg)
    for name, w, r, plain in zip(("dq", "dk", "dv"), witness, ref, leaves):
        r = np.asarray(r, np.float32)
        scale = float(np.abs(r).max())
        assert np.abs(w.float().numpy() - r).max() < 1e-3 * scale, name
        if name != "dv":
            assert np.abs(plain.grad.float().numpy() - r).max() > 1e-3 * scale, name


def test_rect_bwd_witness_departs_from_fp32_at_d256():
    """The departure for which ``chip_smoke.py`` holds the per-head model's
    gradient at D 256 to ``rect_bwd_tpu_algebra``'s witness rather than to
    the plain path is the JAX kernel's own: at D 256 (one head, the
    unpool's 256 queries against 64 keys, bf16, values sharing a common
    part as the unpool's values at init do, so dp - delta cancels), the
    JAX ``_bwd_kernel``'s dq and dk (``jax.vjp`` of
    ``rect_attention_pallas`` in interpret mode) depart from fp32 autograd
    of the plain version by more than 1.5x what bf16 autograd of the plain
    version does (delta from the bf16 o), and the witness gives the JAX
    kernel's dq, dk and dv within 4e-3 of max |ref| (one bf16 step, 2^-8,
    of the largest value: both sides round their outputs to bf16; the
    tolerance of ``test_pool_bwd_twopass_refs_match_the_jax_bodies``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.default_rng(12)
    b, n, i, d = 2, 256, 64, 256
    q = 3.0 * rng.standard_normal((b, 1, n, d))
    k = rng.standard_normal((b, 1, i, d))
    v = rng.standard_normal((1, 1, 1, d)) + 0.05 * rng.standard_normal((b, 1, i, d))
    g = rng.standard_normal((b, 1, n, d))
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))

    @jax.jit
    def jax_side(q, k, v, g):
        o, lse = _forward_impl(q, k, v)
        return o, lse, jax.vjp(rect_attention_pallas, q, k, v)[1](g)

    o, lse, ref = jax_side(jq, jk, jv, jg)
    bf = torch.bfloat16
    tq, tk, tv, tg = (torch.from_numpy(np.asarray(a, np.float32)).to(bf) for a in (jq, jk, jv, jg))
    witness = chip_smoke.rect_bwd_tpu_algebra(
        tq, tk, tv, torch.from_numpy(np.array(o, np.float32)).to(bf),
        torch.from_numpy(np.array(lse, np.float32)), tg)
    fp32 = [a.float().requires_grad_(True) for a in (tq, tk, tv)]
    tia._rect_attention_ref(*fp32)[0].backward(tg.float())
    bf16 = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    tia._rect_attention_ref(*bf16)[0].backward(tg)
    dev = lambda a, r: float(np.linalg.norm(a - r) / np.linalg.norm(r))
    for name, w, r, exact, plain in zip(("dq", "dk", "dv"), witness, ref, fp32, bf16):
        r = np.asarray(r, np.float32)
        assert np.abs(w.float().numpy() - r).max() < 4e-3 * np.abs(r).max(), name
        if name != "dv":
            want = exact.grad.numpy()
            assert dev(r, want) > 1.5 * dev(plain.grad.float().numpy(), want), name


# -------------------------------------- the Hopper bodies' plain pieces --

# (queries, keys) of the pieces' cases: the pool (a ragged I of 48
# inducers against a ragged N of 200 points) and the unpool (the reverse)
PIECE_SHAPES = {"pool": (48, 200), "unpool": (200, 48)}


def _piece_operands(seed, direction, d, drift):
    """q, k, v and the cotangent g, two heads of width d; with ``drift``
    head 0's keys scaled 60x (logits in the hundreds)."""
    rng = np.random.default_rng(seed)
    m, n = PIECE_SHAPES[direction]
    q, g = (rng.standard_normal((B, 2, m, d)) for _ in range(2))
    k, v = (rng.standard_normal((B, 2, n, d)) for _ in range(2))
    if drift:
        k = k * DRIFT[:2, None, None]
    return tuple(a.astype(np.float32) for a in (q, k, v, g))


@jax.jit
def _jax_fwd_bwd(q, k, v, g):
    """The JAX kernels in interpret mode: the forward's o and lse, and the
    vjp of g through ``rect_attention_pallas``."""
    o, lse = _forward_impl(q, k, v)
    return o, lse, jax.vjp(rect_attention_pallas, q, k, v)[1](g)


@pytest.mark.parametrize("drift", [False, True], ids=["ordinary", "drift"])
@pytest.mark.parametrize("d", [48, 32])
@pytest.mark.parametrize("direction", ["pool", "unpool"])
def test_rect_forward_pieces_compose(monkeypatch, direction, d, drift):
    """The Hopper forward's algebra in plain pieces (``_rect_fwd_pieces``:
    the pool direction's ranges of key tiles, each range's running (max,
    sum), their merge in rank order, the normalised p's parts of p @ v
    summed in rank order; the unpool direction's one pass) at a ragged N
    of 200 and a ragged I of 48, the ranges two tiles long (the pool's four
    key tiles in two ranges): in fp32 it is the plain version (rtol 1e-4,
    atol 1e-5 scaled with max |ref| under drift, the JAX tests'
    tolerances); in bf16 it gives ``_forward_impl``'s o (interpret mode)
    within one bf16 step of the largest value (2^-7 of max |ref|: both
    round p, then o, to bf16) and its lse (rtol 1e-5)."""
    monkeypatch.setattr(tia, "_RANGE_TILES", 2)
    q, k, v, g = _piece_operands(20 + d, direction, d, drift)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = tia._rect_fwd_pieces(tq, tk, tv)
    ro, rl = tia._rect_attention_ref(tq, tk, tv)
    np.testing.assert_allclose(f32(o), f32(ro), rtol=1e-4, atol=_atol(ro, drift, 1e-5))
    np.testing.assert_allclose(f32(lse), f32(rl), rtol=1e-5, atol=1e-5)
    jo, jl, _ = _jax_fwd_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)))
    bf = torch.bfloat16
    o16, l16 = tia._rect_fwd_pieces(tq.to(bf), tk.to(bf), tv.to(bf))
    assert o16.dtype == bf
    assert rel_err(o16, jo) <= 2 ** -7
    np.testing.assert_allclose(f32(l16), f32(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("drift", [False, True], ids=["ordinary", "drift"])
@pytest.mark.parametrize("d", [48, 32])
@pytest.mark.parametrize("direction", ["pool", "unpool"])
def test_rect_backward_pieces_compose(monkeypatch, direction, d, drift):
    """The Hopper backward's algebra in plain pieces (``_rect_bwd_pieces``:
    key-major tiles, p and ds rounded to the operands' dtype before the
    three products, the gradient a block accumulates over its range summed
    over the ranges in rank order, delta formed as the kernel forms it
    from the bf16 g and o, ``_rect_delta_ref``), the ranges two tiles long,
    at a ragged N of 200 and a ragged I of 48: in fp32 it is autograd of
    the plain version (rtol 1e-4, atol 1e-5 scaled with max |ref| under
    drift); in bf16, fed ``_forward_impl``'s own o and lse, it gives
    ``jax.vjp`` of ``rect_attention_pallas`` (``_bwd_kernel`` in
    interpret mode) within one bf16 step of the largest value (2^-7 of max
    |ref|), dq, dk and dv; and its delta is the JAX package's."""
    monkeypatch.setattr(tia, "_RANGE_TILES", 2)
    q, k, v, g = _piece_operands(30 + d, direction, d, drift)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = tia._rect_attention_ref(tq, tk, tv)
    got = tia._rect_bwd_pieces(tq, tk, tv, o, lse, tg)
    want = tia._rect_attention_bwd_ref(tq, tk, tv, tg)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(f32(a), f32(r), rtol=1e-4, atol=_atol(r, drift, 1e-5),
                                   err_msg=name)
    jo, jl, ref = _jax_fwd_bwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)))
    bf = torch.bfloat16
    o16 = torch.from_numpy(np.array(jo, np.float32)).to(bf)
    l16 = torch.from_numpy(np.array(jl, np.float32))
    g16 = tg.to(bf)
    got = tia._rect_bwd_pieces(tq.to(bf), tk.to(bf), tv.to(bf), o16, l16, g16)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == bf, name
        assert rel_err(a, r) <= 2 ** -7, name
    jdelta = jnp.sum(jnp.asarray(g16.float().numpy()) * jnp.asarray(o16.float().numpy()), -1)
    np.testing.assert_allclose(f32(tia._rect_delta_ref(g16, o16)), np.asarray(jdelta),
                               rtol=1e-6, atol=1e-6)
